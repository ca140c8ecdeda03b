"""Package installer (reference: setup.py installs pointcloud_vision +
robosuite_envs; here one package provides both layers)."""

from setuptools import find_packages, setup

setup(
    name="pointcloud_tpu",
    version="0.1.0",
    description=(
        "TPU-native point-cloud vision framework for robotic RL "
        "(JAX/XLA/Pallas)"
    ),
    packages=find_packages(include=[
        "pointcloud_tpu", "pointcloud_tpu.*",
        "pointcloud_tpu_torch", "pointcloud_tpu_torch.*",
    ]),
    package_data={
        "pointcloud_tpu.rl": ["tqc.yml"],
        "pointcloud_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
        "pointcloud_tpu_torch.rl": ["tqc.yml"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "gymnasium",
    ],
    extras_require={
        "sim": ["robosuite", "gymnasium-robotics", "mujoco"],
        "viz": ["matplotlib", "plotly", "open3d"],
        "rl-zoo": ["sb3_contrib", "rl_zoo3"],
    },
)
