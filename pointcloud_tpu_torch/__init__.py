"""PyTorch/CUDA port of pointcloud_tpu, for NVIDIA Hopper (H100).

The JAX package `pointcloud_tpu` stays the reference; this package imports
nothing of it, nor JAX. Kernels the JAX package wrote in Pallas are
hand-written CUDA here (csrc/), built on first use (ops/_build.py); each has
a plain PyTorch version that CPU tensors take.

Where gymnasium is installed, importing the package registers its gym
environments under the namespace `pointcloud_tpu_torch/` (e.g.
`pointcloud_tpu_torch/VisionPush-v0`; envs/registration.py). Without
gymnasium the env classes (envs/envs.py) run on the stand-ins of
envs/spaces.py.
"""

from importlib.util import find_spec as _find_spec

from pointcloud_tpu_torch import cfg  # noqa: F401  (sets the fp32 matmul precision)


def register_envs():
    """Register the ground-truth and vision gym environments (idempotent)."""
    from pointcloud_tpu_torch.envs import registration

    registration.register_all()


if _find_spec("gymnasium") is not None:
    register_envs()
