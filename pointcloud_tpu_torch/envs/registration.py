"""Gym env registration (port of pointcloud_tpu/envs/registration.py;
reference: robosuite_envs/__init__.py:6-28 + pointcloud_vision/__init__.py:7-151).

The JAX package's 4 ground-truth envs (Passthrough pair) and 12 vision
envs (PointCloudSensor with the encoder zoo) under the namespace
`pointcloud_tpu_torch/`, e.g. `pointcloud_tpu_torch/VisionPush-v0`, so both
packages' envs live in one process under their own ids. Each env runs on
the `device` given to gym.make (default 'cuda'). register_all is idempotent
and needs gymnasium; env_table, the id -> (task, kwargs) table it registers,
does not.
"""

from __future__ import annotations

NAMESPACE = "pointcloud_tpu_torch"

_registered = False


def env_table() -> dict:
    """{name: (task class, constructor kwargs)} of the sixteen envs; the
    vision envs' kwargs name their sensor and encoder classes. register_all
    registers these, and rl.vec_env.make_env builds its envs from them."""
    from pointcloud_tpu_torch.envs.envs import (
        RoboPegInHole,
        RoboPickAndPlace,
        RoboPush,
        RoboReach,
    )

    # ground-truth envs (robosuite_envs/__init__.py:6-28)
    table = {
        "RoboReach-v0": (RoboReach, {}),
        "RoboPush-v0": (RoboPush, {}),
        "RoboPickAndPlace-v0": (RoboPickAndPlace, {}),
        "RoboPegInHole-v0": (RoboPegInHole, {}),
    }

    # vision envs (pointcloud_vision/__init__.py:7-151); env construction,
    # not registration, reads the trained checkpoints.
    from pointcloud_tpu_torch.vision.pc_encoder import (
        GlobalAEEncoder,
        GlobalSegmenterEncoder,
        MultiSegmenterEncoder,
        StatePredictor,
    )
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

    vision = {
        "VisionReach-v0": (RoboReach, GlobalAEEncoder, {}),
        "VisionReachMultiSeg-v0": (
            RoboReach,
            MultiSegmenterEncoder,
            {"simulate_goal": True},
        ),
        "VisionPush-v0": (RoboPush, MultiSegmenterEncoder, {}),
        "VisionPushSeg-v0": (RoboPush, GlobalSegmenterEncoder, {}),
        "VisionPushMultiSeg-v0": (RoboPush, MultiSegmenterEncoder, {}),
        "VisionPushGT-v0": (RoboPush, StatePredictor, {}),
        "VisionPickAndPlace-v0": (RoboPickAndPlace, StatePredictor, {}),
        "VisionPickAndPlaceSeg-v0": (
            RoboPickAndPlace,
            GlobalSegmenterEncoder,
            {"simulate_goal": False},
        ),
        "VisionPickAndPlaceMultiSeg-v0": (RoboPickAndPlace, MultiSegmenterEncoder, {}),
        "VisionPickAndPlaceGT-v0": (RoboPickAndPlace, StatePredictor, {}),
        "VisionPegInHole-v0": (RoboPegInHole, StatePredictor, {}),
        "VisionPegInHoleMultiSeg-v0": (RoboPegInHole, MultiSegmenterEncoder, {}),
    }
    for name, (task, encoder, extra) in vision.items():
        table[name] = (task, {"sensor": PointCloudSensor, "encoder": encoder, **extra})
    return table


def register_all():
    global _registered
    if _registered:
        return
    from gymnasium.envs.registration import register, registry

    for name, (task, kwargs) in env_table().items():
        env_id = f"{NAMESPACE}/{name}"
        if env_id in registry:
            continue
        extra = {"kwargs": kwargs} if kwargs else {}
        register(id=env_id, entry_point=task, max_episode_steps=50, **extra)

    _registered = True
