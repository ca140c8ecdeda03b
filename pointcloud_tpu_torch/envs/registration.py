"""Gym env registration (port of pointcloud_tpu/envs/registration.py;
reference: robosuite_envs/__init__.py:6-28 + pointcloud_vision/__init__.py:7-151).

The JAX package's 4 ground-truth envs (Passthrough pair) and 12 vision
envs (PointCloudSensor with the encoder zoo) under the namespace
`pointcloud_tpu_torch/`, e.g. `pointcloud_tpu_torch/VisionPush-v0`, so both
packages' envs live in one process under their own ids. Each env runs on
the `device` given to gym.make (default 'cuda'). Idempotent; needs
gymnasium.
"""

from __future__ import annotations

NAMESPACE = "pointcloud_tpu_torch"

_registered = False


def register_all():
    global _registered
    if _registered:
        return
    from gymnasium.envs.registration import register, registry

    from pointcloud_tpu_torch.envs.envs import (
        RoboPegInHole,
        RoboPickAndPlace,
        RoboPush,
        RoboReach,
    )

    def reg(name, entry_point, **kwargs):
        env_id = f"{NAMESPACE}/{name}"
        if env_id in registry:
            return
        register(id=env_id, entry_point=entry_point, max_episode_steps=50, **kwargs)

    # ground-truth envs (robosuite_envs/__init__.py:6-28)
    reg("RoboReach-v0", RoboReach)
    reg("RoboPush-v0", RoboPush)
    reg("RoboPickAndPlace-v0", RoboPickAndPlace)
    reg("RoboPegInHole-v0", RoboPegInHole)

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
        reg(
            name,
            task,
            kwargs={"sensor": PointCloudSensor, "encoder": encoder, **extra},
        )

    _registered = True
