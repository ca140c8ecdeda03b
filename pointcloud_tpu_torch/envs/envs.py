"""Task environments (port of pointcloud_tpu/envs/envs.py; reference:
robosuite_envs/envs.py:113-429).

RoboReach / RoboPush / RoboPickAndPlace / RoboPegInHole: each pins a scene,
the proprio/obs/goal keys, and implements the desired_goal_state /
set_initial_state / randomize hooks. Sensors/encoders are injected by the
registration layer (registration.py), defaulting to the Passthrough pair.
`device` (default 'cuda') is set on the env before its sensor and encoder
are built, since they read it.

Goal randomization draws from the gymnasium per-env `self.np_random`
generator, so `reset(seed=)` fully controls goal sequences — unlike the
reference, which uses the global numpy RNG (envs.py:126-335) and is
therefore unseedable across test/process boundaries.
"""

from __future__ import annotations

import numpy as np

from pointcloud_tpu_torch.envs.base_env import (
    RobosuiteGoalEnv,
    assert_correctness,
    render_goal,
)
from pointcloud_tpu_torch.envs.encoders import PassthroughEncoder
from pointcloud_tpu_torch.envs.scenes import cfg_scene, robo_kwargs
from pointcloud_tpu_torch.envs.sensors import PassthroughSensor
from pointcloud_tpu_torch.envs.utils import apply_preset
from pointcloud_tpu_torch.utils import resolve_device

# reset camera poses after each reset (reference envs.py:13)
keep_cam_pose = False


class _TaskEnv(RobosuiteGoalEnv):
    """Shared constructor plumbing of all tasks (reference envs.py:124-150)."""

    def __init__(
        self,
        render_mode=None,
        sensor=PassthroughSensor,
        encoder=PassthroughEncoder,
        require_segmentation=False,
        device="cuda",
        **kwargs,
    ):
        self.device = resolve_device(device)
        if sensor.requires_vision:
            apply_preset(self, cfg_scene[self.scene])
        else:
            self.cameras = {"frontview": None} if render_mode == "human" else {}
            self.camera_size = (512, 512)

        super().__init__(
            robo_kwargs=robo_kwargs[self.scene],
            sensor=sensor(env=self, require_segmentation=require_segmentation)
            if sensor.requires_vision
            else sensor(env=self),
            encoder=encoder(self, self.obs_keys, self.goal_keys),
            render_mode=render_mode,
            render_info=render_goal,
            device=self.device,
            **kwargs,
        )
        if keep_cam_pose:
            self.reset_camera_poses = False


class RoboReach(_TaskEnv):
    """Reach a random eef target; the cube is removed (envs.py:117-177)."""

    task = "Reach"
    scene = "Table"

    proprio_keys = []  # purposefully empty
    obs_keys = ["robot0_eef_pos"]
    goal_keys = ["robot0_eef_pos"]

    @staticmethod
    def set_initial_state(backend, get_state):
        backend.clear_object("cube")
        backend.forward()

    @assert_correctness
    def desired_goal_state(self, state, rerender=False):
        desired_state = state.copy()  # shallow copy; new array below
        target = np.array(
            [
                self.np_random.uniform(-0.2, 0.2),
                self.np_random.uniform(-0.2, 0.2),
                self.np_random.uniform(0.85, 1.2),
            ],
            dtype=np.float32,
        )
        desired_state["robot0_eef_pos"] = target

        if rerender:
            if self.simulate_goal:
                desired_state, succ = self.simulate_eef_pos(target)
                if not succ:
                    print(
                        "Warning: failed to reach the desired robot pos for the "
                        "goal state imagination"
                    )
            else:
                raise NotImplementedError
        return desired_state

    def randomize(self):
        pass  # nothing to randomize (no objects in play)


class _CubeTaskEnv(_TaskEnv):
    """Shared cube-displacement goal logic of Push / PickAndPlace."""

    scene = "Cube"
    proprio_keys = ["robot0_proprio-state"]
    obs_keys = ["cube_pos"]
    goal_keys = ["cube_pos"]

    min_dist, max_dist = 0.13, 0.3  # move >=13cm so goals aren't pre-achieved
    airborne_prob = 0.0

    @assert_correctness
    def desired_goal_state(self, state, rerender=False):
        cube_pos = np.array(state["cube_pos"], dtype=np.float32, copy=True)
        dist = self.np_random.uniform(self.min_dist, self.max_dist)
        direction = self.np_random.uniform(0, 2 * np.pi)
        cube_pos[0] += dist * np.cos(direction)
        cube_pos[1] += dist * np.sin(direction)
        if self.airborne_prob and self.np_random.uniform() < self.airborne_prob:
            cube_pos[2] += self.np_random.uniform(0.01, 0.2)

        if rerender:
            if self.simulate_goal:
                raise NotImplementedError
            # rendered goal: teleport the cube in a snapshot (envs.py:243)
            desired_state = self.render_state(
                lambda backend: backend.set_object_pos("cube_joint0", cube_pos)
            )
        else:
            desired_state = state.copy()
            desired_state["cube_pos"] = cube_pos
        return desired_state


class RoboPush(_CubeTaskEnv):
    """Push the cube to a planar target (envs.py:190-259)."""

    task = "Push"
    min_dist, max_dist = 0.13, 0.3
    airborne_prob = 0.0

    def __init__(self, **kwargs):
        # robot pose is irrelevant to the goal -> never simulate (envs.py:222)
        kwargs.setdefault("simulate_goal", False)
        super().__init__(**kwargs)

    def randomize(self):
        self.backend.set_object_pos(
            "cube_joint0",
            np.array(
                [
                    self.np_random.uniform(-0.4, 0.4),
                    self.np_random.uniform(-0.4, 0.4),
                    self.np_random.uniform(0.8, 0.9),
                ]
            ),
        )


class RoboPickAndPlace(_CubeTaskEnv):
    """Move the cube to a (50% airborne) target (envs.py:264-336)."""

    task = "PickAndPlace"
    min_dist, max_dist = 0.13, 0.2
    airborne_prob = 0.5

    def randomize(self):
        self.backend.set_object_pos(
            "cube_joint0",
            np.array(
                [
                    self.np_random.uniform(-0.4, 0.4),
                    self.np_random.uniform(-0.4, 0.4),
                    self.np_random.uniform(0.8, 1.3),
                ]
            ),
        )


class RoboPegInHole(_TaskEnv):
    """Two-arm peg-in-hole; goal is a saved visual state (envs.py:342-427).

    Per-dim success thresholds on (t, d, angle). Runs on robosuite's
    TwoArmPegInHole when installed, or the kinematic two-arm
    SyntheticPegBackend otherwise (backends.py).
    """

    task = "PegInHole"
    scene = "PegInHole"

    proprio_keys = []  # hard version: peg and hole are effectively the eefs
    obs_keys = ["peg_to_hole", "peg_quat", "hole_pos", "hole_quat"]
    goal_keys = ["t", "d", "angle"]

    success_thresholds = np.array([0.14, 0.06, 0.05], dtype=np.float32)

    def __init__(self, goal_state_dir: str = "input/PegInHole/goals", **kwargs):
        self.goal_state_dir = goal_state_dir
        kwargs.setdefault("simulate_goal", False)
        super().__init__(**kwargs)

    def check_success(self, achieved, desired, info, force_gt=False):
        achieved = np.asarray(achieved)
        desired = np.asarray(desired)
        axis = 1 if achieved.ndim == 2 else None
        if not force_gt and self.encoder.latent_encoding:
            return super().check_success(achieved, desired, info, force_gt)
        # per-dim thresholds on (t, d, angle) (envs.py:~400-427)
        diff = np.abs(achieved - desired)
        if achieved.ndim == 2:
            return (diff <= self.success_thresholds).all(axis=axis)
        return bool((diff <= self.success_thresholds).all())

    @assert_correctness
    def desired_goal_state(self, state, rerender=False):
        """Load a pickled goal state saved from an expert rollout
        (reference loads visual goal states from the input dir); without
        pickles, produce the goal from an expert kinematic solve on a
        state snapshot (SyntheticPegBackend.solve_insertion)."""
        import glob
        import pickle

        files = sorted(glob.glob(f"{self.goal_state_dir}/*.pkl"))
        if files:
            with open(self.np_random.choice(files), "rb") as f:
                return pickle.load(f)
        if hasattr(self.backend, "solve_insertion"):
            if rerender:
                # full re-observation of the solved configuration (vision
                # encoders need the rendered state, not just the GT keys)
                return self.render_state(lambda b: b.solve_insertion())
            snap = self.backend.snapshot()
            desired_state = dict(state) | self.backend.solve_insertion()
            self.backend.restore(snap)
            return desired_state
        # fallback: desired (t, d, angle) = aligned-and-inserted
        desired_state = state.copy()
        desired_state["t"] = np.zeros_like(np.asarray(state.get("t", 0.0)))
        desired_state["d"] = np.zeros_like(np.asarray(state.get("d", 0.0)))
        desired_state["angle"] = np.zeros_like(np.asarray(state.get("angle", 0.0)))
        return desired_state

    def randomize(self):
        pass
