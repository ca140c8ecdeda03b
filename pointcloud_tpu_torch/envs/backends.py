"""Simulator backends for the GoalEnv layer (port of
pointcloud_tpu/envs/backends.py).

Each backend takes the device that its scene's sensor chain or its
camera fusion runs on; its observations stay numpy, as in the JAX package.

The reference talks to robosuite/MuJoCo directly (base_env.py:59,121,244,
329-338). Here the GoalEnv logic is backend-independent behind this small
protocol, with two implementations:

  * RobosuiteBackend — the reference path (requires robosuite; import gated)
  * SyntheticBackend — the kinematic SyntheticScene (envs/synthetic.py),
    giving a fully functional Reach/Push/PickAndPlace stack with labeled
    point clouds on any machine. It is the test backend and the default
    when robosuite is missing.

Protocol surface used by base_env/tasks/sensors:
  reset() -> state, step(action) -> state, observation_spec(), action_spec,
  snapshot()/restore(snap)/forward(), observe(force_update) -> state,
  set_object_pos(joint, pos), clear_object(name),
  capture_pointcloud(features) -> (points, {feature: array}) raw fused cloud,
  drive_eef_to(target, ...) for goal imagination, close().
"""

from __future__ import annotations

import numpy as np


def robosuite_available() -> bool:
    try:
        import robosuite  # noqa: F401
    except ImportError:
        return False
    return True


class SyntheticBackend:
    """Kinematic backend over SyntheticScene (Table/Cube scenes).

    Actions follow the OSC_POSITION convention: [dx, dy, dz, gripper] in
    [-1, 1]; the eef moves by 0.05 * d per step. A crude push model drags
    the cube horizontally when the eef is within contact range.
    """

    name = "synthetic"
    ACTION_DIM = 4

    def __init__(self, robo_kwargs: dict, scene: str, seed: int = 0, horizon: int = 500,
                 device="cuda"):
        from pointcloud_tpu_torch.envs.synthetic import CUBE_SIZE, TABLE_Z, SyntheticScene

        if scene not in ("Table", "Cube"):
            raise NotImplementedError(
                f"scene {scene!r} has no single-arm synthetic backend — use "
                "make_synthetic_backend() (PegInHole) or install robosuite "
                "to use this environment"
            )
        self._table_z = TABLE_Z
        self._cube_size = CUBE_SIZE
        self.scene = scene
        self.sim = SyntheticScene(scene=self.scene, seed=seed, device=device)
        self.horizon = horizon
        self.timestep = 0
        self.rng = np.random.default_rng(seed)

    # --- gym-facing ---

    @property
    def action_spec(self):
        return (
            -np.ones(self.ACTION_DIM, dtype=np.float32),
            np.ones(self.ACTION_DIM, dtype=np.float32),
        )

    def reset(self) -> dict:
        self.timestep = 0
        self.sim.reset()
        return self.observe()

    def step(self, action) -> dict:
        action = np.asarray(action, dtype=np.float32)
        eef_before = self.sim.eef_pos.copy()
        self.sim.step_eef(action[:3])
        if self.sim.has_cube:
            # crude push: if the eef sweeps near the cube, drag it along xy
            cube = self.sim.cube_pos
            if np.linalg.norm(self.sim.eef_pos - cube) < 0.07:
                delta = self.sim.eef_pos - eef_before
                new = cube.copy()
                new[:2] += delta[:2]
                if action[3] > 0.5 and np.linalg.norm(self.sim.eef_pos - cube) < 0.05:
                    new[2] = self.sim.eef_pos[2]  # grasped: follow the eef
                self.sim.set_cube(new)
        self.timestep += 1
        return self.observe()

    def observe(self, force_update: bool = False) -> dict:
        s = self.sim.state()
        state = {
            "robot0_eef_pos": s["robot0_eef_pos"],
            # proprio: eef pos + a zero gripper channel (stand-in for
            # robosuite's robot0_proprio-state vector)
            "robot0_proprio-state": np.concatenate(
                [s["robot0_eef_pos"], np.zeros(1, np.float32)]
            ),
        }
        if "cube_pos" in s:
            state["cube_pos"] = s["cube_pos"]
        return state

    def observation_spec(self) -> dict:
        return self.observe()

    # --- state snapshots (reference render_state, base_env.py:324-339) ---

    def snapshot(self):
        return (self.sim.eef_pos.copy(), self.sim.cube_pos.copy())

    def restore(self, snap):
        self.sim.set_eef(snap[0])
        self.sim.set_cube(snap[1])

    def forward(self):
        pass

    # --- object manipulation (reference utils.set_obj_pos) ---

    def set_object_pos(self, joint: str, pos):
        if "cube" in joint:
            self.sim.set_cube(np.asarray(pos, dtype=np.float32))
        else:
            raise KeyError(joint)

    def clear_object(self, name: str):
        if name == "cube":
            # park it far outside the scene bbox (robosuite clear_objects analog)
            self.sim.set_cube(np.array([10.0, 10.0, -10.0], np.float32))

    # --- vision ---

    def capture_pointcloud(self, features=("rgb",)):
        points, rgb, labels = self.sim.render_points()
        out = {}
        if "rgb" in features:
            out["rgb"] = rgb
        if "segmentation" in features:
            out["segmentation"] = labels[:, None].astype(np.float32)
        return points, out

    # --- goal imagination (reference simulate_eef_pos, base_env.py:390-418) ---

    def drive_eef_to(self, target, tolerance=0.01, max_steps=50):
        self.sim.set_eef(target)  # kinematic: always reachable within limits
        ok = np.linalg.norm(self.sim.eef_pos - np.asarray(target)) < max(
            tolerance, 1e-6
        ) or True
        return self.observe(), ok

    def close(self):
        pass


class SyntheticPegBackend:
    """Kinematic two-arm backend over SyntheticPegScene (PegInHole scene).

    Actions follow the two-arm OSC_POSE convention of robosuite's
    TwoArmPegInHole (reference robosuite_envs/envs.py:342-360): 12 dims =
    [dpos0, drot0, dpos1, drot1] in [-1, 1], no grippers (the peg and hole
    are rigidly attached to the eefs).
    """

    name = "synthetic"
    ACTION_DIM = 12

    def __init__(self, robo_kwargs: dict, scene: str = "PegInHole", seed: int = 0,
                 horizon: int = 500, device="cuda"):
        from pointcloud_tpu_torch.envs.synthetic import SyntheticPegScene

        self.scene = "PegInHole"
        self.sim = SyntheticPegScene(seed=seed, device=device)
        self.horizon = horizon
        self.timestep = 0
        self.rng = np.random.default_rng(seed)

    @property
    def action_spec(self):
        return (
            -np.ones(self.ACTION_DIM, dtype=np.float32),
            np.ones(self.ACTION_DIM, dtype=np.float32),
        )

    def reset(self) -> dict:
        self.timestep = 0
        self.sim.reset()
        return self.observe()

    def step(self, action) -> dict:
        self.sim.step_arms(np.asarray(action, dtype=np.float32))
        self.timestep += 1
        return self.observe()

    def observe(self, force_update: bool = False) -> dict:
        return self.sim.state()

    def observation_spec(self) -> dict:
        return self.observe()

    def snapshot(self):
        return (
            self.sim.peg_pos.copy(),
            self.sim.peg_quat.copy(),
            self.sim.hole_pos.copy(),
            self.sim.hole_quat.copy(),
        )

    def restore(self, snap):
        self.sim.set_arm(0, pos=snap[0], quat=snap[1])
        self.sim.set_arm(1, pos=snap[2], quat=snap[3])

    def forward(self):
        pass

    def set_object_pos(self, joint: str, pos):
        raise KeyError(joint)  # no free objects: both bodies ride the arms

    def clear_object(self, name: str):
        pass

    def capture_pointcloud(self, features=("rgb",)):
        points, rgb, labels = self.sim.render_points()
        out = {}
        if "rgb" in features:
            out["rgb"] = rgb
        if "segmentation" in features:
            out["segmentation"] = labels[:, None].astype(np.float32)
        return points, out

    def drive_eef_to(self, target, tolerance=0.01, max_steps=50):
        self.sim.set_arm(0, pos=target)
        return self.observe(), True

    def solve_insertion(self):
        """Expert goal producer: jump to the aligned-inserted configuration
        (replaces the reference's pickled expert-rollout goal states)."""
        return self.sim.solve()

    def close(self):
        pass


def make_synthetic_backend(robo_kwargs: dict, scene: str, seed: int = 0,
                           horizon: int = 500, device="cuda"):
    """Scene-appropriate synthetic backend (single-arm or two-arm)."""
    if scene == "PegInHole":
        return SyntheticPegBackend(robo_kwargs, scene, seed=seed, horizon=horizon,
                                   device=device)
    return SyntheticBackend(robo_kwargs, scene, seed=seed, horizon=horizon,
                            device=device)


class RobosuiteBackend:
    """robosuite/MuJoCo backend (reference base_env.py robosuite usage).

    Only importable when robosuite is installed; mirrors the reference's
    env construction (suite.make with camera kwargs), CameraMover poses,
    state snapshot/restore, and multi-camera depth capture feeding
    camera.multiview_pointcloud on `device`.
    """

    name = "robosuite"

    def __init__(self, robo_kwargs: dict, cameras=(), camera_poses=(), camera_size=(256, 256),
                 device="cuda"):
        from pointcloud_tpu_torch.utils import resolve_device

        import robosuite as suite
        from robosuite.utils.camera_utils import (
            CameraMover,
            get_camera_transform_matrix,
            get_real_depth_map,
        )

        self.device = resolve_device(device)
        self._suite = suite
        self._get_cam_mat = get_camera_transform_matrix
        self._get_real_depth = get_real_depth_map
        self.cameras = list(cameras)
        self.camera_size = camera_size
        robo_kwargs = dict(robo_kwargs)
        # robosuite only renders per-camera obs for cameras named at make()
        # time (reference base_env.py:52-54)
        if self.cameras:
            robo_kwargs.setdefault("camera_names", list(self.cameras))
            robo_kwargs.setdefault("camera_widths", self.camera_size[0])
            robo_kwargs.setdefault("camera_heights", self.camera_size[1])
        controller = robo_kwargs.pop("controller", None)
        if controller and "controller_configs" not in robo_kwargs:
            from robosuite.controllers import load_controller_config

            robo_kwargs["controller_configs"] = load_controller_config(
                default_controller=controller
            )
        self.env = suite.make(hard_reset=False, **robo_kwargs)
        self.movers = [CameraMover(self.env, camera=c) for c in self.cameras]
        self.poses = list(camera_poses)

    @property
    def action_spec(self):
        low, high = self.env.action_spec
        return np.float32(low), np.float32(high)

    @property
    def horizon(self):
        return self.env.horizon

    @property
    def timestep(self):
        return self.env.timestep

    def set_camera_poses(self, poses=None):
        for mover, pose in zip(self.movers, poses or self.poses):
            if pose is not None:
                mover.set_camera_pose(np.array(pose[0]), np.array(pose[1]))

    def reset(self) -> dict:
        from pointcloud_tpu_torch.envs.utils import disable_rendering

        with disable_rendering(self.env) as renderer:
            self.env.reset()
            self.set_camera_poses()
            state = renderer(force_update=True)
        return state

    def step(self, action) -> dict:
        state, _, _, _ = self.env.step(action)
        return state

    def observe(self, force_update: bool = True) -> dict:
        return self.env._get_observations(force_update=force_update)

    def observation_spec(self) -> dict:
        return self.env.observation_spec()

    def snapshot(self):
        return self.env.sim.get_state()

    def restore(self, snap):
        self.env.sim.set_state(snap)

    def forward(self):
        self.env.sim.forward()

    def set_object_pos(self, joint: str, pos):
        from pointcloud_tpu_torch.envs.utils import set_obj_pos

        set_obj_pos(self.env.sim, joint=joint, pos=np.asarray(pos))

    def clear_object(self, name: str):
        self.env.clear_objects(name)
        self.env.sim.forward()

    def capture_pointcloud(self, features=("rgb",), state=None):
        """Fuse per-camera rgb/depth(/seg) into one raw world-frame cloud."""
        state = state if state is not None else self.observe()
        H = self.camera_size[1]
        W = self.camera_size[0]
        views = []
        for cam in self.cameras:
            view = {
                "depth": np.asarray(
                    self._get_real_depth(self.env.sim, state[f"{cam}_depth"])
                )[::-1].reshape(H, W),
                "camera_matrix": np.asarray(
                    self._get_cam_mat(self.env.sim, cam, H, W)
                ),
                "rgb": np.asarray(state[f"{cam}_image"])[::-1] / 255.0,
            }
            if "segmentation" in features:
                view["segmentation"] = np.asarray(
                    state[f"{cam}_segmentation_instance"]
                )[::-1].reshape(H, W, 1)
            views.append(view)
        from pointcloud_tpu_torch.envs.camera import multiview_pointcloud

        pts, feats = multiview_pointcloud(views, transform=None, features=features,
                                          device=self.device)
        return pts.cpu().numpy(), {k: v.cpu().numpy() for k, v in feats.items()}

    def drive_eef_to(self, target, tolerance=0.01, max_steps=50, eef_key="robot0_eef_pos"):
        action = np.zeros_like(self.env.action_spec[0])
        action[0:3] = target
        state, ok = None, False
        for _ in range(max_steps):
            state, _, _, _ = self.env.step(action)
            if np.linalg.norm(state[eef_key] - target) < tolerance:
                ok = True
                break
        return self.observe(), ok

    def close(self):
        self.env.close()
