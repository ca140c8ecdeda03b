"""GoalEnv wrapper (port of pointcloud_tpu/envs/base_env.py; reference:
robosuite_envs/base_env.py:21-464).

Gymnasium-Robotics GoalEnv conforming environment: the observation is a dict
{'observation': proprio ++ encoding, 'achieved_goal', 'desired_goal'}, the
reward is sparse success-1, and tasks plug in via the desired_goal_state /
check_success / set_initial_state / randomize hooks. The sensor/encoder pair
is pluggable (Sensor -> ObservationEncoder pipeline).

Backend-independent: the simulator sits behind envs/backends.py, so the
entire stack runs on robosuite (reference parity) or on the synthetic
kinematic backend (tests, robosuite-free machines). The env's `device`
(default 'cuda'; a card is required for it) is where its backend, sensor
and encoder run; observations, rewards and goals stay numpy.
"""

from __future__ import annotations

from copy import deepcopy
from functools import wraps

import numpy as np

from pointcloud_tpu_torch.envs.backends import (
    RobosuiteBackend,
    SyntheticBackend,
    SyntheticPegBackend,
    make_synthetic_backend,
    robosuite_available,
)
from pointcloud_tpu_torch.envs.encoders import (
    ObservationEncoder,
    PassthroughEncoder,
    flatten_observations,
    flatten_space,
)
from pointcloud_tpu_torch.envs.spaces import Box, Dict, GoalEnv
from pointcloud_tpu_torch.envs.utils import UI, render, to_cv2_img
from pointcloud_tpu_torch.utils import resolve_device


class RobosuiteGoalEnv(GoalEnv):
    """Generic multi-goal env around a simulator backend
    (reference base_env.py:21-127)."""

    metadata = {"render_modes": ["human"]}

    # set by each task subclass (reference base_env.py:25-26)
    task, scene = None, None
    proprio_keys, obs_keys, goal_keys = None, None, None

    def __init__(
        self,
        robo_kwargs,
        sensor,
        encoder,
        render_mode=None,
        render_info=None,
        backend=None,
        device="cuda",
        **kwargs,
    ):
        self.device = resolve_device(device)
        # camera config (set by the task via apply_preset for vision runs)
        if not hasattr(self, "cameras"):
            self.cameras = {}
            self.camera_size = (0, 0)
        self.poses = list(self.cameras.values())
        self.cameras = list(self.cameras.keys())

        if self.cameras:
            robo_kwargs = robo_kwargs | {
                "use_camera_obs": True,
                "camera_names": self.cameras,
                "camera_widths": self.camera_size[0],
                "camera_heights": self.camera_size[1],
            }
        else:
            robo_kwargs = robo_kwargs | {"use_camera_obs": False}

        self.sensor = sensor
        self.encoder = encoder
        self.backend = self._make_backend(
            backend, robo_kwargs | sensor.env_kwargs
        )
        self.robo_env = getattr(self.backend, "env", self.backend)

        # GT encoder for actual-success checking (base_env.py:64)
        self.gt = PassthroughEncoder(
            env=self, obs_keys=self.encoder.obs_keys, goal_keys=self.encoder.goal_keys
        )

        if not hasattr(self, "visual_goal"):
            self.visual_goal = kwargs.get("visual_goal", self.encoder.requires_vision)

        # cached episode info (base_env.py:70-82)
        self.raw_state = None
        self.observation = None
        self.proprioception = None
        self.encoding = None
        self.achieved = None
        self.goal_state = None
        self.goal_obs = None
        self.goal_encoding = None
        self.believe_success = False
        self.actual_success = False
        self.is_episode_success = False

        # Gym spaces (base_env.py:88-99)
        spec = self.backend.observation_spec()
        self.observation_space = Dict(
            {
                "observation": ObservationEncoder.concat_spaces(
                    flatten_space(spec, self.proprio_keys),
                    self.encoder.get_encoding_space(self.backend),
                ),
                "achieved_goal": self.encoder.get_goal_space(self.backend),
                "desired_goal": self.encoder.get_goal_space(self.backend),
            }
        )
        low, high = self.backend.action_spec
        self.action_space = Box(low, high, dtype=np.float32)

        # rendering (base_env.py:103-114)
        self.render_mode = render_mode
        self.render_info = render_info
        self.overlay = None
        self.viewer = None
        self.request_truncate = False
        self.reset_camera_poses = self.sensor.requires_vision

        # goal imagination env (base_env.py:117-127)
        self.simulate_goal = kwargs.get(
            "simulate_goal", self.visual_goal and self.encoder.global_encoding
        )
        self.goal_backend = None
        if self.simulate_goal:
            self.goal_backend = self._make_goal_backend(
                robo_kwargs | sensor.env_kwargs
            )

    def _make_backend(self, backend, robo_kwargs):
        if backend is not None:
            if callable(backend) and not hasattr(backend, "reset"):
                return backend(robo_kwargs=robo_kwargs, scene=self.scene)
            return backend
        if robosuite_available():
            return RobosuiteBackend(
                robo_kwargs,
                cameras=self.cameras,
                camera_poses=self.poses,
                camera_size=self.camera_size,
                device=self.device,
            )
        return make_synthetic_backend(robo_kwargs, scene=self.scene, device=self.device)

    def _make_goal_backend(self, robo_kwargs):
        if isinstance(self.backend, (SyntheticBackend, SyntheticPegBackend)):
            return make_synthetic_backend(robo_kwargs, scene=self.scene, seed=1,
                                          device=self.device)
        import robosuite.controllers as rc

        abs_controller = rc.load_controller_config(
            default_controller="OSC_POSITION"
        )
        abs_controller["control_delta"] = False
        return RobosuiteBackend(
            robo_kwargs | {"controller_configs": abs_controller},
            cameras=self.cameras,
            camera_poses=self.poses,
            camera_size=self.camera_size,
            device=self.device,
        )

    ###################################
    # defined by each individual task #
    ###################################

    def desired_goal_state(self, state, rerender=False):
        """Initial state -> desired goal state (S -> S)."""
        raise NotImplementedError

    def check_success(self, achieved, desired, info, force_gt=False) -> bool:
        """Latent encoders: per-dim calibrated-threshold check; ground truth:
        L2 < 0.05 (reference base_env.py:141-151)."""
        achieved = np.asarray(achieved)
        desired = np.asarray(desired)
        axis = 1 if achieved.ndim == 2 else None
        if not force_gt and self.encoder.latent_encoding:
            threshold = self.encoder.latent_threshold
            if threshold is None:
                threshold = 0.0
            return (np.abs(achieved - desired) <= threshold).all(axis=axis)
        return np.linalg.norm(achieved - desired, axis=axis) < 0.05

    @staticmethod
    def set_initial_state(backend, get_state):
        """Hook: called after reset, before the first observation."""

    def randomize(self):
        """Hook: randomize non-agent-controlled state (data generation)."""
        raise NotImplementedError

    #######################
    # for Gym GoalEnv API #
    #######################

    def compute_reward(self, achieved_goal, desired_goal, info):
        """G x G -> {-1, 0} (base_env.py:177-179)."""
        return self.check_success(achieved_goal, desired_goal, info) - 1

    def compute_truncated(self, achieved_goal, desired_goal, info):
        return self.backend.horizon == self.backend.timestep - 1

    def compute_terminated(self, achieved_goal, desired_goal, info):
        return False  # continuous tasks

    def _encode_current(self, state):
        obs = self.sensor.observe(state)
        proprio = flatten_observations(state, self.proprio_keys)
        obs_encoding, achieved_goal = self.encoder(obs)
        peg_obs = np.concatenate((proprio, obs_encoding), dtype=np.float32)
        return obs, proprio, obs_encoding, achieved_goal, peg_obs

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)

        state = self.backend.reset()
        self.set_initial_state(self.backend, self.backend.observe)
        state = self.backend.observe(force_update=True)
        self.sensor.reset()

        goal_state = self.desired_goal_state(state, rerender=self.visual_goal)
        goal_obs = self.sensor.observe(goal_state)

        obs, proprio, obs_encoding, achieved_goal, peg_obs = self._encode_current(
            state
        )
        goal_encoding = self.encoder.encode_goal(goal_obs)

        peg = {
            "observation": peg_obs,
            "achieved_goal": achieved_goal,
            "desired_goal": goal_encoding,
        }

        self.raw_state = state
        self.observation = obs
        self.proprioception = proprio
        self.encoding = obs_encoding
        self.achieved = achieved_goal
        self.goal_state = goal_state
        self.goal_obs = goal_obs
        self.goal_encoding = goal_encoding
        self.believe_success = self.check_success(achieved_goal, goal_encoding, None)
        self.actual_success = self.check_success(
            self.gt.encode_goal(state), self.gt.encode_goal(goal_state), None,
            force_gt=True,
        )
        self.is_episode_success = self.believe_success
        info = {"is_success": self.is_episode_success}

        if self.render_mode == "human":
            self.show_frame(state, info)
        return peg, info

    def step(self, action):
        state = self.backend.step(action)

        if self.goal_encoding is None:  # reset() was never called
            goal_state = self.desired_goal_state(state, rerender=self.visual_goal)
            self.goal_state = goal_state
            self.goal_obs = self.sensor.observe(goal_state)
            self.goal_encoding = self.encoder.encode_goal(self.goal_obs)

        obs, proprio, obs_encoding, achieved_goal, peg_obs = self._encode_current(
            state
        )
        peg = {
            "observation": peg_obs,
            "achieved_goal": achieved_goal,
            "desired_goal": self.goal_encoding,
        }

        self.believe_success = self.check_success(
            achieved_goal, self.goal_encoding, None
        )
        self.actual_success = self.check_success(
            self.gt.encode_goal(state),
            self.gt.encode_goal(self.goal_state),
            None,
            force_gt=True,
        )

        info = {}
        if self.is_episode_success:
            info["is_success"] = True
        else:
            self.is_episode_success = bool(self.believe_success)
            info["is_success"] = self.is_episode_success

        reward = self.compute_reward(achieved_goal, self.goal_encoding, info)
        terminated = self.compute_terminated(achieved_goal, self.goal_encoding, info)
        truncated = bool(self.request_truncate) or bool(
            self.compute_truncated(achieved_goal, self.goal_encoding, info)
        )

        self.raw_state = state
        self.observation = obs
        self.proprioception = proprio
        self.encoding = obs_encoding
        self.achieved = achieved_goal

        if self.render_mode == "human":
            self.show_frame(state, info)
        return peg, reward, terminated, truncated, info

    def render(self):
        pass

    def close(self):
        self.backend.close()
        if self.viewer is not None:
            self.viewer.close()
        if self.goal_backend is not None:
            self.goal_backend.close()
        if hasattr(self, "_vid"):
            try:
                self._vid.release()
            except Exception:
                pass

    #################
    # for rendering #
    #################

    def render_state(self, state_setter):
        """Render an imaginary state without disturbing the live one
        (reference base_env.py:324-339)."""
        backup = self.backend.snapshot()
        state_setter(self.backend)
        self.backend.forward()
        state = self.backend.observe(force_update=True)
        self.backend.restore(backup)
        return state

    def show_frame(self, robo_obs, info):
        """On-screen frame with goal overlay + success bars
        (reference base_env.py:341-387); headless-safe."""
        if self.render_mode is None:
            return
        if self.viewer is None:
            self.viewer = UI("pointcloud_tpu_torch", self, selected_camera=0)
        if not self.viewer.update():
            return
        self.request_truncate = self.viewer.is_pressed("r")

        if not self.cameras:
            return
        cam = self.cameras[self.viewer.camera_index]
        img_key = cam + "_image"
        if img_key not in robo_obs:
            return
        camera_image = np.asarray(robo_obs[img_key], dtype=np.float32) / 255.0
        camera_h, camera_w = camera_image.shape[:2]
        if self.render_info:
            points, rgb = self.render_info(self, robo_obs)
            try:
                from robosuite.utils.camera_utils import get_camera_transform_matrix

                w2c = get_camera_transform_matrix(
                    self.robo_env.sim, cam, camera_h, camera_w
                )
                render(points, rgb, camera_image, w2c, camera_h, camera_w)
            except Exception:
                pass
            mid = camera_w // 2
            camera_image[0:2, :mid, :] = [0, 1, 0] if self.actual_success else [1, 0, 0]
            camera_image[0:2, mid:, :] = [0, 1, 0] if self.believe_success else [1, 0, 0]
        if self.overlay:
            camera_image += self.overlay(camera_h, camera_w)
        img = to_cv2_img(camera_image)
        self.viewer.show(img)
        self._record_frame(img)

    def _record_frame(self, img):
        """Append the frame to recording/{task}.mp4 (base_env.py:380-387);
        silently disabled without cv2."""
        try:
            import os

            import cv2

            if not hasattr(self, "_vid"):
                os.makedirs("recording", exist_ok=True)
                self._vid = cv2.VideoWriter(
                    f"recording/{self.task}.mp4",
                    fourcc=cv2.VideoWriter_fourcc(*"mp4v"),
                    fps=20.0,
                    frameSize=(img.shape[1], img.shape[0]),
                )
            self._vid.write((np.clip(img, 0, 1) * 255).astype(np.uint8))
        except Exception:
            pass

    def simulate_eef_pos(
        self, target, state_setter=None, tolerance=0.01, max_steps=50,
        eef_key="robot0_eef_pos",
    ):
        """Goal imagination: drive the goal env's eef to `target` and return
        its observation (reference base_env.py:390-418)."""
        if not self.simulate_goal:
            raise Exception("goal simulation is disabled")
        self.goal_backend.reset()
        self.set_initial_state(self.goal_backend, self.goal_backend.observe)
        state, success = self.goal_backend.drive_eef_to(
            target, tolerance=tolerance, max_steps=max_steps
        )
        if state_setter:
            state_setter(self.goal_backend)
            self.goal_backend.forward()
            state = self.goal_backend.observe(force_update=True)
        return state, success


################# Utils #################


def render_goal(env, robo_obs):
    """Overlay points for goal visualization (reference base_env.py:424-441)."""
    p, c = [], []
    if env.encoder.requires_vision and not env.encoder.latent_encoding:
        p.append(env.encoding)
        c.append([1, 0, 0])
        p.append(env.goal_encoding)
        c.append([0, 0.7, 0])
    p.append(env.goal_state[env.goal_keys[0]])
    c.append([0, 1, 0])
    return np.array(p, dtype=object), np.array(c)


def assert_correctness(func):
    """Wrap desired_goal_state to assert the input state is not mutated
    (reference base_env.py:444-464)."""
    if func.__name__ == "desired_goal_state":

        @wraps(func)
        def wrapper(*args, **kwargs):
            state = args[1]
            backup = deepcopy(state)
            result = func(*args, **kwargs)
            for k in backup:
                np.testing.assert_equal(state[k], backup[k])
            return result

        return wrapper
    print("Warning: no correctness check for", func.__name__, "implemented, skipping...")
    return func
