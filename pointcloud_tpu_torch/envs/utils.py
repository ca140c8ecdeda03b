"""Env-layer utilities (a copy of pointcloud_tpu/envs/utils.py; reference:
robosuite_envs/utils.py:8-44, 180-284; tests/test_torch_env_layer.py holds
the code equal to the original).

apply_preset / set_obj_pos / set_robot_pose / random_action /
disable_rendering plus the cv2 UI, world-point overlay rendering, and
to_cv2_img. cv2 is optional; the UI degrades to a no-op without a display.
"""

from __future__ import annotations

import contextlib

import numpy as np


def apply_preset(obj, preset: dict):
    """Set every scene-config key as an attribute (reference utils.py:8-14)."""
    for k, v in preset.items():
        setattr(obj, k, v)
    return obj


def set_obj_pos(sim, joint: str, pos=None, quat=None):
    """Teleport a free joint (reference utils.py:180-184)."""
    pos = pos if pos is not None else sim.data.get_joint_qpos(joint)[:3]
    quat = quat if quat is not None else sim.data.get_joint_qpos(joint)[3:]
    sim.data.set_joint_qpos(joint, np.concatenate([np.asarray(pos), np.asarray(quat)]))
    sim.forward()


def set_robot_pose(robo_env, robot, qpos):
    """Set robot joint positions directly (reference utils.py:185-186)."""
    robo_env.sim.data.qpos[robot._ref_joint_pos_indexes] = qpos
    robo_env.sim.forward()


def random_action(env, rng=None):
    """Uniform random action in the env's action space (utils.py:188-189)."""
    rng = rng or np.random.default_rng()
    space = env.action_space
    return rng.uniform(space.low, space.high).astype(np.float32)


@contextlib.contextmanager
def disable_rendering(robo_env):
    """Temporarily skip observable updates during multi-step setup
    (reference utils.py:270-284 monkey-patches _get_observations).

    Yields a `renderer(force_update=...)` callable that re-enables and
    fetches observations."""
    original = robo_env._get_observations

    def noop(force_update=False):
        return None

    def renderer(force_update=False):
        return original(force_update=force_update)

    robo_env._get_observations = noop
    try:
        yield renderer
    finally:
        robo_env._get_observations = original


def render(points, rgb, camera_image, world_to_camera, camera_h, camera_w, size=2):
    """Project world points into a camera image in place
    (reference utils.py:24-44)."""
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    rgb = np.atleast_2d(np.asarray(rgb, dtype=np.float64))
    if points.size == 0:
        return camera_image
    hom = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    pix = hom @ np.asarray(world_to_camera).T
    z = pix[:, 2]
    valid = z > 1e-6
    u = (pix[:, 0] / np.maximum(z, 1e-6)).astype(int)
    v = (pix[:, 1] / np.maximum(z, 1e-6)).astype(int)
    for i in np.nonzero(valid)[0]:
        r0, r1 = max(v[i] - size, 0), min(v[i] + size, camera_h)
        c0, c1 = max(u[i] - size, 0), min(u[i] + size, camera_w)
        if r0 < r1 and c0 < c1:
            camera_image[r0:r1, c0:c1] = rgb[i]
    return camera_image


def to_cv2_img(img):
    """Float RGB (origin bottom-left robosuite convention) -> cv2 BGR
    (reference utils.py:16-22)."""
    img = np.asarray(img)[::-1]
    return img[:, :, ::-1].copy()


class UI:
    """cv2 window with camera switching and key polling
    (reference utils.py:192-266); headless-safe no-op without cv2/display."""

    def __init__(self, window: str, env, selected_camera: int = 0):
        self.window = window
        self.env = env
        self.camera_index = selected_camera
        self._last_key = -1
        try:
            import cv2

            self.cv2 = cv2
            cv2.namedWindow(window)
            self.ok = True
        except Exception:
            self.cv2 = None
            self.ok = False

    def update(self) -> bool:
        if not self.ok:
            return True
        self._last_key = self.cv2.waitKey(1)
        if self._last_key == 27:  # ESC closes
            return False
        if self._last_key == ord("c"):
            self.camera_index = (self.camera_index + 1) % max(
                len(self.env.cameras), 1
            )
        return True

    def is_pressed(self, char: str) -> bool:
        return self.ok and self._last_key == ord(char)

    def show(self, img):
        if self.ok:
            self.cv2.imshow(self.window, img)

    def close(self):
        if self.ok:
            self.cv2.destroyWindow(self.window)
