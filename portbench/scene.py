"""Synthetic Cube-scene clouds for the benchmark's traffic.

A frozen numpy copy of the geometry of the port's `SyntheticScene.render_points`
(a table plane, a cube, a two-segment arm from a fixed base to the
end-effector, the base block and a gripper block at the end-effector, each
class in its share of the points, rgb from the class colours plus noise,
the points shuffled), vectorised over frames so that a whole pool renders
in a few numpy calls. Each frame draws its own end-effector and cube
position. The geometry, not uniform noise, sets how many points fall into
each ball of PointNet++'s groupings and where FPS goes.

The benchmark keeps its own copy so that a later change to the program's
scene cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np

TABLE_Z = 0.8
ARM_BASE = np.array([-0.56, 0.0, 0.912], dtype=np.float32)
CUBE_SIZE = 0.04
EEF_RANGE = np.array([[-0.3, 0.3], [-0.3, 0.3], [0.82, 1.3]], dtype=np.float32)
CUBE_RANGE = np.array([[-0.3, 0.3], [-0.3, 0.3]], dtype=np.float32)
# the Cube scene's classes and colours (cfg_scene["Cube"])
CLASSES = ["env", "cube", "arm", "base", "gripper"]
CLASS_COLORS = np.array([[0, 0, 0], [1, 0, 0], [0.8, 0.8, 0.8], [0, 1, 0], [0, 0, 1]],
                        dtype=np.float32)
BBOX = [[-0.8, 0.8], [-0.8, 0.8], [0.5, 2.0]]


def _box(rng, F, n, center, half):
    """(F, n, 3) uniform points on the surface of axis-aligned boxes of
    half sizes `half`, centred at `center` ((3,) or (F, 3))."""
    half = np.asarray(half, dtype=np.float32)
    areas = np.array([half[1] * half[2]] * 2 + [half[0] * half[2]] * 2
                     + [half[0] * half[1]] * 2, dtype=np.float32)
    face = rng.choice(6, size=(F, n), p=areas / areas.sum())
    u = rng.random((F, n, 2), dtype=np.float32) * 2 - 1
    pts = np.empty((F, n, 3), dtype=np.float32)
    axis = face // 2
    sign = np.where(face % 2 == 0, 1.0, -1.0).astype(np.float32)
    for a in range(3):
        sel = axis == a
        others = [i for i in range(3) if i != a]
        pts[..., a] = np.where(sel, sign * half[a], pts[..., a])
        pts[..., others[0]] = np.where(sel, u[..., 0] * half[others[0]],
                                       pts[..., others[0]])
        pts[..., others[1]] = np.where(sel, u[..., 1] * half[others[1]],
                                       pts[..., others[1]])
    center = np.asarray(center, dtype=np.float32).reshape(-1, 1, 3)
    return pts + center


def _cylinder(rng, F, n, p0, p1, radius):
    """(F, n, 3) uniform points on the lateral surfaces of segment cylinders
    from p0 to p1 ((3,) or (F, 3) each)."""
    p0 = np.broadcast_to(np.asarray(p0, dtype=np.float32), (F, 3))
    p1 = np.broadcast_to(np.asarray(p1, dtype=np.float32), (F, 3))
    axis = p1 - p0
    d = axis / (np.linalg.norm(axis, axis=1, keepdims=True) + 1e-9)
    a = np.where(np.abs(d[:, :1]) > 0.9, np.array([[0.0, 1.0, 0.0]], np.float32),
                 np.array([[1.0, 0.0, 0.0]], np.float32))
    e1 = np.cross(d, a)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(d, e1)
    t = rng.random((F, n, 1), dtype=np.float32)
    theta = rng.random((F, n, 1), dtype=np.float32) * 2 * np.pi
    ring = (np.cos(theta) * e1[:, None] + np.sin(theta) * e2[:, None]) * radius
    return (p0[:, None] + t * axis[:, None] + ring).astype(np.float32)


def render(rng: np.random.Generator, frames: int, n: int) -> np.ndarray:
    """(frames, n, 6) float32 clouds, xyz + rgb, in world coordinates."""
    F = frames
    lo, hi = EEF_RANGE[:, 0], EEF_RANGE[:, 1]
    eef = (lo + rng.random((F, 3), dtype=np.float32) * (hi - lo)).astype(np.float32)
    cxy = CUBE_RANGE[:, 0] + rng.random((F, 2), dtype=np.float32) * (
        CUBE_RANGE[:, 1] - CUBE_RANGE[:, 0])
    cube = np.concatenate([cxy, np.full((F, 1), TABLE_Z + CUBE_SIZE / 2, np.float32)], 1)
    counts = {"env": int(n * 0.45), "cube": int(n * 0.05), "arm": int(n * 0.30),
              "base": int(n * 0.05)}
    counts["gripper"] = n - sum(counts.values())

    xy = (rng.random((F, counts["env"], 2), dtype=np.float32) - 0.5) * 1.2
    plane = np.concatenate([xy, np.full((F, counts["env"], 1), TABLE_Z, np.float32)], 2)
    elbow = (ARM_BASE + eef) / 2 + np.array([0, 0, 0.25], np.float32)
    n_arm = counts["arm"]
    parts = [
        plane,
        _box(rng, F, counts["cube"], cube, [CUBE_SIZE / 2] * 3),
        np.concatenate([_cylinder(rng, F, n_arm // 2, ARM_BASE, elbow, 0.05),
                        _cylinder(rng, F, n_arm - n_arm // 2, elbow, eef, 0.04)], 1),
        _box(rng, F, counts["base"], ARM_BASE - [0, 0, 0.06], [0.06, 0.06, 0.06]),
        _box(rng, F, counts["gripper"], eef, [0.02, 0.04, 0.05]),
    ]
    labels = np.concatenate([np.full(counts[c], i, np.int32) for i, c in enumerate(CLASSES)])
    points = np.concatenate(parts, axis=1)
    rgb = np.clip(CLASS_COLORS[labels][None]
                  + rng.normal(0, 0.02, (F, n, 3)).astype(np.float32), 0.0, 1.0)
    # shuffle so that class blocks interleave, as multi-camera clouds do
    perm = np.argsort(rng.random((F, n), dtype=np.float32), axis=1)
    cloud = np.concatenate([points, rgb], axis=2)
    return np.ascontiguousarray(np.take_along_axis(cloud, perm[..., None], axis=1),
                                dtype=np.float32)
