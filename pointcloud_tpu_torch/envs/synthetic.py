"""Synthetic tabletop scenes (port of pointcloud_tpu/envs/synthetic.py).

The scenes, their geometry, the quaternion helpers and `generate_dataset`
are numpy copies of the JAX package's (tests/test_torch_env_layer.py holds
that code equal to the original); the sensor chain that turns a rendered
cloud into an observation, FilterBBox then FPS or RS downsampling, is
transforms.sensor_chain on the scene's device: one `fps` launch an
observation on a card.

The reference generates training data by rolling robosuite/MuJoCo and saving
per-frame npz observations (generate_pc.py:12-115). This module provides a
kinematic stand-in that emits observations with the SAME contract (points /
rgb / segmentation / boundingbox / ground_truth / classes) for the 'Table',
'Cube' and 'PegInHole' scenes, so the dataset -> training -> encoder ->
GoalEnv stack runs without robosuite. It is the physics backend of the
synthetic GoalEnv backends (envs/backends.py).

Geometry: a table plane (class env), an optional cube (class cube), a
three-segment arm from a fixed base to the end-effector (class arm), the
base block (class base), and a gripper block at the eef (class gripper) —
the classes/states layout of cfg_scene['Cube'] (scenes.py).

Random draws: `observe` draws one integer from the scene's numpy generator
after rendering, as the JAX package draws its PRNG key, so every later
frame renders the same points; under RS it seeds the sampler's
torch.Generator, whose numbers differ from JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloud_tpu_torch.envs.scenes import cfg_scene
from pointcloud_tpu_torch.transforms import sensor_chain
from pointcloud_tpu_torch.utils import resolve_device


def _sense(pc: np.ndarray, bbox, K: int, sampler: str, seed: int, device) -> dict:
    """The observation dict of a raw labelled cloud (N, 7): FilterBBox to
    `bbox`, then FPS ('FPS') or RS (any other sampler, as the JAX package)
    to K points, on `device`; numpy out."""
    chain = sensor_chain(bbox, K, "FPS" if sampler == "FPS" else "RS", seed, device)
    out, _ = chain(torch.from_numpy(pc).to(device))
    out = out.cpu().numpy()
    return {
        "points": out[:, :3],
        "rgb": out[:, 3:6],
        "segmentation": out[:, 6:7].astype(np.int64),
        "boundingbox": np.asarray(bbox, dtype=np.float32),
    }


TABLE_Z = 0.8
ARM_BASE = np.array([-0.56, 0.0, 0.912], dtype=np.float32)
CUBE_SIZE = 0.04
EEF_RANGE = np.array([[-0.3, 0.3], [-0.3, 0.3], [0.82, 1.3]], dtype=np.float32)
CUBE_RANGE = np.array([[-0.3, 0.3], [-0.3, 0.3]], dtype=np.float32)


def _plane(rng, n, center, size_xy, z):
    xy = (rng.random((n, 2), dtype=np.float32) - 0.5) * size_xy + center
    z = np.full((n, 1), z, dtype=np.float32)
    return np.concatenate([xy, z], axis=1)


def _box(rng, n, center, half):
    """Uniform points on the surface of an axis-aligned box."""
    half = np.asarray(half, dtype=np.float32)
    areas = np.array(
        [half[1] * half[2], half[1] * half[2], half[0] * half[2], half[0] * half[2],
         half[0] * half[1], half[0] * half[1]],
        dtype=np.float32,
    )
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = (rng.random((n, 2), dtype=np.float32) * 2 - 1)
    pts = np.empty((n, 3), dtype=np.float32)
    axis = face // 2
    sign = np.where(face % 2 == 0, 1.0, -1.0).astype(np.float32)
    for a in range(3):
        sel = axis == a
        others = [i for i in range(3) if i != a]
        pts[sel, a] = sign[sel] * half[a]
        pts[sel, others[0]] = u[sel, 0] * half[others[0]]
        pts[sel, others[1]] = u[sel, 1] * half[others[1]]
    return pts + np.asarray(center, dtype=np.float32)


def _cylinder(rng, n, p0, p1, radius):
    """Uniform points on the lateral surface of a segment cylinder."""
    p0 = np.asarray(p0, dtype=np.float32)
    p1 = np.asarray(p1, dtype=np.float32)
    axis = p1 - p0
    length = float(np.linalg.norm(axis) + 1e-9)
    d = axis / length
    # orthonormal frame around d
    a = np.array([1.0, 0.0, 0.0], dtype=np.float32)
    if abs(d @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    e1 = np.cross(d, a)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(d, e1)
    t = rng.random(n, dtype=np.float32)[:, None]
    theta = rng.random(n, dtype=np.float32) * 2 * np.pi
    ring = (np.cos(theta)[:, None] * e1 + np.sin(theta)[:, None] * e2) * radius
    return p0 + t * axis + ring


class SyntheticScene:
    """Kinematic scene state + labeled point-cloud rendering.

    The ground-truth state is {'cube_pos', 'robot0_eef_pos'} for 'Cube'
    ({'robot0_eef_pos'} only for 'Table'), matching scenes.py states.
    """

    def __init__(self, scene: str = "Cube", seed: int = 0, raw_points: int = 16384,
                 device="cuda"):
        if scene not in ("Table", "Cube"):
            raise ValueError(f"SyntheticScene supports Table/Cube, got {scene}")
        self.device = resolve_device(device)
        self.scene = scene
        self.cfg = cfg_scene[scene]
        self.rng = np.random.default_rng(seed)
        self.raw_points = raw_points
        self.has_cube = scene == "Cube"
        self.reset()

    def reset(self):
        self.eef_pos = self._random_eef()
        self.cube_pos = self._random_cube()
        return self.state()

    def _random_eef(self):
        lo, hi = EEF_RANGE[:, 0], EEF_RANGE[:, 1]
        return (lo + self.rng.random(3, dtype=np.float32) * (hi - lo)).astype(np.float32)

    def _random_cube(self):
        xy = CUBE_RANGE[:, 0] + self.rng.random(2, dtype=np.float32) * (
            CUBE_RANGE[:, 1] - CUBE_RANGE[:, 0]
        )
        return np.array([xy[0], xy[1], TABLE_Z + CUBE_SIZE / 2], dtype=np.float32)

    def randomize(self):
        """Re-drop non-agent-controlled objects (reference env.randomize,
        envs.py:258: random cube drop)."""
        self.cube_pos = self._random_cube()

    def set_eef(self, pos):
        self.eef_pos = np.clip(
            np.asarray(pos, dtype=np.float32), EEF_RANGE[:, 0], EEF_RANGE[:, 1]
        )

    def set_cube(self, pos):
        self.cube_pos = np.asarray(pos, dtype=np.float32)

    def step_eef(self, delta, scale: float = 0.05):
        """Kinematic eef motion under a [-1,1]^3 action (OSC_POSITION analog)."""
        self.set_eef(self.eef_pos + np.asarray(delta, dtype=np.float32)[:3] * scale)

    def state(self) -> dict:
        s = {"robot0_eef_pos": self.eef_pos.copy()}
        if self.has_cube:
            s["cube_pos"] = self.cube_pos.copy()
        return s

    def render_points(self, n: int | None = None):
        """Labeled raw cloud (points (N,3), rgb (N,3), labels (N,)) before
        any sensor preprocessing."""
        n = n or self.raw_points
        rng = self.rng
        counts = {
            "env": int(n * 0.45),
            "cube": int(n * 0.05) if self.has_cube else 0,
            "arm": int(n * 0.30),
            "base": int(n * 0.05),
        }
        counts["gripper"] = n - sum(counts.values())

        classes = self.cfg["classes"]
        parts, labels = [], []

        def add(pts, cls):
            parts.append(pts)
            labels.append(np.full(len(pts), classes.index(cls), dtype=np.int32))

        add(_plane(rng, counts["env"], np.zeros(2, np.float32), 1.2, TABLE_Z), "env")
        if counts["cube"]:
            add(_box(rng, counts["cube"], self.cube_pos, [CUBE_SIZE / 2] * 3), "cube")
        elbow = (ARM_BASE + self.eef_pos) / 2 + np.array([0, 0, 0.25], np.float32)
        n_arm = counts["arm"]
        add(
            np.concatenate(
                [
                    _cylinder(rng, n_arm // 2, ARM_BASE, elbow, 0.05),
                    _cylinder(rng, n_arm - n_arm // 2, elbow, self.eef_pos, 0.04),
                ]
            ),
            "arm",
        )
        add(_box(rng, counts["base"], ARM_BASE - [0, 0, 0.06], [0.06, 0.06, 0.06]), "base")
        add(_box(rng, counts["gripper"], self.eef_pos, [0.02, 0.04, 0.05]), "gripper")

        points = np.concatenate(parts).astype(np.float32)
        labels = np.concatenate(labels)
        colors = np.asarray(self.cfg["class_colors"], dtype=np.float32)
        rgb = np.clip(
            colors[labels] + rng.normal(0, 0.02, (len(labels), 3)).astype(np.float32),
            0.0,
            1.0,
        )
        # shuffle so class blocks are interleaved (as multi-camera clouds are)
        perm = rng.permutation(len(points))
        return points[perm], rgb[perm], labels[perm]

    def observe(self, sample_points: int | None = None, sampler: str | None = None):
        """Sensor-style observation dict with the generate_pc npz contract
        (generate_pc.py:57-62): FilterBBox to the scene bbox then FPS/RS
        downsample to `sample_points`, on the scene's device."""
        K = sample_points or self.cfg["sample_points"]
        sampler = sampler or self.cfg["sampler"]
        points, rgb, labels = self.render_points()
        pc = np.concatenate([points, rgb, labels[:, None].astype(np.float32)], axis=1)
        return _sense(pc, self.cfg["bbox"], K, sampler,
                      int(self.rng.integers(0, 2**31)), self.device)


########## Two-arm PegInHole scene ##########

# Quaternions are (w, x, y, z) throughout (mujoco convention).


def _quat_rotate(q, v):
    """Rotate vector v by quaternion q."""
    w, x, y, z = q
    u = np.array([x, y, z], dtype=np.float32)
    v = np.asarray(v, dtype=np.float32)
    return 2.0 * (u @ v) * u + (w * w - u @ u) * v + 2.0 * w * np.cross(u, v)


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dtype=np.float32,
    )


def _quat_from_axis_angle(axis_angle):
    """Small-rotation quaternion from an axis-angle vector."""
    aa = np.asarray(axis_angle, dtype=np.float32)
    theta = float(np.linalg.norm(aa))
    if theta < 1e-8:
        return np.array([1.0, 0.0, 0.0, 0.0], dtype=np.float32)
    axis = aa / theta
    return np.concatenate(
        [[np.cos(theta / 2)], np.sin(theta / 2) * axis]
    ).astype(np.float32)


PEG_LENGTH = 0.12
PEG_RADIUS = 0.015
HOLE_PLATE = 0.16  # square plate side
HOLE_RADIUS = 0.025
PLATE_THICK = 0.02
ARM0_BASE = np.array([-0.6, 0.0, 1.0], dtype=np.float32)
ARM1_BASE = np.array([0.6, 0.0, 1.0], dtype=np.float32)
# overlapping workspaces: the peg arm must be able to reach any hole pose
# exactly (solve() centers the peg in the hole), so both boxes share the
# central region; resets bias each arm to its own side via the sampling box
PEG_RANGE = np.array([[-0.45, 0.45], [-0.4, 0.4], [0.8, 1.6]], dtype=np.float32)
HOLE_RANGE = np.array([[-0.45, 0.45], [-0.4, 0.4], [0.8, 1.6]], dtype=np.float32)


class SyntheticPegScene:
    """Kinematic two-arm peg-in-hole scene (robosuite TwoArmPegInHole analog,
    reference robosuite_envs/envs.py:342-427).

    Arm 0 rigidly holds a peg (cylinder along its local +z); arm 1 holds a
    square plate with a hole through it (hole axis = plate local +z). The
    task-space observables match cfg_scene['PegInHole'].states:
      peg_to_hole = hole_pos - peg_pos,
      peg_quat / hole_quat (w, x, y, z),
      t = component of peg_to_hole along the hole axis,
      d = perpendicular distance of the peg center from the hole axis,
      angle = 1 - |cos(peg axis, hole axis)|  (0 = axes aligned).
    Success (per-dim thresholds [0.14, 0.06, 0.05], envs.py RoboPegInHole)
    therefore means: centered within the plate, near the hole plane, and
    aligned to within ~18 degrees.
    """

    def __init__(self, scene: str = "PegInHole", seed: int = 0, raw_points: int = 16384,
                 device="cuda"):
        self.device = resolve_device(device)
        self.scene = scene
        self.cfg = cfg_scene["PegInHole"]
        self.rng = np.random.default_rng(seed)
        self.raw_points = raw_points
        self.reset()

    # --- state ---

    def reset(self):
        self.peg_pos = self._random_in(PEG_RANGE)
        self.hole_pos = self._random_in(HOLE_RANGE)
        self.peg_quat = _quat_from_axis_angle(
            self.rng.normal(0, 0.3, 3).astype(np.float32)
        )
        self.hole_quat = _quat_from_axis_angle(
            self.rng.normal(0, 0.3, 3).astype(np.float32)
        )
        return self.state()

    def _random_in(self, rng_box):
        lo, hi = rng_box[:, 0], rng_box[:, 1]
        return (lo + self.rng.random(3, dtype=np.float32) * (hi - lo)).astype(
            np.float32
        )

    def randomize(self):
        """Re-drop the hole plate pose (the non-agent half of the scene)."""
        self.hole_pos = self._random_in(HOLE_RANGE)
        self.hole_quat = _quat_from_axis_angle(
            self.rng.normal(0, 0.3, 3).astype(np.float32)
        )

    def set_arm(self, arm: int, pos=None, quat=None):
        if arm == 0:
            if pos is not None:
                self.peg_pos = np.clip(
                    np.asarray(pos, np.float32), PEG_RANGE[:, 0], PEG_RANGE[:, 1]
                )
            if quat is not None:
                self.peg_quat = np.asarray(quat, np.float32)
        else:
            if pos is not None:
                self.hole_pos = np.clip(
                    np.asarray(pos, np.float32), HOLE_RANGE[:, 0], HOLE_RANGE[:, 1]
                )
            if quat is not None:
                self.hole_quat = np.asarray(quat, np.float32)

    def step_arms(self, action, pos_scale: float = 0.05, rot_scale: float = 0.2):
        """Two stacked OSC_POSE deltas: [dpos0, drot0, dpos1, drot1] in
        [-1, 1]^12 (robosuite TwoArmPegInHole action convention)."""
        a = np.asarray(action, dtype=np.float32)
        self.set_arm(0, pos=self.peg_pos + a[0:3] * pos_scale)
        self.peg_quat = _quat_mul(
            _quat_from_axis_angle(a[3:6] * rot_scale), self.peg_quat
        )
        self.set_arm(1, pos=self.hole_pos + a[6:9] * pos_scale)
        self.hole_quat = _quat_mul(
            _quat_from_axis_angle(a[9:12] * rot_scale), self.hole_quat
        )

    def solve(self):
        """Expert (kinematic) solution: align the peg with the hole axis and
        center it in the hole plane — the goal-state producer that replaces
        the reference's pickled expert-rollout goals."""
        self.peg_quat = self.hole_quat.copy()
        self.set_arm(0, pos=self.hole_pos)
        return self.state()

    def state(self) -> dict:
        peg_axis = _quat_rotate(self.peg_quat, [0.0, 0.0, 1.0])
        hole_axis = _quat_rotate(self.hole_quat, [0.0, 0.0, 1.0])
        v = self.hole_pos - self.peg_pos
        t = np.float32(v @ hole_axis)
        d = np.float32(np.linalg.norm(v - t * hole_axis))
        angle = np.float32(1.0 - abs(peg_axis @ hole_axis))
        return {
            "peg_to_hole": v.astype(np.float32),
            "peg_quat": self.peg_quat.copy(),
            "hole_pos": self.hole_pos.copy(),
            "hole_quat": self.hole_quat.copy(),
            "t": np.array([t], dtype=np.float32),
            "d": np.array([d], dtype=np.float32),
            "angle": np.array([angle], dtype=np.float32),
        }

    # --- rendering ---

    def render_points(self, n: int | None = None):
        """Labeled raw cloud with the PegInHole class layout
        (classes: peg_hole / robot0 / base0 / env / robot1 / base1)."""
        n = n or self.raw_points
        rng = self.rng
        counts = {
            "peg_hole": int(n * 0.35),
            "robot0": int(n * 0.25),
            "robot1": int(n * 0.25),
            "base0": int(n * 0.05),
            "base1": int(n * 0.05),
        }
        counts["env"] = n - sum(counts.values())
        classes = self.cfg["classes"]
        parts, labels = [], []

        def add(pts, cls):
            parts.append(pts.astype(np.float32))
            labels.append(np.full(len(pts), classes.index(cls), dtype=np.int32))

        # peg cylinder + hole plate share the 'peg_hole' class
        peg_axis = _quat_rotate(self.peg_quat, [0.0, 0.0, 1.0])
        n_peg = counts["peg_hole"] // 2
        add(
            _cylinder(
                rng,
                n_peg,
                self.peg_pos - peg_axis * PEG_LENGTH / 2,
                self.peg_pos + peg_axis * PEG_LENGTH / 2,
                PEG_RADIUS,
            ),
            "peg_hole",
        )
        # plate: uniform box points in the plate frame, hole cut out
        n_plate = counts["peg_hole"] - n_peg
        local = (rng.random((2 * n_plate, 3), dtype=np.float32) - 0.5) * np.array(
            [HOLE_PLATE, HOLE_PLATE, PLATE_THICK], dtype=np.float32
        )
        keep = np.linalg.norm(local[:, :2], axis=1) > HOLE_RADIUS
        local = local[keep][:n_plate]
        world = (
            np.stack([_quat_rotate(self.hole_quat, p) for p in local])
            if len(local)
            else np.zeros((0, 3), np.float32)
        )
        add(world + self.hole_pos, "peg_hole")

        for arm, (base, tip, cls_arm, cls_base) in enumerate(
            [
                (ARM0_BASE, self.peg_pos, "robot0", "base0"),
                (ARM1_BASE, self.hole_pos, "robot1", "base1"),
            ]
        ):
            elbow = (base + tip) / 2 + np.array([0, 0, 0.25], np.float32)
            k = counts[cls_arm]
            add(
                np.concatenate(
                    [
                        _cylinder(rng, k // 2, base, elbow, 0.05),
                        _cylinder(rng, k - k // 2, elbow, tip, 0.04),
                    ]
                ),
                cls_arm,
            )
            add(
                _box(rng, counts[cls_base], base - [0, 0, 0.06], [0.06, 0.06, 0.06]),
                cls_base,
            )

        add(_plane(rng, counts["env"], np.zeros(2, np.float32), 2.0, 0.5), "env")

        points = np.concatenate(parts).astype(np.float32)
        labels = np.concatenate(labels)
        colors = np.asarray(self.cfg["class_colors"], dtype=np.float32)
        rgb = np.clip(
            colors[labels] + rng.normal(0, 0.02, (len(labels), 3)).astype(np.float32),
            0.0,
            1.0,
        )
        perm = rng.permutation(len(points))
        return points[perm], rgb[perm], labels[perm]

    def observe(self, sample_points: int | None = None, sampler: str | None = None):
        """Sensor-style observation dict (same contract as SyntheticScene)."""
        K = sample_points or self.cfg["sample_points"]
        sampler = sampler or self.cfg["sampler"]
        points, rgb, labels = self.render_points()
        pc = np.concatenate([points, rgb, labels[:, None].astype(np.float32)], axis=1)
        return _sense(pc, self.cfg["bbox"], K, sampler,
                      int(self.rng.integers(0, 2**31)), self.device)


def generate_dataset(
    out_dir: str,
    scene: str = "Cube",
    frames: int = 100,
    seed: int = 0,
    sample_points: int | None = None,
    device="cuda",
):
    """Write `frames` npz files with the generate_pc contract into out_dir,
    each frame's sensor chain on `device`.

    Equivalent of generate_pc.py for the synthetic backend; the env-rolling
    version lives in pointcloud_tpu_torch/data/generate.py.
    """
    import os

    os.makedirs(out_dir, exist_ok=True)
    if scene == "PegInHole":
        sim = SyntheticPegScene(seed=seed, device=device)
    else:
        sim = SyntheticScene(scene=scene, seed=seed, device=device)
    gt_states = [s for s in sim.cfg["states"] if s]
    classes = np.array(
        list(zip(sim.cfg["classes"], sim.cfg["class_colors"])), dtype=object
    )
    for i in range(frames):
        sim.randomize()
        if isinstance(sim, SyntheticPegScene):
            sim.set_arm(0, pos=sim._random_in(PEG_RANGE))
            sim.peg_quat = _quat_from_axis_angle(
                sim.rng.normal(0, 0.3, 3).astype(np.float32)
            )
        else:
            sim.set_eef(sim._random_eef())
        obs = sim.observe(sample_points=sample_points)
        state = sim.state()
        ground_truth = np.array([(s, state[s]) for s in gt_states], dtype=object)
        np.savez(
            os.path.join(out_dir, f"{i}.npz"),
            ground_truth=ground_truth,
            classes=classes,
            **obs,
        )
    return out_dir
