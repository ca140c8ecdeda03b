"""Interactive reconstruction viewing (reference ae_viewer.py:14-220,
live_ae_viewer.py:16-194).

The reference's de-facto integration test is a human stepping an open3d
window through the val set: left/right arrows change the sample, the
prediction morphs to the new reconstruction with a lerp animation while the
ground-truth cloud jumps, `overlap` tints GT green / prediction red, and
the live viewer adds i/o/v key toggles for input / output / marker
visibility. This module reproduces that interaction model around a
UI-agnostic core so the same logic drives:

  * an open3d VisualizerWithKeyCallback window (reference parity; key codes
    262/263 = right/left arrows) when open3d is importable,
  * a matplotlib 3D window with mpl key events otherwise,
  * headless tests / PNG dumps (drive `key()` / `tick()` directly).

A copy of pointcloud_tpu/viewers/interactive.py (numpy and, lazily, matplotlib,
plotly or open3d; no JAX): tests/test_torch_viewers.py holds its code equal
to the original's."""

from __future__ import annotations

import numpy as np


def lerp(a, b, t):
    """interpolate_transition (reference ae_viewer.py:28-29)."""
    return np.asarray(a) * (1 - t) + np.asarray(b) * t


class ReconViewerCore:
    """Navigation + view-mode + lerp-animation state.

    load_fn(index) -> (pred_xyz, pred_rgb, gt_xyz, gt_rgb); n_items is the
    dataset length (indices wrap pythonically, like the reference's direct
    `dataset[index]`). The prediction part morphs between samples over
    1/animation_speed ticks; the ground-truth part jumps (the reference
    animates only the rows after the target cloud, ae_viewer.py:200-204).
    """

    def __init__(self, load_fn, n_items: int, mode: str = "overlap",
                 animation_speed: float = 0.1):
        assert mode in ("overlap", "side-by-side")
        self.load_fn = load_fn
        self.n = n_items
        self.mode = mode
        self.speed = animation_speed
        self.index = 0
        self.show_input = True    # live viewer 'i' (reference: starts False)
        self.show_output = True   # live viewer 'o'
        self.show_vis = True      # live viewer 'v' (marker overlays)
        self.prev = None
        self.curr = None
        self.anim_t = 1.0
        self._load()

    # -- navigation / keys ------------------------------------------------
    def key(self, name: str) -> bool:
        """Handle a key; returns True if the display should refresh."""
        if name in ("right", "left"):
            self.index += 1 if name == "right" else -1
            self.index %= self.n
            self._load()
            return True
        if name == "m":  # cycle view mode (extension; reference fixes it)
            self.mode = (
                "side-by-side" if self.mode == "overlap" else "overlap"
            )
            return True
        if name == "i":
            self.show_input = not self.show_input
            return True
        if name == "o":
            self.show_output = not self.show_output
            return True
        if name == "v":
            self.show_vis = not self.show_vis
            return True
        return False

    def _load(self):
        self.prev = self.curr
        loaded = tuple(
            np.asarray(v, np.float32) for v in self.load_fn(self.index)
        )
        if len(loaded) == 4:  # no marker overlay part
            z = np.zeros((0, 3), np.float32)
            loaded = loaded + (z, z)
        self.curr = loaded
        # start the morph animation (reference update_input, anim_t = 0)
        self.anim_t = 0.0 if self.prev is not None else 1.0

    # -- animation --------------------------------------------------------
    def tick(self) -> bool:
        """Advance the lerp animation one frame; True while animating."""
        if self.anim_t < 1.0:
            self.anim_t = min(self.anim_t + self.speed, 1.0)
            return True
        return False

    # -- frame assembly ---------------------------------------------------
    def frame(self):
        """(xyz (N,3), rgb (N,3)) of the current display state."""
        pred_xyz, pred_rgb, gt_xyz, gt_rgb, vis_xyz, vis_rgb = self.curr
        if (
            self.prev is not None
            and self.anim_t < 1.0
            and self.prev[0].shape == pred_xyz.shape
        ):
            pred_xyz = lerp(self.prev[0], pred_xyz, self.anim_t)
            pred_rgb = lerp(self.prev[1], pred_rgb, self.anim_t)

        gt_xyz, gt_rgb = gt_xyz.copy(), gt_rgb.copy()
        pred_xyz, pred_rgb = pred_xyz.copy(), pred_rgb.copy()
        if self.mode == "side-by-side":
            # shift along y (reference ae_viewer.py:146-149)
            gt_xyz[:, 1] -= 0.3
            pred_xyz[:, 1] += 0.3
        else:  # overlap: green / red tint (reference ae_viewer.py:151-154)
            gt_rgb = lerp(gt_rgb, np.array([0.0, 1.0, 0.0]), 0.3)
            pred_rgb = lerp(pred_rgb, np.array([1.0, 0.0, 0.0]), 0.3)

        parts = []
        if self.show_input:
            parts.append((gt_xyz, gt_rgb))
        if self.show_output:
            parts.append((pred_xyz, pred_rgb))
        if self.show_vis and len(vis_xyz):
            parts.append((vis_xyz, vis_rgb))
        if not parts:
            z = np.zeros((0, 3), np.float32)
            return z, z
        xyz = np.concatenate([p[0] for p in parts])
        rgb = np.clip(np.concatenate([p[1] for p in parts]), 0.0, 1.0)
        return xyz, rgb


def run_open3d(core: ReconViewerCore, width=640, height=480):
    """Reference-parity open3d loop (ae_viewer.py:180-214): arrow-key
    navigation + per-poll lerp updates."""
    import open3d as o3d

    vis = o3d.visualization.VisualizerWithKeyCallback()
    vis.create_window(height=height, width=width)

    def make_cb(name):
        def cb(_vis):
            core.key(name)
            return False

        return cb

    vis.register_key_callback(262, make_cb("right"))
    vis.register_key_callback(263, make_cb("left"))
    for k in "MIOV":
        vis.register_key_callback(ord(k), make_cb(k.lower()))

    pcd = o3d.geometry.PointCloud()
    xyz, rgb = core.frame()
    pcd.points = o3d.utility.Vector3dVector(xyz.astype(np.float64))
    pcd.colors = o3d.utility.Vector3dVector(rgb.astype(np.float64))
    vis.add_geometry(pcd)

    while vis.poll_events():
        core.tick()
        xyz, rgb = core.frame()
        pcd.points = o3d.utility.Vector3dVector(xyz.astype(np.float64))
        pcd.colors = o3d.utility.Vector3dVector(rgb.astype(np.float64))
        vis.update_geometry(pcd)
        vis.update_renderer()
    vis.destroy_window()


def run_matplotlib(core: ReconViewerCore, title=""):
    """Fallback interactive window: same keys via mpl key events."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.set_title(title)

    state = {"scatter": None}

    def redraw():
        xyz, rgb = core.frame()
        if state["scatter"] is not None:
            state["scatter"].remove()
        state["scatter"] = ax.scatter(
            xyz[:, 0], xyz[:, 1], xyz[:, 2], c=rgb, s=2
        )
        fig.canvas.draw_idle()

    def on_key(event):
        if core.key(event.key or ""):
            redraw()

    fig.canvas.mpl_connect("key_press_event", on_key)

    timer = fig.canvas.new_timer(interval=50)

    def on_tick():
        if core.tick():
            redraw()

    timer.add_callback(on_tick)
    timer.start()
    redraw()
    plt.show()


def run_interactive(core: ReconViewerCore, title=""):
    try:
        import open3d  # noqa: F401

        run_open3d(core)
    except ImportError:
        run_matplotlib(core, title=title)
