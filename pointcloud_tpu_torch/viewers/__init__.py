"""Interactive viewers (port of pointcloud_tpu/viewers; reference:
pc_viewer.py / ae_viewer.py / live_ae_viewer.py). Windowing deps
(open3d/plotly) are optional; everything degrades to matplotlib and
headless PNG export, and the pred/target assembly logic lives in
`reconstruct`, which runs the model on its device and plots nothing."""

from pointcloud_tpu_torch.viewers.reconstruct import (
    aa_lines,
    assemble_prediction,
    load_viewer_model,
)

__all__ = ["assemble_prediction", "aa_lines", "load_viewer_model",
           "require_matplotlib", "check_plotting"]


def require_matplotlib():
    """Raise a clear ImportError if matplotlib is not installed (the
    plotting modules import it only when they draw)."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError("plotting needs matplotlib, which is not installed "
                          "(pip install matplotlib); the model and the env run "
                          "without it")


def check_plotting(save=None):
    """`require_matplotlib()` where `plot.show_clouds` would draw with
    matplotlib: a PNG (`save`), or a window without open3d or plotly."""
    from pointcloud_tpu_torch.viewers.plot import _backend

    if save is not None or _backend() == "matplotlib":
        require_matplotlib()
