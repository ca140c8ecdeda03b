"""Point-cloud plotting backends: plotly > open3d > matplotlib > PNG export.

`show_clouds([...(xyz, rgb, name)], mode, save)` is the single entry point
used by the viewer CLIs (reference pc_viewer.py:10-60 uses pytorch3d's
plotly scene; ae_viewer.py uses open3d windows).

A copy of pointcloud_tpu/viewers/plot.py (numpy and, lazily, matplotlib,
plotly or open3d; no JAX): tests/test_torch_viewers.py holds its code equal
to the original's."""

from __future__ import annotations

import numpy as np


def _backend():
    try:
        import open3d  # noqa: F401

        return "open3d"
    except Exception:
        pass
    try:
        import plotly  # noqa: F401

        return "plotly"
    except Exception:
        pass
    return "matplotlib"


def show_clouds(clouds, mode: str = "overlap", save: str | None = None, title=""):
    """clouds: list of (xyz (N,3), rgb (N,3) in [0,1], name). mode:
    'overlap' draws everything in one scene; 'side-by-side' offsets each
    cloud along x (reference ae_viewer overlap/side-by-side modes)."""
    offset = 0.0
    prepared = []
    for xyz, rgb, name in clouds:
        xyz = np.asarray(xyz, np.float32)
        if mode == "side-by-side" and len(xyz):
            span = xyz[:, 0].max() - xyz[:, 0].min() + 0.2
            xyz = xyz + np.array([offset, 0, 0], np.float32)
            offset += span
        prepared.append((xyz, np.asarray(rgb, np.float32), name))

    backend = _backend() if save is None else "matplotlib"
    if backend == "open3d":
        _show_open3d(prepared)
    elif backend == "plotly":
        _show_plotly(prepared, title)
    else:
        _show_matplotlib(prepared, save, title)


def _show_matplotlib(clouds, save, title):
    import matplotlib

    if save is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for xyz, rgb, name in clouds:
        if len(xyz) == 0:
            continue
        ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], c=np.clip(rgb, 0, 1),
                   s=2, label=name)
    ax.set_title(title)
    if any(name for _, _, name in clouds):
        ax.legend()
    if save is not None:
        fig.savefig(save, dpi=120)
        plt.close(fig)
        print(f"saved {save}")
    else:
        plt.show()


def _show_plotly(clouds, title):
    import plotly.graph_objects as go

    traces = []
    for xyz, rgb, name in clouds:
        colors = [f"rgb({int(r*255)},{int(g*255)},{int(b*255)})" for r, g, b in rgb]
        traces.append(
            go.Scatter3d(
                x=xyz[:, 0], y=xyz[:, 1], z=xyz[:, 2], mode="markers",
                marker=dict(size=2, color=colors), name=name,
            )
        )
    go.Figure(data=traces, layout=go.Layout(title=title)).show()


def _show_open3d(clouds):
    import open3d as o3d

    geoms = []
    for xyz, rgb, _ in clouds:
        pc = o3d.geometry.PointCloud()
        pc.points = o3d.utility.Vector3dVector(xyz.astype(np.float64))
        pc.colors = o3d.utility.Vector3dVector(np.clip(rgb, 0, 1).astype(np.float64))
        geoms.append(pc)
    o3d.visualization.draw_geometries(geoms)
