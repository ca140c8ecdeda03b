#!/usr/bin/env python
"""Inspect one npz dataset frame, split by class, with the PyTorch port
(mirror of pc_viewer.py; reference pc_viewer.py:10-60).

The class split runs on --device (default cuda; --device cpu on the CPU);
the frame is drawn by viewers.plot (matplotlib for --save, which must be
installed, else open3d or plotly where installed).

Usage: python pc_viewer_torch.py input/Cube/train/0.npz [--save out.png]
       [--device cuda]
"""

import argparse

import numpy as np
import torch

from pointcloud_tpu_torch.utils import resolve_device
from pointcloud_tpu_torch.viewers import check_plotting
from pointcloud_tpu_torch.viewers.plot import show_clouds


def main():
    p = argparse.ArgumentParser()
    p.add_argument("file", type=str, help=".npz frame to inspect")
    p.add_argument("--save", default=None, help="save a PNG instead of showing")
    p.add_argument("--by_class", action="store_true", default=True)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the class split runs on")
    a = p.parse_args()

    check_plotting(a.save)
    device = resolve_device(a.device)
    data = np.load(a.file, allow_pickle=True)
    points = data["points"]
    rgb = data.get("rgb", np.full_like(points, 0.5))
    clouds = []
    if "segmentation" in data and "classes" in data:
        pts = torch.as_tensor(points, device=device)
        labels = torch.as_tensor(data["segmentation"][:, 0], device=device).long()
        for idx, (name, color) in enumerate(data["classes"]):
            sel = labels == idx
            n = int(sel.sum())
            print(f"class {idx} {name}: {n} points ({n / len(labels):.1%})")
            if n:
                clouds.append((pts[sel].cpu().numpy(),
                               np.tile(np.asarray(color, np.float32), (n, 1)), name))
    else:
        clouds.append((points, rgb, "cloud"))
    if "ground_truth" in data:
        from pointcloud_tpu_torch.viewers.reconstruct import aa_lines

        for name, value in data["ground_truth"]:
            v = np.asarray(value)
            if v.shape == (3,):
                pts, cols = aa_lines(v, [0, 1, 0])
                clouds.append((pts, cols, f"gt:{name}"))
    show_clouds(clouds, mode="overlap", save=a.save, title=a.file)


if __name__ == "__main__":
    main()
