#!/usr/bin/env python
"""Step a validation dataset through a trained model of the PyTorch port and
view reconstruction vs ground truth (mirror of ae_viewer.py; reference
ae_viewer.py:14-220).

Default is the reference's interactive mode: left/right arrows step the val
set, the prediction morphs between reconstructions (lerp animation), 'm'
toggles overlap/side-by-side, i/o toggle GT/prediction visibility (open3d
window when open3d is installed, matplotlib otherwise). --save renders one
static snapshot headlessly instead (matplotlib). The model runs on --device
(default cuda; --device cpu on the CPU) from the port's checkpoints under
--output_root.

Usage: python ae_viewer_torch.py Cube Autoencoder --backbone PointNet
       [--index 0] [--mode overlap|side-by-side] [--save out.png]
       [--animation_speed 0.1] [--input_root input] [--output_root output]
       [--device cuda]
"""

import argparse

from pointcloud_tpu_torch import cfg


def main():
    p = argparse.ArgumentParser()
    p.add_argument("scene", type=str)
    p.add_argument("model", choices=cfg.models)
    p.add_argument("--backbone", default="PointNet2", choices=cfg.encoder_backbones)
    p.add_argument("--index", type=int, default=0, help="val sample index")
    p.add_argument("--mode", default="overlap", choices=["overlap", "side-by-side"])
    p.add_argument("--save", default=None,
                   help="headless: write one PNG instead of the window")
    p.add_argument("--animation_speed", default=0.1, type=float,
                   help="reconstruction morph speed (reference default 0.1)")
    p.add_argument("--version", default=None, type=int)
    p.add_argument("--input_root", default="input")
    p.add_argument("--output_root", default="output")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the model runs on")
    a = p.parse_args()

    import os

    from pointcloud_tpu_torch.envs.scenes import cfg_scene
    from pointcloud_tpu_torch.transforms import Normalize, apply_np
    from pointcloud_tpu_torch.viewers import check_plotting, require_matplotlib
    from pointcloud_tpu_torch.viewers.plot import show_clouds
    from pointcloud_tpu_torch.viewers.reconstruct import (
        assemble_prediction,
        load_viewer_model,
    )

    if a.save is not None:
        check_plotting(a.save)
    else:
        try:
            import open3d  # noqa: F401
        except ImportError:
            require_matplotlib()  # the interactive window's fallback
    spec, _ = load_viewer_model(
        a.scene, a.model, a.backbone, a.version, a.output_root, device=a.device
    )
    val_dir = os.path.join(a.input_root, a.scene, "val")
    ds = spec.open_dataset(val_dir)
    norm = Normalize(spec.scene.bbox)

    def load(index):
        in_pc, target = ds[index]
        in_pc = apply_np(norm, in_pc)[0]
        if not spec.dict_target:
            target = apply_np(norm, target)[0]
        return assemble_prediction(
            a.model, spec, None, in_pc, target,
            class_colors=cfg_scene[a.scene]["class_colors"],
        )

    if a.save is not None:  # headless one-shot snapshot (CI path)
        pred_xyz, pred_rgb, gt_xyz, gt_rgb = load(a.index)
        show_clouds(
            [(pred_xyz, pred_rgb, "prediction"),
             (gt_xyz, gt_rgb, "ground truth")],
            mode=a.mode,
            save=a.save,
            title=f"{a.scene} {a.model}_{a.backbone} val[{a.index}]",
        )
        return

    from pointcloud_tpu_torch.viewers.interactive import (
        ReconViewerCore,
        run_interactive,
    )

    core = ReconViewerCore(
        load, len(ds), mode=a.mode, animation_speed=a.animation_speed
    )
    core.index = a.index % len(ds)
    if a.index:
        core._load()
    run_interactive(core, title=f"{a.scene} {a.model}_{a.backbone}")


if __name__ == "__main__":
    main()
