#!/usr/bin/env python
"""Convert a JAX package train() checkpoint to the PyTorch port's format.

Usage: python convert_checkpoint_torch.py <jax step_N dir> <out checkpoints dir>
       <model> [--backbone PointNet2] [--scene Cube] [--loss chamfer|emd]

Reads the orbax step_N directory that `python train.py` wrote (this needs
JAX and orbax, so it runs where the JAX package does) and writes
<out checkpoints dir>/step_N/checkpoint.pt, which
`python train_torch.py ... --ckpt <out checkpoints dir>/step_N` resumes
from: weights, running statistics, Adam's moments and step count, epoch.
"""

import argparse
import os


def convert(jax_step_dir: str, out_dir: str, model_type: str, backbone: str,
            scene: str, loss_override: str | None = None) -> str:
    """Convert one checkpoint; returns the port's step_N directory."""
    from pointcloud_tpu.train.harness import load_checkpoint_raw
    from pointcloud_tpu_torch.interop import checkpoint_from_jax
    from pointcloud_tpu_torch.train.harness import save_checkpoint

    payload = load_checkpoint_raw(jax_step_dir)
    ckpt = checkpoint_from_jax(payload, model_type, backbone, scene, loss_override)
    return save_checkpoint(out_dir, ckpt["epoch"], ckpt)


def main():
    from pointcloud_tpu_torch import cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("jax_ckpt", help="the JAX run's checkpoints/step_N directory")
    ap.add_argument("out_dir", help="checkpoints directory to write step_N into")
    ap.add_argument("model", choices=cfg.models)
    ap.add_argument("--backbone", choices=cfg.encoder_backbones, default="PointNet2")
    ap.add_argument("--scene", default="Cube")
    ap.add_argument("--loss", default=None, choices=[None, "chamfer", "emd"],
                    help="the loss override the JAX run trained with")
    a = ap.parse_args()
    path = convert(os.path.abspath(a.jax_ckpt), a.out_dir, a.model, a.backbone,
                   a.scene, a.loss)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
