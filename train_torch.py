#!/usr/bin/env python
"""Train a vision model with the PyTorch port (CLI mirror of train.py).

Usage: python train_torch.py <scene> <model> [--backbone PointNet2] [--epochs N]
       [--batch_size N] [--ckpt path] [--scene_dir dir] [--loss chamfer|emd]
       [--input_root input] [--output_root output] [--profile] [--device cuda]

Reads input/<scene_dir>/{train,val}/*.npz and writes TensorBoard logs and
checkpoints under output/<scene_dir>/<model>_<backbone>/version_N. One
device; `--device cpu` trains on the CPU.
"""

import argparse

from pointcloud_tpu_torch import cfg
from pointcloud_tpu_torch.train import train


def main():
    parser = argparse.ArgumentParser(description="Train or evaluate a vision module")
    parser.add_argument("scene", type=str)
    parser.add_argument("model", choices=cfg.models)
    parser.add_argument("--scene_dir", default=None, type=str,
                        help="dataset dir name under input/ (defaults to scene)")
    parser.add_argument("--backbone", choices=cfg.encoder_backbones, default="PointNet2")
    parser.add_argument("--batch_size", default=cfg.vision_batch_size, type=int)
    parser.add_argument("--epochs", default=cfg.vision_epochs, type=int)
    parser.add_argument("--ckpt", default=None, type=str,
                        help="checkpoint (a step_N directory) to resume from")
    parser.add_argument("--loss", default=None, choices=[None, "chamfer", "emd"],
                        help="override the model-type default loss")
    parser.add_argument("--input_root", default="input", type=str)
    parser.add_argument("--output_root", default="output", type=str)
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of steps 2-5")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train on (cuda, cuda:N or cpu)")
    a = parser.parse_args()

    train(
        a.model,
        a.backbone,
        scene=a.scene,
        epochs=a.epochs,
        batch_size=a.batch_size,
        ckpt_path=a.ckpt,
        dataset_dir=a.scene_dir,
        input_root=a.input_root,
        output_root=a.output_root,
        loss_override=a.loss,
        profile=a.profile,
        device=a.device,
    )


if __name__ == "__main__":
    main()
