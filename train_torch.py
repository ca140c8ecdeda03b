#!/usr/bin/env python
"""Train a vision model with the PyTorch port (CLI mirror of train.py).

Usage: python train_torch.py <scene> <model> [--backbone PointNet2] [--epochs N]
       [--batch_size N] [--ckpt path] [--scene_dir dir] [--loss chamfer|emd]
       [--input_root input] [--output_root output] [--profile] [--device cuda]
       [--multihost]

Reads input/<scene_dir>/{train,val}/*.npz and writes TensorBoard logs and
checkpoints under output/<scene_dir>/<model>_<backbone>/version_N. One
device; `--device cpu` trains on the CPU.

Data-parallel training, one process a device, on one host or several:

    torchrun --nproc_per_node 4 train_torch.py Cube Autoencoder --multihost

or the same variables by hand in each process (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK and, on a card, LOCAL_RANK). `--multihost` joins the
process group (NCCL on the card, gloo with `--device cpu`) before any CUDA
work; --batch_size is the global batch and must divide the ranks.
"""

import argparse
import sys

from pointcloud_tpu_torch import cfg
from pointcloud_tpu_torch.parallel import initialize
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
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group (MASTER_ADDR, MASTER_PORT, "
                             "WORLD_SIZE, RANK, as torchrun sets them) and train "
                             "data-parallel over its ranks; batch_size is global")
    a = parser.parse_args()

    if a.multihost:
        joined = initialize(device=a.device)
        if not joined:
            sys.exit("--multihost needs MASTER_ADDR and WORLD_SIZE (run it under "
                     "torchrun or set them)")
        print("multihost: joined the process group")

    try:
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
            multihost=a.multihost,
        )
    finally:
        if a.multihost:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
