"""Global configuration (port of pointcloud_tpu/cfg.py:15-99).

Importing this module sets PyTorch's float32 matmul and cuDNN convolution
precision to full fp32 (TF32 off). A float32 matmul on the card already runs
in full fp32 by default, but a float32 convolution runs in TF32, which keeps
about three decimal digits; the port states both so that its fp32 paths (the
Chamfer cross term, the fp32 decoder head, the parity checks) mean fp32.
"""

from __future__ import annotations

import dataclasses
import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# 'bf16-mixed': params and BN statistics fp32, activations and matmuls bf16
# on the card. 'fp32' forces full precision everywhere.
precision = "bf16-mixed"

# More verbose output and sanity checks (they synchronise the device).
debug = bool(int(os.environ.get("PCTPU_DEBUG", "0")))

# Vision models and training (pointcloud_tpu/cfg.py:44-59).

models = ["Autoencoder", "Segmenter", "MultiSegmenter", "StatePredictor"]
encoder_backbones = ["PointNet", "PointNet2", "PointMLP", "PointMLPE"]

vision_batch_size = 25
vision_epochs = 100
vision_lr = 1e-3  # Adam's learning rate
val_every = 4  # train scalars to TensorBoard every n steps
ckpt_every = 10  # checkpoint every n epochs (plus the final epoch)

# Host-side data pipeline: batches staged ahead of the train loop, and the
# threads that decode npz files.
prefetch_batches = 2
loader_threads = 6
# Read npz batches with the native C++ loader (native/pcloader.cpp, built
# into build/ on first use) where the dataset qualifies. train() raises if the
# library does not build or load; set False to choose the threaded
# Python BatchLoader instead.
use_native_loader = True

# Earth Mover's Distance operating points (pointcloud_tpu/cfg.py:62-77).
emd_eps = 0.005  # training: constant temperature
emd_iterations = 50
# The reference's test operating point, kept for parity experiments.
emd_test_eps = 0.002
emd_test_iterations = 10000
# Eval default: Sinkhorn annealed geometrically from emd_anneal_from to
# emd_eval_eps reaches the test point's matching in ~60 iterations.
emd_eval_eps = 0.002
emd_eval_iterations = 60
emd_anneal_from = 0.1
# EMD backend: 'sinkhorn' (entropic OT, the kernel of ops/sinkhorn.py) or
# 'auction' (the deterministic reformulation of the reference CUDA auction).
emd_method = "sinkhorn"


def compute_dtype(device) -> torch.dtype | None:
    """Model activation dtype implied by `precision` on `device`.

    torch.bfloat16 on a CUDA device under 'bf16-mixed'; None (fp32, the
    parameters' own dtype) on the CPU, where the parity tests expect exact
    fp32 numerics.
    """
    if precision == "bf16-mixed" and torch.device(device).type == "cuda":
        return torch.bfloat16
    return None


@dataclasses.dataclass
class TrainConfig:
    """Typed view of the training knobs for library code."""

    batch_size: int = vision_batch_size
    epochs: int = vision_epochs
    lr: float = vision_lr
    val_every: int = val_every
    precision: str = precision
    seed: int = 0

    @classmethod
    def from_globals(cls) -> "TrainConfig":
        return cls(
            batch_size=vision_batch_size,
            epochs=vision_epochs,
            lr=vision_lr,
            val_every=val_every,
            precision=precision,
        )
