"""Global configuration (port of pointcloud_tpu/cfg.py:15-37).

Importing this module sets PyTorch's float32 matmul and cuDNN convolution
precision to full fp32 (TF32 off). A float32 matmul on the card already runs
in full fp32 by default, but a float32 convolution runs in TF32, which keeps
about three decimal digits; the port states both so that its fp32 paths (the
Chamfer cross term, the fp32 decoder head, the parity checks) mean fp32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# 'bf16-mixed': params and BN statistics fp32, activations and matmuls bf16
# on the card. 'fp32' forces full precision everywhere.
precision = "bf16-mixed"

vision_lr = 1e-3  # Adam's learning rate (pointcloud_tpu/cfg.py:49)


def compute_dtype(device) -> torch.dtype | None:
    """Model activation dtype implied by `precision` on `device`.

    torch.bfloat16 on a CUDA device under 'bf16-mixed'; None (fp32, the
    parameters' own dtype) on the CPU, where the parity tests expect exact
    fp32 numerics.
    """
    if precision == "bf16-mixed" and torch.device(device).type == "cuda":
        return torch.bfloat16
    return None
