"""Bidirectional nearest-neighbour sweep: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_nn_kernel
(`nearest_neighbor_pallas`). The kernel is csrc/nn_sweep.cu; its note states
the design and the bound. `nn_sweep` launches it for CUDA tensors and takes
the plain version `nn_sweep_reference` only for CPU tensors.

Both return (min_x (B,N) f32, amin_x (B,N) i32, min_y (B,M) f32,
amin_y (B,M) i32): each point's squared distance to its nearest valid
counterpart over all C dims and that counterpart's first index. A point with
no valid counterpart gets 1e10 and index 0; a masked point gets +1e10 on its
own value, as the TPU kernel's +BIG on s2/d2 does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops.geometry import _BIG, pairwise_sqdist

MAX_DIMS = 8  # C <= 8, as the TPU kernel
_MAX_BATCH = 65535  # gridDim.y
_MAX_POINTS = 1 << 30  # keeps every int32 index and offset in range


def nn_sweep_reference(x, y, x_mask=None, y_mask=None):
    """Plain PyTorch version: the dense path of pointcloud_tpu's
    chamfer._nn_forward (pairwise_sqdist + where + min/argmin), plus the
    kernel's +1e10 on masked points' own values."""
    d = pairwise_sqdist(x, y)  # (B, N, M)
    d_for_x = d if y_mask is None else d.masked_fill(~y_mask[:, None, :], _BIG)
    min_x, amin_x = torch.min(d_for_x, dim=2)  # first minimal index on ties
    del d_for_x  # a masked copy is freed before the next one
    d_for_y = d if x_mask is None else d.masked_fill(~x_mask[:, :, None], _BIG)
    min_y, amin_y = torch.min(d_for_y, dim=1)
    if x_mask is not None:
        min_x = torch.where(x_mask, min_x, min_x + _BIG)
    if y_mask is not None:
        min_y = torch.where(y_mask, min_y, min_y + _BIG)
    return min_x, amin_x.int(), min_y, amin_y.int()


@functools.cache
def _launcher():
    fn = _build.load("nn_sweep").nn_sweep_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, y, x_mask, y_mask):
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != y.shape[2]:
        raise ValueError(
            f"nn_sweep takes x (B, N, C) and y (B, M, C); got "
            f"{tuple(x.shape)} and {tuple(y.shape)}"
        )
    for name, mask, cloud in (("x_mask", x_mask, x), ("y_mask", y_mask, y)):
        if mask is not None and (mask.dtype != torch.bool
                                 or mask.shape != cloud.shape[:2]):
            raise ValueError(
                f"{name} must be bool of shape {tuple(cloud.shape[:2])}; got "
                f"{mask.dtype} {tuple(mask.shape)}"
            )
    devices = {t.device for t in (x, y, x_mask, y_mask) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"nn_sweep inputs lie on several devices: {devices}")
    return devices.pop()


def nn_sweep(x, y, x_mask=None, y_mask=None):
    """Nearest-neighbour sweep of x (B, N, C) against y (B, M, C), with
    optional bool validity masks (B, N) / (B, M).

    CPU tensors take the plain version. CUDA tensors launch the kernel, which
    takes contiguous fp32 clouds with 1 <= C <= 8; anything else raises.
    `nn_sweep.launches` counts the kernel's launches.
    """
    device = _check(x, y, x_mask, y_mask)
    if device.type == "cpu":
        return nn_sweep_reference(x, y, x_mask, y_mask)
    if device.type != "cuda":
        raise ValueError(f"nn_sweep runs on CPU or CUDA tensors, not {device}")
    B, N, C = x.shape
    M = y.shape[1]
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"nn_sweep kernel takes fp32; got {x.dtype}, {y.dtype}")
    if not all(t.is_contiguous() for t in (x, y, x_mask, y_mask)
               if t is not None):
        raise ValueError("nn_sweep kernel takes contiguous tensors")
    if not 1 <= C <= MAX_DIMS:
        raise ValueError(f"nn_sweep kernel takes 1 <= C <= {MAX_DIMS}; got {C}")
    if not (1 <= B <= _MAX_BATCH and 1 <= N <= _MAX_POINTS
            and 1 <= M <= _MAX_POINTS):
        raise ValueError(f"nn_sweep kernel bounds exceeded: B={B} N={N} M={M}")

    min_x = torch.empty((B, N), dtype=torch.float32, device=device)
    amin_x = torch.empty((B, N), dtype=torch.int32, device=device)
    min_y = torch.empty((B, M), dtype=torch.float32, device=device)
    amin_y = torch.empty((B, M), dtype=torch.int32, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch = _launcher()
    with torch.cuda.device(device):  # the library launches on the current one
        err = launch(
            ptr(x), ptr(y), ptr(x_mask), ptr(y_mask),
            ptr(min_x), ptr(amin_x), ptr(min_y), ptr(amin_y),
            B, N, M, C, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_sweep kernel launch failed: CUDA error {err}")
    nn_sweep.launches += 1
    return min_x, amin_x, min_y, amin_y


nn_sweep.launches = 0
