"""Fused Chamfer backward: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_chamfer_bwd_kernel
(`chamfer_nn_bwd_pallas`). The kernel is csrc/chamfer_bwd.cu; its note
states the design and the bound. `chamfer_bwd` launches it for CUDA tensors
and takes the plain version `chamfer_bwd_reference` only for CPU tensors.

Both compute, from clouds x (B, N, C), y (B, M, C), the cotangents gx (B, N),
gy (B, M) of the nearest-neighbour distances (zero on masked rows) and the
argmins amin_x (B, N), amin_y (B, M):

    tx = 2 gx (x - y[amin_x])          ty = 2 gy (y - x[amin_y])
    dx = tx - segsum(ty -> amin_y)     dy = ty - segsum(tx -> amin_x)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops.scatter_rows import scatter_rows_reference

MAX_DIMS = 8  # C <= 8, as the TPU kernel
_MAX_BATCH = 65535  # gridDim.y
_MAX_POINTS = 1 << 27  # keeps every int32 offset (point * C) in range


def gather_rows(src, idx):
    """src[b, idx[b, i]] for src (B, S, C) and idx (B, I): (B, I, C)."""
    return torch.gather(src, 1, idx.long()[..., None].expand(-1, -1, src.shape[2]))


def nn_terms(x, y, gx, gy, amin_x, amin_y):
    """(tx, ty): each point's own term, rows aligned to x and to y."""
    tx = 2.0 * gx[..., None] * (x - gather_rows(y, amin_x))
    ty = 2.0 * gy[..., None] * (y - gather_rows(x, amin_y))
    return tx, ty


def chamfer_bwd_reference(x, y, gx, gy, amin_x, amin_y):
    """Plain PyTorch version: the JAX package's composition path (gathers +
    segment-sums, chamfer.py:133-138) with `scatter_rows_reference`."""
    tx, ty = nn_terms(x, y, gx, gy, amin_x, amin_y)
    dx = scatter_rows_reference(-ty, amin_y, x.shape[1], init=tx)
    dy = scatter_rows_reference(-tx, amin_x, y.shape[1], init=ty)
    return dx, dy


@functools.cache
def _launcher():
    fn = _build.load("chamfer_bwd").chamfer_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chamfer_bwd(x, y, gx, gy, amin_x, amin_y):
    """(dx (B, N, C), dy (B, M, C)) fp32, as the module docstring says.

    CPU tensors take the plain version. CUDA tensors launch the kernel, which
    takes contiguous fp32 clouds and cotangents, int32 argmins in range and
    1 <= C <= 8, and gives the same bits on every run; anything else raises.
    `chamfer_bwd.launches` counts the kernel's launches.
    """
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != y.shape[2]:
        raise ValueError(f"chamfer_bwd takes x (B, N, C) and y (B, M, C); got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    B, N, C = x.shape
    M = y.shape[1]
    for name, t, shape in (("gx", gx, (B, N)), ("gy", gy, (B, M)),
                           ("amin_x", amin_x, (B, N)), ("amin_y", amin_y, (B, M))):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    tensors = (x, y, gx, gy, amin_x, amin_y)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"chamfer_bwd inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return chamfer_bwd_reference(x, y, gx, gy, amin_x, amin_y)
    if device.type != "cuda":
        raise ValueError(f"chamfer_bwd runs on CPU or CUDA tensors, not {device}")
    if any(t.dtype != torch.float32 for t in (x, y, gx, gy)) \
            or amin_x.dtype != torch.int32 or amin_y.dtype != torch.int32:
        raise TypeError("chamfer_bwd kernel takes fp32 clouds and cotangents "
                        "and int32 argmins")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("chamfer_bwd kernel takes contiguous tensors")
    if not 1 <= C <= MAX_DIMS:
        raise ValueError(f"chamfer_bwd kernel takes 1 <= C <= {MAX_DIMS}; got {C}")
    if not (1 <= B <= _MAX_BATCH and 1 <= N <= _MAX_POINTS
            and 1 <= M <= _MAX_POINTS):
        raise ValueError(f"chamfer_bwd kernel bounds exceeded: B={B} N={N} M={M}")

    dx = torch.empty_like(x)
    dy = torch.empty_like(y)
    # sort scratch: x-point buckets of the y rows, y-point buckets of the x rows
    end_x, perm_x = (torch.empty((B, N), dtype=torch.int32, device=device)
                     for _ in range(2))
    end_y, perm_y = (torch.empty((B, M), dtype=torch.int32, device=device)
                     for _ in range(2))
    launch = _launcher()
    with torch.cuda.device(device):
        err = launch(
            x.data_ptr(), y.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            amin_x.data_ptr(), amin_y.data_ptr(), dx.data_ptr(), dy.data_ptr(),
            end_x.data_ptr(), perm_y.data_ptr(), end_y.data_ptr(),
            perm_x.data_ptr(), B, N, M, C,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"chamfer_bwd kernel launch failed: CUDA error {err}")
    chamfer_bwd.launches += 1
    return dx, dy


chamfer_bwd.launches = 0
