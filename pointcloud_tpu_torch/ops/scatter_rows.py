"""Deterministic segment-sum of rows: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_scatter_kernel /
_scatter_kernel_init (`scatter_rows_pallas`). The kernel is
csrc/scatter_rows.cu; its note states the design and the bound.
`scatter_rows` launches it for CUDA tensors and takes the plain version
`scatter_rows_reference` only for CPU tensors.

The TPU kernel's `fold` argument is left out: it packs split-bf16 copies of
g so that the MXU can sum fp32 exactly, and the card's CUDA cores add fp32
directly. The function `init + segsum(g)` is the same.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointcloud_tpu_torch.ops import _build

_MAX_BATCH = 65535  # gridDim.y
_MAX_ELEMENTS = 1 << 30  # rows * C and n * C, keeps int32 offsets in range


def scatter_rows_reference(g, idx, n: int, init=None):
    """Plain PyTorch version: `init + segsum(g -> idx)` in fp32 through
    index_add_ (the JAX package's .at[].add path, chamfer.py:188-191)."""
    B, R, C = g.shape
    out = (torch.zeros((B, n, C), dtype=torch.float32, device=g.device)
           if init is None else init.float().clone())
    flat_idx = idx.long() + torch.arange(B, device=g.device)[:, None] * n
    out.view(B * n, C).index_add_(0, flat_idx.reshape(-1),
                                  g.float().reshape(B * R, C))
    return out


@functools.cache
def _launcher():
    fn = _build.load("scatter_rows").scatter_rows_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def scatter_rows(g, idx, n: int, init=None):
    """out[b, idx[b, r]] += g[b, r] for g (B, R, C) fp32 or bf16 and idx
    (B, R) int32, into (B, n, C) fp32 that starts from `init` (B, n, C)
    when one is given, else from zeros. Indices lie in [0, n).

    CPU tensors take the plain version. CUDA tensors launch the kernel, which
    takes contiguous tensors and gives the same bits on every run; anything
    else raises. `scatter_rows.launches` counts the kernel's launches.
    """
    if g.dim() != 3 or idx.shape != g.shape[:2]:
        raise ValueError(f"scatter_rows takes g (B, R, C) and idx (B, R); got "
                         f"{tuple(g.shape)} and {tuple(idx.shape)}")
    B, R, C = g.shape
    if init is not None and init.shape != (B, n, C):
        raise ValueError(f"init must be {(B, n, C)}; got {tuple(init.shape)}")
    devices = {t.device for t in (g, idx, init) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"scatter_rows inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return scatter_rows_reference(g, idx, n, init)
    if device.type != "cuda":
        raise ValueError(f"scatter_rows runs on CPU or CUDA tensors, not {device}")
    if g.dtype not in (torch.float32, torch.bfloat16) or idx.dtype != torch.int32 \
            or (init is not None and init.dtype != torch.float32):
        raise TypeError(f"scatter_rows kernel takes fp32/bf16 g, int32 idx and "
                        f"fp32 init; got {g.dtype}, {idx.dtype}, "
                        f"{None if init is None else init.dtype}")
    if not all(t.is_contiguous() for t in (g, idx, init) if t is not None):
        raise ValueError("scatter_rows kernel takes contiguous tensors")
    if not (1 <= B <= _MAX_BATCH and n >= 1 and C >= 1
            and R * C < _MAX_ELEMENTS and n * C < _MAX_ELEMENTS):
        raise ValueError(f"scatter_rows kernel bounds exceeded: B={B} R={R} "
                         f"n={n} C={C}")

    out = torch.empty((B, n, C), dtype=torch.float32, device=device)
    end = torch.empty((B, n), dtype=torch.int32, device=device)
    perm = torch.empty((B, R), dtype=torch.int32, device=device)
    launch = _launcher()
    with torch.cuda.device(device):
        err = launch(
            g.data_ptr(), int(g.dtype == torch.bfloat16), idx.data_ptr(),
            None if init is None else init.data_ptr(), out.data_ptr(),
            end.data_ptr(), perm.data_ptr(), B, R, n, C,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: CUDA error {err}")
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0
