"""Fused Dense -> BatchNorm statistics -> signed block max-pool, forward and
backward: CUDA kernels, plain version, wrappers.

Port of pointcloud_tpu/ops/dense_bn_pool.py (`dense_pool_stats`, its
`_fwd_kernel` and `_bwd_kernel`). The kernels are csrc/dense_bn_pool.cu; its
note states the design and the bound. The pre-pool Dense output z of a
1024-wide PointNet layer feeds only the BatchNorm statistics and the
max-pool, so the kernels never store it (nor its gradient) in device memory.

`dense_pool_stats` takes the plain version `dense_pool_stats_reference`
(gradients from autograd) only for CPU tensors; for CUDA tensors it runs the
forward kernel, and its backward runs `dense_pool_stats_bwd`, the backward
kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointcloud_tpu_torch.ops import _build

_FWD_CHUNK_ROWS = 512  # rows a forward block owns (csrc/dense_bn_pool.cu)
_DW_CHUNKS = 64  # at most this many row chunks of dw partials
_TILE_ROWS = 64
_MAX_ROWS = 65535 * _TILE_ROWS  # gridDim.y of the dx launch


def dense_pool_stats_reference(x, w, bias, sign, pen, pool: int):
    """Plain PyTorch version of `dense_pool_stats` (a port of
    pointcloud_tpu/ops/dense_bn_pool.py:401-425), with the kernel's single
    rounding: z is the fp32 accumulation plus the bias, rounded once to
    x.dtype. The pool is torch.max, whose index is the first maximum and
    whose backward routes to that index."""
    B, R, _ = x.shape
    C = w.shape[1]
    z = (torch.matmul(x.float(), w.float()) + bias.float()).to(x.dtype)
    zf = z.float()
    ssum = zf.sum(dim=(0, 1))
    ssq = (zf * zf).sum(dim=(0, 1))
    zs = zf * sign
    if pen is not None:
        zs = zs - pen[..., None]
    psel, asel = torch.max(zs.reshape(B, R // pool, pool, C), dim=2)
    return psel.to(x.dtype), asel.int(), ssum, ssq


def _check(x, w, bias, sign, pen, pool):
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[2] \
            or bias.shape != (w.shape[1],) or sign.shape != (w.shape[1],):
        raise ValueError(
            f"dense_pool_stats takes x (B, R, Cin), w (Cin, C), bias (C,), "
            f"sign (C,); got {tuple(x.shape)}, {tuple(w.shape)}, "
            f"{tuple(bias.shape)}, {tuple(sign.shape)}")
    B, R, _ = x.shape
    if pen is not None and pen.shape != (B, R):
        raise ValueError(f"pen must be {(B, R)}; got {tuple(pen.shape)}")
    if pool < 1 or R % pool:
        raise ValueError(f"pool must divide R = {R}; got {pool}")
    devices = {t.device for t in (x, w, bias, sign, pen) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"dense_pool_stats inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_pool_stats runs on CPU or CUDA tensors, not {device}")
    return device


def _check_kernel_inputs(x, w, bias, sign, pen):
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype \
            or bias.dtype != x.dtype or sign.dtype != torch.float32 \
            or (pen is not None and pen.dtype != torch.float32):
        raise TypeError(
            f"dense_pool_stats kernels take x, w, bias all fp32 or all bf16 and "
            f"fp32 sign and pen; got {x.dtype}, {w.dtype}, {bias.dtype}, "
            f"{sign.dtype}, {None if pen is None else pen.dtype}")
    if not all(t.is_contiguous() for t in (x, w, bias, sign, pen) if t is not None):
        raise ValueError("dense_pool_stats kernels take contiguous tensors")
    rows = x.shape[0] * x.shape[1]
    if not 1 <= rows <= _MAX_ROWS or w.shape[1] < 1 or w.shape[0] < 1:
        raise ValueError(f"dense_pool_stats kernel bounds exceeded: rows={rows} "
                         f"Cin={w.shape[0]} C={w.shape[1]}")


@functools.cache
def _launchers():
    lib = _build.load("dense_bn_pool")
    fwd = lib.dense_pool_stats_fwd_launch
    fwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.dense_pool_stats_bwd_launch
    bwd.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dw_chunk_rows(rows: int) -> int:
    """Rows per dw block: whole 64-row tiles, at most _DW_CHUNKS chunks."""
    per = -(-rows // _DW_CHUNKS)
    return -(-per // _TILE_ROWS) * _TILE_ROWS


def _forward_kernel(x, w, bias, sign, pen, pool):
    B, R, Cin = x.shape
    C = w.shape[1]
    rows = B * R
    dev = x.device
    n_chunks = -(-rows // _FWD_CHUNK_ROWS)
    psel = torch.empty((B, R // pool, C), dtype=x.dtype, device=dev)
    asel = torch.empty((B, R // pool, C), dtype=torch.int32, device=dev)
    stats = torch.empty((2, C), dtype=torch.float32, device=dev)
    keys = torch.empty((rows // pool, C), dtype=torch.int64, device=dev)
    part = torch.empty((n_chunks, 2, C), dtype=torch.float32, device=dev)
    fwd, _ = _launchers()
    with torch.cuda.device(dev):
        err = fwd(
            _ptr(x), _ptr(w), _ptr(bias), _ptr(sign), _ptr(pen), _ptr(psel),
            _ptr(asel), _ptr(stats), _ptr(keys), _ptr(part), rows, Cin, C,
            pool, _FWD_CHUNK_ROWS, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_pool_stats kernel launch failed: CUDA error {err}")
    dense_pool_stats.launches += 1
    return psel, asel, stats[0], stats[1]


def dense_pool_stats_bwd(x, w, bias, sign, asel, dpsel, dssum, dssq, pool: int):
    """The backward kernel of `dense_pool_stats` on CUDA tensors: rebuilds
    dz = dssum + 2 dssq z + sign * sparse(asel, dpsel) from the same rounded
    z, casts it to x.dtype, and returns (dx in x.dtype, dw (Cin, C) fp32,
    db (C,) fp32). Takes what the forward kernel takes plus asel (B, R/pool,
    C) int32 and fp32 cotangents; anything else raises.
    `dense_pool_stats_bwd.launches` counts its launches."""
    device = _check(x, w, bias, sign, None, pool)
    if device.type != "cuda":
        raise ValueError("dense_pool_stats_bwd is the CUDA kernel; CPU tensors "
                         "take autograd through dense_pool_stats_reference")
    _check_kernel_inputs(x, w, bias, sign, None)
    B, R, Cin = x.shape
    C = w.shape[1]
    pooled = (B, R // pool, C)
    if asel.shape != pooled or dpsel.shape != pooled or dssum.shape != (C,) \
            or dssq.shape != (C,):
        raise ValueError("dense_pool_stats_bwd: asel/dpsel must be "
                         f"{pooled} and dssum/dssq ({C},)")
    if asel.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (dpsel, dssum, dssq)):
        raise TypeError("dense_pool_stats_bwd takes int32 asel and fp32 cotangents")
    if not all(t.is_contiguous() for t in (asel, dpsel, dssum, dssq)) \
            or {t.device for t in (asel, dpsel, dssum, dssq)} != {device}:
        raise ValueError("dense_pool_stats_bwd takes contiguous tensors on x's device")
    rows = B * R
    chunk = _dw_chunk_rows(rows)
    n_chunks = -(-rows // chunk)
    dx = torch.empty_like(x)
    dw = torch.empty((Cin, C), dtype=torch.float32, device=device)
    db = torch.empty((C,), dtype=torch.float32, device=device)
    dw_part = torch.empty((n_chunks, Cin, C), dtype=torch.float32, device=device)
    db_part = torch.empty((n_chunks, C), dtype=torch.float32, device=device)
    _, bwd = _launchers()
    with torch.cuda.device(device):
        err = bwd(
            _ptr(x), _ptr(w), _ptr(bias), _ptr(sign), _ptr(asel), _ptr(dpsel),
            _ptr(dssum), _ptr(dssq), _ptr(dx), _ptr(dw), _ptr(db),
            _ptr(dw_part), _ptr(db_part), rows, Cin, C, pool, chunk,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dense_pool_stats_bwd kernel launch failed: CUDA error {err}")
    dense_pool_stats_bwd.launches += 1
    return dx, dw, db


dense_pool_stats_bwd.launches = 0


class _DensePoolStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, sign, pen, pool):
        psel, asel, ssum, ssq = _forward_kernel(x, w, bias, sign, pen, pool)
        # x and asel only: z is rebuilt by the backward kernel, never kept
        ctx.save_for_backward(x, w, bias, sign, asel)
        ctx.pool = pool
        ctx.mark_non_differentiable(asel)
        return psel, asel, ssum, ssq

    @staticmethod
    def backward(ctx, dpsel, dasel, dssum, dssq):
        del dasel
        x, w, bias, sign, asel = ctx.saved_tensors
        dx, dw, db = dense_pool_stats_bwd(
            x, w, bias, sign, asel, dpsel.float().contiguous(),
            dssum.float().contiguous(), dssq.float().contiguous(), ctx.pool)
        # autograd casts dw and db to the dtype of w and bias, as the JAX
        # package's backward does (dense_bn_pool.py:387-388)
        return dx, dw, db, None, None, None


def dense_pool_stats(x, w, bias, sign, pen, pool: int):
    """Fused Dense -> BN statistics -> signed block max-pool.

    x (B, R, Cin), w (Cin, C), bias (C,) in one dtype (fp32 or bf16 on the
    card), sign (C,) fp32 in {+1, -1}, pen (B, R) fp32 (+1e9 on masked rows)
    or None, pool: block size (R % pool == 0). With z = x @ w + bias
    accumulated in fp32 and rounded once to x.dtype, returns
      psel (B, R/pool, C) x.dtype: per-block max of sign*z - pen (the
        caller's selected extremum is sign * psel);
      asel (B, R/pool, C) int32: its lowest index in the block
        (non-differentiable);
      ssum, ssq (C,) fp32: sums of z and z^2 over all B*R rows.
    Gradients flow to x, w and bias, from psel, ssum and ssq.

    CPU tensors take the plain version; CUDA tensors run the kernels
    (`dense_pool_stats.launches` counts the forward's launches,
    `dense_pool_stats_bwd.launches` the backward's); anything the kernels do
    not take raises.
    """
    device = _check(x, w, bias, sign, pen, pool)
    if device.type == "cpu":
        return dense_pool_stats_reference(x, w, bias, sign, pen, pool)
    _check_kernel_inputs(x, w, bias, sign, pen)
    return _DensePoolStats.apply(x, w, bias, sign, pen, pool)


dense_pool_stats.launches = 0
