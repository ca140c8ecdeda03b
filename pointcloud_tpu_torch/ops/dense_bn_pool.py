"""Fused Dense -> BatchNorm statistics -> signed block max-pool, forward and
backward: CUDA kernels, plain version, wrappers.

Port of pointcloud_tpu/ops/dense_bn_pool.py (`dense_pool_stats`, its
`_fwd_kernel` and `_bwd_kernel`). The kernels are csrc/dense_bn_pool.cu; its
note states the design and the bound. The pre-pool Dense output z of a
1024-wide PointNet layer feeds only the BatchNorm statistics and the
max-pool, so the kernels never store it (nor its gradient) in device memory.

`dense_pool_stats` takes the plain version `dense_pool_stats_reference`
(gradients from autograd) only for CPU tensors; for CUDA tensors it runs the
forward kernels on the route `pool_fwd_plan` picks from the shape and dtype,
and its backward runs `dense_pool_stats_bwd`, the backward kernels, on the
route `pool_bwd_plan` picks.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT, SMS, sm_count, split

_FWD_CHUNK_ROWS = 512  # rows a forward block owns on the tile route
_FWD_TILE = 64  # rows of a wgmma forward tile (csrc kFwdTile)
_FWD_STAGES = 6  # ring stages of the wgmma forward (csrc kFwdStages)
_DW_CHUNKS = 64  # at most this many row chunks of dw partials (tile route)
_TILE_ROWS = 64
_MAX_ROWS = 65535 * _TILE_ROWS  # gridDim.y of the tile route's dx launch
_DX_TILE = 128  # rows of a wgmma dx tile (a 64-row half each consumer)
_DW_STEP = 64  # rows of a wgmma dw step: the split-K granule
_DW_COLS = 128  # channels of C a wgmma dw block owns
_STAGES = 5  # ring stages of the wgmma launches (csrc kStages)
_WG_MAX_CIN = 128  # widest Cin the wgmma route takes (one accumulator tile)
_ROUTES = ("tile", "wgmma")  # csrc/dense_bn_pool.cu route codes


class PoolBwdPlan(NamedTuple):
    """Route and launch geometry of one `dense_pool_stats_bwd` call."""
    rows: int
    cin: int
    c: int
    pool: int
    route: str  # "wgmma" (TMA + wgmma, bf16) or "tile" (tile_mma.cuh)
    cin_pad: int  # wgmma: Cin rounded up to 64 or 128 (the dx tile's width)
    dx_chunk_rows: int  # rows a dx block walks (wgmma: whole 128-row tiles)
    dx_chunks: int
    dw_chunk_rows: int  # rows of a dw block's split-K chunk
    dw_chunks: int
    dx_smem: int  # wgmma: dynamic shared memory of a dx block, bytes
    dw_smem: int  # of a dw block


def _groups_met(window: int, pool: int) -> int:
    """Pool blocks that `window` rows from a multiple of `window` can meet:
    the rows of a ring stage's asel and dpsel tables."""
    return (window - 1) // pool + 2


def _dx_smem(cin_pad: int, c: int, pool: int) -> int:
    """csrc/dense_bn_pool.cu dx_smem_bytes: 1024 bytes of alignment slack;
    the struct (two slots of a 128-row x tile, _STAGES w chunks of cin_pad x
    64 bf16, 2 x 2 + 2 x _STAGES mbarriers; padded to 128 bytes); each
    stage's asel and dpsel tables (pool blocks met by 128 rows x 64 channels,
    4 bytes each); (bias, sign, dssum, 2 dssq) of every channel of C."""
    struct = 2 * _DX_TILE * cin_pad * 2 + _STAGES * cin_pad * 64 * 2 + (4 + 2 * _STAGES) * 8
    return (1024 + -(-struct // 128) * 128
            + _STAGES * 2 * _groups_met(_DX_TILE, pool) * 64 * 4 + 16 * c)


def _dw_smem(cin_pad: int, pool: int) -> int:
    """dw_smem_bytes: slack; the struct (_STAGES steps of 64 x cin_pad bf16,
    the block's w (two 64-channel atoms of cin_pad rows), dz (2 buffers x 2
    atoms of 64 x 64 bf16), the 128 channels' scalars, the db reduction
    (2 x 4 x 64 fp32), 2 _STAGES + 1 mbarriers; padded to 128 bytes); each
    stage's asel and dpsel tables (pool blocks met by 64 rows x 128
    channels)."""
    struct = (_STAGES * _DW_STEP * cin_pad * 2 + 2 * cin_pad * 64 * 2 + 2 * 2 * 64 * 64 * 2
              + 16 * _DW_COLS + 4 * 2 * 4 * 64 + (2 * _STAGES + 1) * 8)
    return (1024 + -(-struct // 128) * 128
            + _STAGES * 2 * _groups_met(_DW_STEP, pool) * _DW_COLS * 4)


@functools.lru_cache(maxsize=256)
def pool_bwd_plan(rows: int, cin: int, c: int, bf16: bool, pool: int,
                  sms: int = SMS) -> PoolBwdPlan:
    """The backward kernels' route and geometry for rows x (Cin -> C) in
    pool blocks of `pool` rows.

    bf16 with Cin <= 128 and Cin, C multiples of 8 (TMA reads 16-byte rows)
    whose shared memory fits the card at this pool (each ring stage carries
    the asel and dpsel of the pool blocks its rows meet: at PointNet's
    widths pools from 6 rows; every driven shape: PointNet's 128 -> 1024 at
    2048, the MSG branches' 32-128 -> 64-256 at 16-128) takes TMA + wgmma:
    dx blocks walk chunks of 128-row tiles, dw blocks own 128 channels of C
    over split-K chunks of 64-row steps, each launch in whole waves of one
    block an SM (`split`). fp32 (the card-vs-CPU checks), ragged widths,
    Cin > 128 and small pools take the tile route (64 x 128 tiles of
    tile_mma.cuh, at most _DW_CHUNKS dw chunks). Shapes no route takes (rows
    past the tile route's grid, empty widths, a pool that does not divide
    the rows) raise ValueError."""
    if not (1 <= rows <= _MAX_ROWS and cin >= 1 and c >= 1 and pool >= 1
            and rows % pool == 0):
        raise ValueError(f"dense_pool_stats kernel bounds exceeded: rows={rows} "
                         f"Cin={cin} C={c} pool={pool}")
    cin_pad = 64 if cin <= 64 else 128
    if bf16 and cin % 8 == 0 and c % 8 == 0 and cin <= _WG_MAX_CIN \
            and _dx_smem(cin_pad, c, pool) <= SMEM_LIMIT \
            and _dw_smem(cin_pad, pool) <= SMEM_LIMIT:
        dx_chunk, dx_chunks = split(rows, _DX_TILE, 1, sms)
        dw_chunk, dw_chunks = split(rows, _DW_STEP, -(-c // _DW_COLS), sms)
        return PoolBwdPlan(rows, cin, c, pool, "wgmma", cin_pad, dx_chunk, dx_chunks,
                           dw_chunk, dw_chunks, _dx_smem(cin_pad, c, pool),
                           _dw_smem(cin_pad, pool))
    per = -(-rows // _DW_CHUNKS)
    chunk = -(-per // _TILE_ROWS) * _TILE_ROWS
    return PoolBwdPlan(rows, cin, c, pool, "tile", 0, _TILE_ROWS, -(-rows // _TILE_ROWS),
                       chunk, -(-rows // chunk), 0, 0)


class PoolFwdPlan(NamedTuple):
    """Route and launch geometry of one `dense_pool_stats` forward call."""
    rows: int
    cin: int
    c: int
    pool: int
    route: str  # "wgmma" (TMA + wgmma, bf16) or "tile" (tile_mma.cuh)
    cin_pad: int  # wgmma: Cin rounded up to 64 or 128 (the x tile's width)
    chunk_rows: int  # rows a block walks (wgmma: whole pool blocks and tiles)
    chunks: int
    col_blocks: int  # blocks across C (128 channels each)
    smem: int  # wgmma: dynamic shared memory of a block, bytes


def _fwd_smem(cin_pad: int) -> int:
    """csrc/dense_bn_pool.cu fwd_smem_bytes: 1024 bytes of alignment slack;
    the struct (_FWD_STAGES x tiles of 64 rows x cin_pad bf16, the block's w
    (two 64-channel atoms of cin_pad rows), the pool reductions' value and
    row (2 parities x 2 consumers x 4 warps x 64 channels, 4 bytes each),
    the column sums (2 consumers x 4 warps x 2 x 64 fp32), 2 _FWD_STAGES + 1
    mbarriers; padded to 128 bytes)."""
    struct = (_FWD_STAGES * _FWD_TILE * cin_pad * 2 + 2 * cin_pad * 64 * 2
              + 2 * (2 * 2 * 4 * 64 * 4) + 2 * 4 * 2 * 64 * 4 + (2 * _FWD_STAGES + 1) * 8)
    return 1024 + -(-struct // 128) * 128


@functools.lru_cache(maxsize=256)
def pool_fwd_plan(rows: int, cin: int, c: int, bf16: bool, pool: int,
                  sms: int = SMS) -> PoolFwdPlan:
    """The forward kernels' route and geometry for rows x (Cin -> C) in
    pool blocks of `pool` rows.

    bf16 with Cin <= 128 and Cin, C multiples of 8 (TMA reads 16-byte rows)
    at a pool of 16 or 32 rows or a multiple of 64 (a 16-row warp slice of
    a tile never straddles two pool blocks; every driven shape: PointNet's
    128 -> 1024 at 2048, the MSG branches' 32-128 -> 64-256 at 16-128) takes
    TMA + wgmma: blocks of 128 channels of C over chunks of whole pool
    blocks and 64-row tiles, in whole waves of one block an SM (`split`),
    so that no pool block spans two blocks. fp32 (the card-vs-CPU checks),
    ragged widths, Cin > 128 and other pools take the tile route (64 x 128
    tiles of tile_mma.cuh over chunks of _FWD_CHUNK_ROWS rows, pool blocks
    merged across chunks by an order-free atomicMax). Shapes no route takes
    (rows past the tile route's grid, empty widths, a pool that does not
    divide the rows) raise ValueError."""
    if not (1 <= rows <= _MAX_ROWS and cin >= 1 and c >= 1 and pool >= 1
            and rows % pool == 0):
        raise ValueError(f"dense_pool_stats kernel bounds exceeded: rows={rows} "
                         f"Cin={cin} C={c} pool={pool}")
    col_blocks = -(-c // 128)
    cin_pad = 64 if cin <= 64 else 128
    if bf16 and cin % 8 == 0 and c % 8 == 0 and cin <= _WG_MAX_CIN and pool >= 16 \
            and (pool % _FWD_TILE == 0 or _FWD_TILE % pool == 0) \
            and _fwd_smem(cin_pad) <= SMEM_LIMIT:
        chunk, chunks = split(rows, max(pool, _FWD_TILE), col_blocks, sms)
        return PoolFwdPlan(rows, cin, c, pool, "wgmma", cin_pad, chunk, chunks,
                           col_blocks, _fwd_smem(cin_pad))
    return PoolFwdPlan(rows, cin, c, pool, "tile", 0, _FWD_CHUNK_ROWS,
                       -(-rows // _FWD_CHUNK_ROWS), col_blocks, 0)


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
                    + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.dense_pool_stats_bwd_launch
    bwd.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward_kernel(x, w, bias, sign, pen, pool):
    B, R, Cin = x.shape
    C = w.shape[1]
    rows = B * R
    dev = x.device
    plan = pool_fwd_plan(rows, Cin, C, x.dtype == torch.bfloat16, pool,
                         sm_count(dev.index))
    psel = torch.empty((B, R // pool, C), dtype=x.dtype, device=dev)
    asel = torch.empty((B, R // pool, C), dtype=torch.int32, device=dev)
    stats = torch.empty((2, C), dtype=torch.float32, device=dev)
    keys = (torch.empty((rows // pool, C), dtype=torch.int64, device=dev)
            if plan.route == "tile" else None)
    part = torch.empty((plan.chunks, 2, C), dtype=torch.float32, device=dev)
    fwd, _ = _launchers()
    with torch.cuda.device(dev):
        err = fwd(
            _ptr(x), _ptr(w), _ptr(bias), _ptr(sign), _ptr(pen), _ptr(psel),
            _ptr(asel), _ptr(stats), _ptr(keys), _ptr(part), rows, Cin, C,
            pool, plan.chunk_rows, _ROUTES.index(plan.route), plan.cin_pad,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_pool_stats kernel launch failed on the "
                           f"{plan.route} route: CUDA error {err}")
    dense_pool_stats.launches += 1
    return psel, asel, stats[0], stats[1]


def dense_pool_stats_bwd(x, w, bias, sign, asel, dpsel, dssum, dssq, pool: int):
    """The backward kernels of `dense_pool_stats` on CUDA tensors: rebuild
    dz = dssum + 2 dssq z + sign * sparse(asel, dpsel) from the same rounded
    z, cast it to x.dtype, and return (dx in x.dtype, dw (Cin, C) fp32,
    db (C,) fp32), on `pool_bwd_plan`'s route. Takes what the forward kernel
    takes plus asel (B, R/pool, C) int32 and fp32 cotangents; anything else
    raises. `dense_pool_stats_bwd.launches` counts its calls."""
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
    plan = pool_bwd_plan(rows, Cin, C, x.dtype == torch.bfloat16, pool,
                         sm_count(device.index))
    dx = torch.empty_like(x)
    dw = torch.empty((Cin, C), dtype=torch.float32, device=device)
    db = torch.empty((C,), dtype=torch.float32, device=device)
    dw_part = torch.empty((plan.dw_chunks, Cin, C), dtype=torch.float32, device=device)
    db_part = torch.empty((plan.dw_chunks, C), dtype=torch.float32, device=device)
    _, bwd = _launchers()
    with torch.cuda.device(device):
        err = bwd(
            _ptr(x), _ptr(w), _ptr(bias), _ptr(sign), _ptr(asel), _ptr(dpsel),
            _ptr(dssum), _ptr(dssq), _ptr(dx), _ptr(dw), _ptr(db),
            _ptr(dw_part), _ptr(db_part), rows, Cin, C, pool,
            _ROUTES.index(plan.route), plan.cin_pad, plan.dx_chunk_rows,
            plan.dw_chunk_rows, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dense_pool_stats_bwd kernel launch failed on the "
                           f"{plan.route} route: CUDA error {err}")
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
