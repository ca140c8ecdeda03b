"""Deterministic segment-sum of rows: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_scatter_kernel /
_scatter_kernel_init (`scatter_rows_pallas`). The kernel is
csrc/scatter_rows.cu; its note states the design and the bound.
`scatter_plan` sizes its launch from the shape alone. `scatter_rows`
launches it for CUDA tensors and takes the plain version
`scatter_rows_reference` only for CPU tensors.

The kernel sums each target's rows in increasing row order, as the plain
version's index_add_ does on the CPU, up to PIECE rows a target; a longer
bucket is summed as pieces of PIECE rows added in piece order.
`scatter_rows_mirror` is that order in plain PyTorch.

The TPU kernel's `fold` argument is left out: it packs split-bf16 copies of
g so that the MXU can sum fp32 exactly, and the card's CUDA cores add fp32
directly. The function `init + segsum(g)` is the same.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT, SMS, split

_MAX_BATCH = 65535  # gridDim.y
_MAX_ELEMENTS = 1 << 30  # rows * C and n * C, keeps int32 offsets in range
_THREADS = 512  # csrc/scatter_rows.cu kThreads
_WARPS = _THREADS // 32
PIECE = 128  # csrc/scatter_rows.cu kPiece: longest bucket summed in row order
_MAX_TARGETS = 1024  # targets a block: 16 warps' histograms in 64 KB, 10-bit items
_GRANULE = 32  # targets: ranges are whole multiples


class ScatterPlan(NamedTuple):
    """The launch geometry of one `scatter_rows` call (csrc/scatter_rows.cu)."""
    route: str  # "ranges": a block a range of targets of one cloud
    ranges: int  # blocks a cloud
    targets: int  # targets a block
    threads: int  # threads a block
    vec: int  # channels a lane loads at once
    group: int  # lanes an item
    passes: int  # passes of group x vec channels a lane holds
    perm_cap: int  # slots a block keeps in shared memory
    item_cap: int  # items a block: its buckets, and pieces of PIECE rows
    cloud_pieces: int  # pieces' sums a cloud's blocks keep in the scratch
    smem: int  # dynamic shared memory a block, bytes, as the kernel lays it out


def _smem(targets: int, perm_cap: int, item_cap: int) -> int:
    """csrc/scatter_rows.cu's Layout in bytes: the warps' histograms, four
    ints a target, the items, the length classes, scalars, slots."""
    ints = (_WARPS * targets + 4 * targets + item_cap + (PIECE + 1)
            + 2 * (PIECE + 2) + 4 + _WARPS + perm_cap)
    return 4 * ints


@functools.lru_cache(maxsize=256)
def scatter_plan(B: int, R: int, n: int, C: int, dtype, align: int = 16) -> ScatterPlan:
    """The launch of `scatter_rows` for g (B, R, C) in `dtype` (fp32 or
    bf16) whose first element lies on an `align`-byte boundary, onto n
    targets:

    - vec: the widest load (at most 16 bytes) that every row's start
      allows (bf16 rows of an odd width: one channel a lane);
    - group: the fewest lanes (a power of two) whose vec channels cover a
      row, at most 32, and passes: the rounds of group x vec channels a lane
      holds (one channel a lane: as many as the row needs, up to 8; wider
      loads 1 to 4, or 8; at most 16 channels a lane, wider rows in
      chunks);
    - ranges: blocks a cloud, each `targets` consecutive targets (at most
      1,024): `_launch.split`'s split of the targets in multiples of 32 over
      B x ranges blocks, one resident an SM; every block reads the cloud's
      indices twice, so ranges stop where those reads pass a quarter of g's
      bytes (8 MiB at least);
    - perm_cap: a block's slots in shared memory, twice its even share of
      the rows (at least 1,024); a block past it keeps them in the scratch;
    - item_cap: a block's items, its targets and at most 2 R / PIECE pieces
      of long buckets; cloud_pieces: the pieces' sums of a cloud's blocks.

    Raises ValueError for shapes no launch takes (B outside 1..65,535, n or
    C below 1, R below 0, R * C or n * C at 2^30 or more) and TypeError for
    other dtypes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter_rows kernel takes fp32 or bf16 rows; got {dtype}")
    if not (1 <= B <= _MAX_BATCH and R >= 0 and n >= 1 and C >= 1
            and R * C < _MAX_ELEMENTS and n * C < _MAX_ELEMENTS):
        raise ValueError(f"scatter_rows kernel bounds exceeded: B={B} R={R} "
                         f"n={n} C={C}")
    esize = 2 if dtype == torch.bfloat16 else 4
    vec = next(v for v in (16 // esize, 8 // esize, 4 // esize, 1)
               if (C * esize) % (v * esize) == 0 and align % (v * esize) == 0)
    lanes = -(-C // vec)
    group = min(32, 1 << (lanes - 1).bit_length())
    need = -(-C // (group * vec))
    passes = min(8, 16 // vec, need if need <= 4 or vec == 1 else 8)

    targets, ranges = split(n, _GRANULE, B, SMS)
    reread = max(1, 8 * B * R)
    ranges = min(ranges, max(1, max(B * R * C * esize // 4, 8 << 20) // reread))
    ranges = max(ranges, -(-n // _MAX_TARGETS))
    targets = -(-n // ranges)
    ranges = -(-n // targets)

    item_cap = targets + 2 * R // PIECE + 1
    share = -(-R * targets // n)
    perm_cap = min(R, -(-max(1024, 2 * share) // 32) * 32)
    while perm_cap > 0 and _smem(targets, perm_cap, item_cap) > SMEM_LIMIT:
        perm_cap = max(0, perm_cap - 1024)
    return ScatterPlan("ranges", ranges, targets, _THREADS, vec, group, passes,
                       perm_cap, item_cap, 2 * R // PIECE + ranges,
                       _smem(targets, perm_cap, item_cap))


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


def scatter_rows_mirror(g, idx, n: int, init=None, piece: int = PIECE):
    """The kernel's order of additions in plain PyTorch (fp32, any device):
    the plain version for every bucket of up to `piece` rows (the kernel's
    PIECE; csrc/chamfer_bwd.cu sums its buckets in the same order with
    pieces of 32); a longer bucket cut into pieces of `piece` rows, each
    summed in row order (the first from init, the others from 0), and the
    pieces' sums added in piece order."""
    B, R, C = g.shape
    out = scatter_rows_reference(g, idx, n, init)
    gf = g.float()
    for b in range(B):
        ib = idx[b].long()
        inside = (ib >= 0) & (ib < n)
        lens = torch.bincount(ib[inside], minlength=n)
        for t in torch.nonzero(lens > piece).flatten().tolist():
            rows = torch.nonzero(ib == t).flatten()
            total = None
            for q in range(0, rows.numel(), piece):
                acc = (init[b, t].float().clone() if q == 0 and init is not None
                       else torch.zeros(C, dtype=torch.float32, device=g.device))
                for r in rows[q:q + piece].tolist():
                    acc = acc + gf[b, r]
                total = acc if total is None else total + acc
            out[b, t] = total
    return out


@functools.cache
def _launcher():
    fn = _build.load("scatter_rows").scatter_rows_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 13 + [ctypes.c_void_p])
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
    ptr = g.data_ptr()
    plan = scatter_plan(B, R, n, C, g.dtype, align=min(16, ptr & -ptr) if ptr else 16)

    out = torch.empty((B, n, C), dtype=torch.float32, device=device)
    perm = torch.empty((B, R), dtype=torch.int32, device=device)
    part = torch.empty((B, plan.cloud_pieces, C), dtype=torch.float32, device=device)
    launch = _launcher()
    with torch.cuda.device(device):
        err = launch(
            g.data_ptr(), int(g.dtype == torch.bfloat16), idx.data_ptr(),
            None if init is None else init.data_ptr(), out.data_ptr(),
            perm.data_ptr(), part.data_ptr(), B, R, n, C, plan.ranges, plan.targets,
            plan.vec, plan.group, plan.passes, plan.perm_cap,
            plan.item_cap, plan.cloud_pieces, plan.smem,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: CUDA error {err}")
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0


def scatter_grouped(idx, n: int, dgx, dgf, feat_dtype):
    """The gradient of a grouping's gathers (the JAX package's
    `_grouped_gather_bwd` and `_gg_knn_bwd`): the cotangents dgx
    (B, S, k, 3) of the gathered xyz and dgf (B, S, k, F) of the gathered
    features, either None where that gradient is not needed, concatenated
    over the B x S*k rows idx (B, S, k) and sent back onto the n points by
    one `scatter_rows`. The rows are bf16 when the features are bf16 (fp32
    sums), as in the JAX package. Returns (d_xyz (B, n, 3) fp32 or None,
    d_feats (B, n, F) in `feat_dtype` or None); no launch when both are
    None."""
    parts = [g.float() for g in (dgx, dgf) if g is not None]
    if not parts:
        return None, None
    B, S, k = idx.shape
    rows = torch.cat(parts, -1).reshape(B, S * k, -1).to(
        torch.bfloat16 if feat_dtype == torch.bfloat16 else torch.float32)
    scat = scatter_rows(rows.contiguous(), idx.reshape(B, S * k), n)
    d_xyz = None if dgx is None else scat[..., :3]
    d_feats = None if dgf is None else scat[..., 0 if dgx is None else 3:].to(
        feat_dtype)
    return d_xyz, d_feats
