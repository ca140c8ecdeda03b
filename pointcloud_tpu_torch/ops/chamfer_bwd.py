"""Fused Chamfer backward: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_chamfer_bwd_kernel
(`chamfer_nn_bwd_pallas`). The kernel is csrc/chamfer_bwd.cu; its note
states the design and the bound, and `chamfer_bwd_plan` sizes its launch
from the shape alone. `chamfer_bwd` launches it for CUDA tensors and takes
the plain version `chamfer_bwd_reference` only for CPU tensors.

Both compute, from clouds x (B, N, C), y (B, M, C), the cotangents gx (B, N),
gy (B, M) of the nearest-neighbour distances (zero on masked rows) and the
argmins amin_x (B, N), amin_y (B, M):

    tx = 2 gx (x - y[amin_x])          ty = 2 gy (y - x[amin_y])
    dx = tx - segsum(ty -> amin_y)     dy = ty - segsum(tx -> amin_x)

The kernel sums a target's rows in increasing row order, as the plain
version's index_add_ does on the CPU, up to PIECE rows; a longer bucket in
pieces of PIECE rows added in piece order, the order of
`scatter_rows_mirror(-ty, amin_y, N, init=tx, piece=PIECE)` (and dy
symmetrically).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT, SMS
from pointcloud_tpu_torch.ops.scatter_rows import scatter_rows_reference

MAX_DIMS = 8  # C <= 8, as the TPU kernel
_MAX_BATCH = 65535  # gridDim.y
_MAX_POINTS = 1 << 27  # keeps every int32 offset (point * C) in range
_THREADS = 512  # csrc/chamfer_bwd.cu kThreads
_SORT_WARPS = 8  # csrc/chamfer_bwd.cu kSortWarps
_SMEM_SM = 233_472  # shared memory of an H100 SM (228 KB)
_BLOCKS_PER_SM = 4  # 2,048 threads an SM in blocks of 512
_MIN_TARGETS = 32  # the fewest targets a range
PIECE = 32  # csrc/chamfer_bwd.cu kPiece: longest run of a bucket one thread sums


class ChamferBwdPlan(NamedTuple):
    """The launch geometry of one `chamfer_bwd` call (csrc/chamfer_bwd.cu)."""
    # "shared": the other cloud and the sort in shared memory; "global": not
    route: str
    threads: int  # threads a block
    ranges: int  # blocks a direction of a cloud, each a range of its targets
    piece: int  # longest run of a bucket one thread sums; longer ones in pieces
    pieces: int  # slots for pieces' sums a block (the most a direction needs)
    smem: int  # dynamic shared memory a block, bytes, as the kernel lays it out
    scratch: int  # global scratch a block, bytes (the global route), else 0


def _up16(v: int) -> int:
    return -(-v // 16) * 16


def _layout(nq: int, targets: int, C: int, staged: bool) -> tuple:
    """csrc/chamfer_bwd.cu's Layout: (shared bytes, scratch bytes) of a block
    whose targets take the rows of a cloud of nq points. Shared route: that
    cloud's rows, cotangents and argmins, the permutation (16-bit), the
    bucket starts, the long buckets and their pieces' prefix, then the
    larger of the warps' histograms (16-bit) and the pieces' sums with the
    16 warps' tiles of 32 own rows, which reuse the histograms' bytes.
    Global route: the tiles in shared memory, the rest (32-bit) in the
    scratch."""
    isize = 2 if staged else 4
    lcap, pcap = nq // (PIECE + 1) + 1, nq // PIECE + 2
    sort = _up16(nq * isize) + _up16((targets + 1) * 4) + 2 * _up16(lcap * 4)
    hist = _up16(_SORT_WARPS * targets * isize)
    pieces, tiles = _up16(pcap * C * 4), _THREADS * C * 4
    if staged:
        return _up16(nq * C * 4) + 2 * _up16(nq * 4) + sort + max(hist, pieces + tiles), 0
    return tiles, sort + hist + pieces


@functools.lru_cache(maxsize=256)
def chamfer_bwd_plan(B: int, N: int, M: int, C: int) -> ChamferBwdPlan:
    """The launch of `chamfer_bwd` for B pairs of clouds of N and M points
    with C channels: a grid of (2 * ranges, B) blocks of 512 threads, a
    block one direction of one cloud and a range of its targets.

    The shared route holds a block's work in shared memory (both
    directions' layouts fit, and each cloud has at most 65,535 points: the
    sort's 16-bit slots); `ranges` doubles from 1 while the histograms do
    not fit, then while the blocks fill less than the card's resident
    blocks once, as long as a range keeps 32 targets or more (each range
    stages the other cloud again, from L2). Larger clouds take the global
    route, one range a direction. `pieces` are the slots for long buckets'
    sums: N or M over PIECE, and 2.

    Raises ValueError for shapes no launch takes (B outside 1..65,535, N or
    M outside 1..2^27, C outside 1..8)."""
    if not (1 <= B <= _MAX_BATCH and 1 <= N <= _MAX_POINTS and 1 <= M <= _MAX_POINTS
            and 1 <= C <= MAX_DIMS):
        raise ValueError(f"chamfer_bwd kernel bounds exceeded: B={B} N={N} M={M} C={C}")

    def size(ranges, staged=True):  # the larger direction's layout
        return [max(v) for v in zip(*(_layout(nq, -(-np_ // ranges), C, staged)
                                      for np_, nq in ((N, M), (M, N))))]

    def wide(ranges):  # twice the ranges keep 32 targets a range
        return -(-min(N, M) // (2 * ranges)) >= _MIN_TARGETS

    pieces = max(N, M) // PIECE + 2
    ranges = 1  # the fewest ranges whose histograms fit, then enough blocks
    while size(ranges)[0] > SMEM_LIMIT and wide(ranges):
        ranges *= 2
    if max(N, M) <= 65535 and size(ranges)[0] <= SMEM_LIMIT:
        while True:
            resident = max(1, min(_BLOCKS_PER_SM, _SMEM_SM // (size(ranges)[0] + 1024)))
            if 2 * B * ranges >= resident * SMS or not wide(ranges):
                break
            ranges *= 2
        return ChamferBwdPlan("shared", _THREADS, ranges, PIECE, pieces, size(ranges)[0], 0)
    smem, scratch = size(1, False)
    return ChamferBwdPlan("global", _THREADS, 1, PIECE, pieces, smem, scratch)


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
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def chamfer_bwd(x, y, gx, gy, amin_x, amin_y):
    """(dx (B, N, C), dy (B, M, C)) fp32, as the module docstring says.

    CPU tensors take the plain version. CUDA tensors launch the kernel, which
    takes contiguous fp32 clouds and cotangents, int32 argmins in range and
    1 <= C <= 8, and gives the same bits on every run (those of
    `scatter_rows_mirror`'s order); anything else raises.
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
    plan = chamfer_bwd_plan(B, N, M, C)

    dx = torch.empty_like(x)
    dy = torch.empty_like(y)
    scratch = (torch.empty(2 * B * plan.scratch, dtype=torch.uint8, device=device)
               if plan.scratch else None)
    launch = _launcher()
    with torch.cuda.device(device):
        err = launch(
            x.data_ptr(), y.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            amin_x.data_ptr(), amin_y.data_ptr(), dx.data_ptr(), dy.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, N, M, C, plan.ranges,
            int(plan.route == "shared"), plan.smem, plan.scratch,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"chamfer_bwd kernel launch failed: CUDA error {err}")
    chamfer_bwd.launches += 1
    return dx, dy


chamfer_bwd.launches = 0
