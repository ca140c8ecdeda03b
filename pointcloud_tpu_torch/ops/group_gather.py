"""Ball query + uncentred gather (the legacy grouping's ball mode): CUDA
kernel, plain version, wrapper.

Port of the ball mode of pointcloud_tpu/ops/pallas_kernels.py:_group_kernel
(`grouped_gather` with a radius), which the JAX package's `group_neighbors`
reaches for a ball grouping; its one caller is the multi-scale-grouping set
abstraction. The kernel is csrc/group_gather.cu; its note states the design
and the bound. `group_gather` launches it for CUDA tensors and takes the
plain version `group_gather_reference` only for CPU tensors. Its gradient (a
port of `_grouped_gather_bwd`) is one `scatter_rows` of the gathered rows'
cotangents back onto the points, on either device.

The outputs are in `group_neighbors`' public layout (B, S, k, .), where the
TPU kernel writes (B, k, C, S) and the JAX package transposes. Membership
follows the TPU kernel: ((pen + dx^2) + dy^2) + dz^2 <= r2 on direct
differences, pen = 1e9 on masked points, r2 = float32(radius**2) taken in
double. The TPU kernel's limits (k <= 256, N <= 16384: its bf16 rank tile
and index channels) do not apply here, and xyz is gathered exactly where
the TPU's bf16 path carries it as split-bf16 hi + lo: any N and any k (past
what a block's shared slots hold, 1,806, the kernel keeps its slots in the
idx output). `group_gather_plan` sizes the launch from the shape alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT, SMS
from pointcloud_tpu_torch.ops.geometry import (
    first_k_in_ball,
    index_points,
    penalised_sqdist,
)
from pointcloud_tpu_torch.ops.scatter_rows import scatter_grouped

_MAX_BATCH = 65535  # gridDim.y
_WARPS = 32  # csrc/group_gather.cu kWarps
_CENTS = (2, 1)  # centroids a warp may select at once
_TILE = 4096  # largest tile of a warp's output runs, bytes
_BULK_ROW = 256  # bytes of the narrowest row that bulk copies move faster
_SMEM_SM = 233_472  # shared memory of an H100 SM (228 KB)
_BLOCKS_PER_SM = 2  # 2,048 threads an SM in blocks of 1,024


class GatherPlan(NamedTuple):
    """The launch geometry of one `group_gather` call (csrc/group_gather.cu)."""
    # "shared": the cloud staged in shared memory; "global": not; "-idx"
    # after either: the slots in the idx output (k past the shared slots)
    route: str
    threads: int  # threads a block
    cents: int  # centroids a warp selects at once
    per_block: int  # centroids a block
    blocks: int  # blocks a cloud
    tile: int  # bytes of a warp's tile of an output run
    bulk: bool  # feature rows by 1-D bulk copies (16-byte words, rows of 256 bytes up)
    smem: int  # dynamic shared memory a block, bytes, as the kernel lays it out


def _gather_smem(N: int, k: int, cents: int, tile: int, shared: bool,
                 idx_slots: bool = False) -> int:
    """csrc/group_gather.cu's shared memory: 32 warps' mbarriers, 32 warps'
    slots for `cents` centroids (rounded to 16 bytes for the block; none
    with `idx_slots`), 32 warps' tiles, and on the shared route 16 bytes a
    staged point."""
    slots = 0 if idx_slots else -(-_WARPS * cents * k * 4 // 16) * 16
    return _WARPS * 8 + slots + _WARPS * tile + (16 * N if shared else 0)


@functools.lru_cache(maxsize=256)
def group_gather_plan(B: int, N: int, S: int, k: int, row_bytes: int, word: int = 16,
                      with_xyz: bool = True) -> GatherPlan:
    """The launch of `group_gather` for B clouds of N points whose feature
    rows are `row_bytes` bytes (0 without features), moved as words of
    `word` bytes (2, 4, 8 or 16: the widest that divides a row and both
    base addresses), S centroids and k slots each; `with_xyz` asks for the
    grouped xyz.

    A block is 32 warps. Shared memory holds each warp's mbarrier, its
    slots for the centroids it selects at once (rounded to 16 bytes for the
    block), its tile: the longer run (the features' k rows, or the xyz
    rows') and 16 bytes, a multiple of 32, at most 4 KB, less where the
    slots leave less room; on the shared route the cloud's points follow as
    (x, y, z, pen), 16 bytes a point. A cloud whose points do not fit takes
    the global route. Of 1 or 2 centroids a warp and the blocks a cloud, the
    plan takes the least waves of resident blocks times a warp's centroids
    (the most centroids a warp on a tie, then the fewest blocks). Feature
    rows of 16-byte words and 256 bytes or more go by bulk copies, the rest
    as words (measured on the card: each way is the faster on its rows).
    Where no tile fits beside one centroid's slots a warp (k past 1,806),
    the slots live in the idx output and the tile is the one asked for
    (route "-idx").

    Raises ValueError for shapes no launch takes (B outside 1..65,535, N, S
    or k below 1, row_bytes below 0 or not a whole number of words, `word`
    not 2, 4, 8 or 16)."""
    if not (1 <= B <= _MAX_BATCH and N >= 1 and S >= 1 and k >= 1 and row_bytes >= 0
            and word in (2, 4, 8, 16) and row_bytes % word == 0):
        raise ValueError(f"group_gather kernel bounds exceeded: B={B} N={N} S={S} k={k} "
                         f"row_bytes={row_bytes} word={word}")
    run = max(k * row_bytes, 12 * k if with_xyz else 0)
    want_tile = max(32, min(_TILE, -(-(run + 16) // 32) * 32))
    best = _plan_with(B, N, S, k, row_bytes, word, want_tile, False)
    if best is None:
        best = _plan_with(B, N, S, k, row_bytes, word, want_tile, True)
    return best


def _plan_with(B, N, S, k, row_bytes, word, want_tile, idx_slots):
    """group_gather_plan's best launch with the slots in shared memory or
    (`idx_slots`) in the idx output; None where no tile fits."""
    best = None
    for cents in _CENTS:
        room = SMEM_LIMIT - _gather_smem(N, k, cents, 0, False, idx_slots)
        tile = min(want_tile, room // _WARPS // 32 * 32)
        if tile < 32:
            continue
        shared = _gather_smem(N, k, cents, tile, True, idx_slots) <= SMEM_LIMIT
        smem = _gather_smem(N, k, cents, tile, shared, idx_slots)
        route = ("shared" if shared else "global") + ("-idx" if idx_slots else "")
        resident = max(1, min(_BLOCKS_PER_SM, _SMEM_SM // (smem + 1024)))
        for want in range(1, max(1, min(-(-S // _WARPS), 4 * SMS)) + 1):
            per_block = -(-S // want)
            blocks = -(-S // per_block)
            iters = -(-per_block // (_WARPS * cents))
            waves = -(-B * blocks // (resident * SMS))
            cost = (waves * iters * cents, -cents, blocks)
            if best is None or cost < best[0]:
                best = (cost, GatherPlan(route, _WARPS * 32, cents, per_block, blocks,
                                         tile, row_bytes >= _BULK_ROW and word == 16,
                                         smem))
    return None if best is None else best[1]


def plan_args(p: GatherPlan) -> tuple:
    """The plan as csrc/group_gather.cu's entry takes it, after `valid`."""
    route = (0 if p.route.startswith("shared") else 1) + (2 if p.route.endswith("-idx")
                                                           else 0)
    return (route, p.cents, p.per_block, p.blocks, p.tile, int(p.bulk), p.smem)


def group_gather_reference(xyz, feats, new_xyz, mask, k: int, radius: float,
                           with_xyz: bool = True):
    """Plain PyTorch version of the kernel; same arguments and results as
    `group_gather`. Differentiable through its gathers by autograd."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=xyz.device)
    idx, valid = first_k_in_ball(penalised_sqdist(xyz, new_xyz, mask) <= r2, k)
    gx = index_points(xyz, idx) if with_xyz else None
    gf = None if feats is None else index_points(feats, idx)
    return gx, gf, idx, valid


@functools.cache
def _launcher():
    fn = _build.load("group_gather").group_gather_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _word_bytes(row_bytes: int, *tensors) -> int:
    """The widest word (16, 8, 4 or 2 bytes) that divides a feature row and
    the base address of every tensor: the kernel copies rows as such words."""
    for w in (16, 8, 4, 2):
        if row_bytes % w == 0 and all(t.data_ptr() % w == 0 for t in tensors):
            return w
    raise ValueError(f"group_gather: feature rows of {row_bytes} bytes are not "
                     f"a whole number of 2-byte words")


def _group(xyz, feats, new_xyz, mask, k: int, radius: float, with_xyz: bool):
    """`group_gather` without its gradient: checks, then the kernel or the
    plain version."""
    if xyz.dim() != 3 or xyz.shape[2] != 3 or new_xyz.dim() != 3 \
            or new_xyz.shape[2] != 3 or new_xyz.shape[0] != xyz.shape[0]:
        raise ValueError(f"group_gather takes xyz (B, N, 3) and new_xyz (B, S, 3); "
                         f"got {tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if feats is not None and (feats.dim() != 3 or feats.shape[:2] != (B, N)):
        raise ValueError(f"feats must be (B, N, F) = ({B}, {N}, F); got "
                         f"{tuple(feats.shape)}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (B, N)):
        raise ValueError(f"mask must be bool of shape {(B, N)}; got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if k < 1 or not radius > 0:
        raise ValueError(f"group_gather needs k >= 1 and radius > 0; got k={k}, "
                         f"radius={radius}")
    devices = {t.device for t in (xyz, feats, new_xyz, mask) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"group_gather inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return group_gather_reference(xyz, feats, new_xyz, mask, k, radius,
                                      with_xyz)
    if device.type != "cuda":
        raise ValueError(f"group_gather runs on CPU or CUDA tensors, not {device}")
    if xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32 or (
            feats is not None and feats.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"group_gather kernel takes fp32 xyz and centroids and "
                        f"fp32/bf16 features; got {xyz.dtype}, {new_xyz.dtype}, "
                        f"{None if feats is None else feats.dtype}")
    if not all(t.is_contiguous() for t in (xyz, feats, new_xyz, mask)
               if t is not None):
        raise ValueError("group_gather kernel takes contiguous tensors")
    if not (1 <= B <= _MAX_BATCH and N >= 1 and S >= 1):
        raise ValueError(f"group_gather kernel bounds exceeded: B={B} N={N} S={S}")

    idx = torch.empty((B, S, k), dtype=torch.int32, device=device)
    valid = torch.empty((B, S, k), dtype=torch.bool, device=device)
    gx = (torch.empty((B, S, k, 3), dtype=torch.float32, device=device)
          if with_xyz else None)
    gf = (None if feats is None else
          torch.empty((B, S, k, feats.shape[2]), dtype=feats.dtype, device=device))
    row_bytes = 0 if feats is None else feats.shape[2] * feats.element_size()
    word = _word_bytes(row_bytes, feats, gf) if row_bytes else 16
    plan = group_gather_plan(B, N, S, k, row_bytes, word, with_xyz)
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))  # exact in fp32

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch = _launcher()
    with torch.cuda.device(device):
        err = launch(
            xyz.data_ptr(), ptr(feats), word, row_bytes, new_xyz.data_ptr(),
            ptr(mask), B, N, S, k, r2, ptr(gx), ptr(gf), idx.data_ptr(),
            valid.data_ptr(), *plan_args(plan),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"group_gather kernel launch failed: CUDA error {err}")
    group_gather.launches += 1
    return gx, gf, idx, valid


class _GroupGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, feats, new_xyz, mask, k, radius, with_xyz):
        gx, gf, idx, valid = _group(xyz, feats, new_xyz, mask, k, radius, with_xyz)
        ctx.save_for_backward(idx)
        ctx.n_points = xyz.shape[1]
        ctx.with_xyz = with_xyz
        ctx.feat_dtype = None if feats is None else feats.dtype
        ctx.mark_non_differentiable(idx, valid)
        return gx, gf, idx, valid

    @staticmethod
    def backward(ctx, dgx, dgf, didx, dvalid):
        del didx, dvalid
        (idx,) = ctx.saved_tensors
        # new_xyz and the mask get none: the selection is not differentiable
        with_xyz = ctx.with_xyz and ctx.needs_input_grad[0]
        with_feats = ctx.feat_dtype is not None and ctx.needs_input_grad[1]
        d_xyz, d_feats = scatter_grouped(idx, ctx.n_points,
                                         dgx if with_xyz else None,
                                         dgf if with_feats else None,
                                         ctx.feat_dtype)
        return d_xyz, d_feats, None, None, None, None, None


def group_gather(xyz, feats, new_xyz, mask, k: int, radius: float,
                 with_xyz: bool = True):
    """Group the first k points within `radius` of each centroid, by index.

    xyz (B, N, 3) fp32, feats (B, N, F) fp32 or bf16 or None, new_xyz
    (B, S, 3) fp32 centroids, mask (B, N) bool (True = valid) or None.
    Returns (grouped_xyz (B, S, k, 3) fp32, not centred, or None when
    `with_xyz` is False; grouped_feats (B, S, k, F) in the features' dtype,
    or None without features; idx (B, S, k) int32, slots past the in-ball
    count repeating slot 0 and point 0 in an empty ball; valid (B, S, k)
    bool, the slot inside the ball).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes contiguous tensors; anything else raises.
    `group_gather.launches` counts the kernel's launches.

    Differentiable in xyz and feats (the selection is not; new_xyz and the
    mask get no gradient): the cotangents of the gathered rows, padded slots
    included, go back onto the points through one `scatter_rows`
    (deterministic), as bf16 rows when the features are bf16; only the
    gradients that are needed are formed.
    """
    return _GroupGather.apply(xyz, feats, new_xyz, mask, k, radius, with_xyz)


group_gather.launches = 0
