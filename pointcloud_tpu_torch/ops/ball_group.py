"""Ball query + centred gather: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_group_ball_smajor_kernel
(`grouped_gather_ball`). The kernel is csrc/ball_group.cu; its note states
the design and the bound, and `ball_group_plan` sizes its launch from the
shape alone. `ball_group` launches it for CUDA tensors and
takes the plain version `ball_group_reference` only for CPU tensors. Its
gradient (a port of `_gg_ball_bwd`) is one `scatter_rows` of the grouped
cotangent back onto the points, on either device.

Membership follows the TPU kernel: ((pen + dx^2) + dy^2) + dz^2 <= r2 on
direct differences, pen = 1e9 on masked points, r2 = float32(radius**2)
taken in double. (The JAX package's XLA `ball_query` uses the matmul
expansion instead, which can flip a point within a few ulps of the radius.)
The TPU kernel's limits (k % 8 == 0, k <= 256, N <= 16384) come from its
VMEM and bf16 index channels and do not apply here: any k >= 1 and any N
(past 780 slots a centroid the kernel keeps its slots in the idx output).
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
from pointcloud_tpu_torch.ops.scatter_rows import scatter_rows

_MAX_BATCH = 65535  # gridDim.y
_WARPS = 32  # csrc/ball_group.cu kWarps
_CENTS = 2  # csrc/ball_group.cu kCents: centroids a warp selects at once
_TILE = 1024  # largest tile of a warp's output run, bytes
_SMEM_SM = 233_472  # shared memory of an H100 SM (228 KB)
_BLOCKS_PER_SM = 2  # 2,048 threads an SM in blocks of 1,024


class BallPlan(NamedTuple):
    """The launch geometry of one `ball_group` call (csrc/ball_group.cu)."""
    # "shared": the cloud staged in shared memory; "global": not; "-idx"
    # after either: the slots in the idx output (k past the shared slots)
    route: str
    threads: int  # threads a block (a warp two centroids at a time)
    per_block: int  # centroids a block
    blocks: int  # blocks a cloud
    tile: int  # bytes of a warp's tile of an output run
    stage_feats: bool  # the features staged beside the points
    smem: int  # dynamic shared memory a block, bytes, as the kernel lays it out


@functools.lru_cache(maxsize=256)
def ball_group_plan(B: int, N: int, S: int, k: int, F: int, dtype) -> BallPlan:
    """The launch of `ball_group` for B clouds of N points with F feature
    channels in `dtype` (fp32 or bf16; F = 0 without features), S centroids
    and k slots each.

    A block is 32 warps. Shared memory holds each warp's slots for its two
    centroids (rounded to 16 bytes for the block), then each warp's tile:
    the whole output run k * (3+F) elements and 16 bytes, at most 1 KB, but
    at least a row and 16 bytes. On the shared route the cloud's points
    follow as (x, y, z, pen), 16 bytes a point, and the features (N * F
    elements) where they fit too. A cloud whose points do not fit takes the
    global route. Where the slots and tiles alone pass the shared memory (k
    past 780), the slots live in the idx output instead (route "-idx"). A
    block serves `per_block` centroids of one cloud (32 or more unless S is
    smaller), and a cloud takes as many blocks as fill the card's resident
    blocks once (each block stages the cloud again).

    Raises ValueError for shapes no launch takes (B outside 1..65,535, N, S
    or k below 1, F below 0, a row's tile past the shared memory) and
    TypeError for other dtypes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ball_group kernel takes fp32 or bf16 features; got {dtype}")
    if not (1 <= B <= _MAX_BATCH and N >= 1 and S >= 1 and k >= 1 and F >= 0):
        raise ValueError(f"ball_group kernel bounds exceeded: B={B} N={N} S={S} "
                         f"k={k} F={F}")
    esize = 2 if dtype == torch.bfloat16 and F > 0 else 4  # the output's
    tile = max(min(_TILE, (-(-k * (3 + F) * esize // 16) + 1) * 16),
               (-(-(3 + F) * esize // 16) + 1) * 16)
    fixed = -(-_WARPS * _CENTS * k * 4 // 16) * 16 + _WARPS * tile
    idx_slots = fixed > SMEM_LIMIT
    if idx_slots:
        fixed = _WARPS * tile
    if fixed > SMEM_LIMIT:
        raise ValueError(f"ball_group kernel: rows of {3 + F} elements exceed the "
                         f"shared memory")
    shared = fixed + 16 * N <= SMEM_LIMIT
    smem = fixed + (16 * N if shared else 0)
    stage_feats = shared and F > 0 and smem + N * F * esize <= SMEM_LIMIT
    if stage_feats:
        smem += N * F * esize
    resident = max(1, min(_BLOCKS_PER_SM, _SMEM_SM // (smem + 1024)))
    blocks = max(1, min(-(-resident * SMS // B), S // _WARPS))
    per_block = -(-S // blocks)
    blocks = -(-S // per_block)
    route = ("shared" if shared else "global") + ("-idx" if idx_slots else "")
    return BallPlan(route, _WARPS * 32, per_block, blocks, tile, stage_feats, smem)


def ball_group_reference(xyz, feats, new_xyz, mask, k: int, radius: float):
    """Plain PyTorch version of the kernel; same arguments and results as
    `ball_group`. Differentiable through its gathers by autograd."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=xyz.device)
    acc = penalised_sqdist(xyz, new_xyz, mask)
    idx, valid = first_k_in_ball(acc <= r2, k)
    centred = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if feats is None:
        return centred, idx, valid
    grouped = torch.cat([centred.to(feats.dtype), index_points(feats, idx)], -1)
    return grouped, idx, valid


@functools.cache
def _launcher():
    fn = _build.load("ball_group").ball_group_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _group(xyz, feats, new_xyz, mask, k: int, radius: float):
    """`ball_group` without its gradient: checks, then the kernel or the
    plain version."""
    if xyz.dim() != 3 or xyz.shape[2] != 3 or new_xyz.dim() != 3 \
            or new_xyz.shape[2] != 3 or new_xyz.shape[0] != xyz.shape[0]:
        raise ValueError(f"ball_group takes xyz (B, N, 3) and new_xyz (B, S, 3); "
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
        raise ValueError(f"ball_group needs k >= 1 and radius > 0; got k={k}, "
                         f"radius={radius}")
    devices = {t.device for t in (xyz, feats, new_xyz, mask) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"ball_group inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return ball_group_reference(xyz, feats, new_xyz, mask, k, radius)
    if device.type != "cuda":
        raise ValueError(f"ball_group runs on CPU or CUDA tensors, not {device}")
    if xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32 or (
            feats is not None and feats.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"ball_group kernel takes fp32 xyz and centroids and "
                        f"fp32/bf16 features; got {xyz.dtype}, {new_xyz.dtype}, "
                        f"{None if feats is None else feats.dtype}")
    if not all(t.is_contiguous() for t in (xyz, feats, new_xyz, mask)
               if t is not None):
        raise ValueError("ball_group kernel takes contiguous tensors")
    F = 0 if feats is None else feats.shape[2]
    dtype = torch.float32 if feats is None else feats.dtype
    plan = ball_group_plan(B, N, S, k, F, dtype)
    grouped = torch.empty((B, S, k, 3 + F), dtype=dtype, device=device)
    idx = torch.empty((B, S, k), dtype=torch.int32, device=device)
    valid = torch.empty((B, S, k), dtype=torch.bool, device=device)
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))  # exact in fp32

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch = _launcher()
    with torch.cuda.device(device):
        err = launch(
            xyz.data_ptr(), ptr(feats), int(dtype == torch.bfloat16),
            new_xyz.data_ptr(), ptr(mask), B, N, S, k, F, r2,
            grouped.data_ptr(), idx.data_ptr(), valid.data_ptr(), plan.per_block,
            plan.tile, int(plan.route.startswith("shared")), int(plan.stage_feats),
            int(plan.route.endswith("-idx")), plan.smem,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ball_group kernel launch failed: CUDA error {err}")
    ball_group.launches += 1
    return grouped, idx, valid


class _BallGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, feats, new_xyz, mask, k, radius):
        grouped, idx, valid = _group(xyz, feats, new_xyz, mask, k, radius)
        ctx.save_for_backward(idx)
        ctx.n_points = xyz.shape[1]
        ctx.feat_dtype = None if feats is None else feats.dtype
        ctx.mark_non_differentiable(idx, valid)
        return grouped, idx, valid

    @staticmethod
    def backward(ctx, dg, didx, dvalid):
        del didx, dvalid
        (idx,) = ctx.saved_tensors
        B, S, k = idx.shape
        need_xyz, need_feats, need_new = ctx.needs_input_grad[:3]
        d_xyz = d_feats = d_new = None
        if need_new:  # the centring: every slot subtracts its centroid
            d_new = -dg[..., :3].float().sum(dim=2)
        if need_xyz or need_feats:
            # bf16 features: the cotangent is scattered as bf16 rows (fp32
            # sums), as the JAX package does
            rows = dg.reshape(B, S * k, -1).to(
                torch.bfloat16 if ctx.feat_dtype == torch.bfloat16
                else torch.float32)
            scat = scatter_rows(rows.contiguous(), idx.reshape(B, S * k),
                                ctx.n_points)
            if need_xyz:
                d_xyz = scat[..., :3]
            if need_feats:
                d_feats = scat[..., 3:].to(ctx.feat_dtype)
        return d_xyz, d_feats, d_new, None, None, None


def ball_group(xyz, feats, new_xyz, mask, k: int, radius: float):
    """Group the first k points within `radius` of each centroid.

    xyz (B, N, 3) fp32, feats (B, N, F) fp32 or bf16 or None, new_xyz
    (B, S, 3) fp32 centroids, mask (B, N) bool (True = valid) or None.
    Returns grouped (B, S, k, 3+F) in the features' dtype (fp32 without
    features) holding [xyz[idx] - centroid | feats[idx]], idx (B, S, k)
    int32 and valid (B, S, k) bool (slot inside the ball).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes contiguous tensors; anything else raises.
    `ball_group.launches` counts the kernel's launches.

    Differentiable in xyz, feats and new_xyz (the selection is not): the
    cotangent of `grouped` goes back onto the points through one
    `scatter_rows` (deterministic), and minus its xyz channels summed over k
    to the centroids; only the gradients that are needed are formed.
    """
    return _BallGroup.apply(xyz, feats, new_xyz, mask, k, radius)


ball_group.launches = 0
