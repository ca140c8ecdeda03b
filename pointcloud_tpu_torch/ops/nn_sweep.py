"""Bidirectional nearest-neighbour sweep: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_nn_kernel
(`nearest_neighbor_pallas`). The kernel is csrc/nn_sweep.cu; its note states
the design and the bound. `nn_sweep` launches it for CUDA tensors, on the
geometry `nn_plan` gives, and takes the plain version `nn_sweep_reference`
only for CPU tensors.

Both return (min_x (B,N) f32, amin_x (B,N) i32, min_y (B,M) f32,
amin_y (B,M) i32): each point's squared distance to its nearest valid
counterpart over all C dims and that counterpart's first index. A point with
no valid counterpart gets 1e10 and index 0; a masked point gets +1e10 on its
own value, as the TPU kernel's +BIG on s2/d2 does.

The kernel forms every pair's cost as one bf16 tensor-core product of
three-way-split operands, both clouds centred on the point `nn_centre`
picks; `nn_operands` is the plain mirror of those operands (the same split
and layout).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT, SMS, sm_count
from pointcloud_tpu_torch.ops.geometry import _BIG, pairwise_sqdist

MAX_DIMS = 8  # C <= 8, as the TPU kernel
_MAX_BATCH = 65535  # gridDim.y
_MAX_POINTS = 1 << 30  # keeps every int32 index and offset in range
_WARPGROUPS = 4  # csrc/nn_sweep.cu kWarpgroups: query tiles in flight a block
_ROWS = 64  # query rows a tile (wgmma M)
_COLS = 128  # target columns a product (wgmma N); a chunk is whole products


class NnPlan(NamedTuple):
    """The launch geometry of one `nn_sweep` call (csrc/nn_sweep.cu)."""
    depth: int  # K: bf16 columns of an operand row, 6C + 6 padded to 16
    chunk: int  # targets a block keeps in shared memory at a time
    chunks: int  # chunks of the longer cloud (1: every target resident)
    splits: int  # blocks that share a direction of one batch element
    blocks: int  # blocks of the launch (2 B splits)
    smem: int  # dynamic shared memory of a block, bytes


def nn_depth(C: int) -> int:
    """K of the cost product: six split cross products a dimension and the
    two norms' three parts each, padded to a multiple of 16 (a wgmma step)."""
    return -(-(6 * C + 6) // 16) * 16


def _smem(C: int, chunk: int) -> int:
    # the target chunk, one 64-row query tile a warpgroup, the chunk's mask
    # words (4 a 128-column product), 1024 bytes of alignment slack
    K = nn_depth(C)
    return chunk * 2 * K + _WARPGROUPS * _ROWS * 2 * K + chunk // _COLS * 16 + 1024


@functools.lru_cache(maxsize=256)
def nn_plan(B: int, N: int, M: int, C: int, sms: int = SMS) -> NnPlan:
    """The kernel's geometry for x (B, N, C) against y (B, M, C).

    A block keeps up to `chunk` targets' operand rows (2K bytes each) in
    shared memory: the longer cloud rounded up to whole 128-column products,
    at most what fits beside the warpgroups' query tiles (2,048 at C = 5-7,
    1,536 at C = 8, 3,328 at C = 2-4, 6,912 at C = 1); a longer cloud is
    swept in several chunks. The query tiles of a direction and batch
    element are shared by `splits` blocks: the count whose waves (one block
    an SM) times a block's work is least, the fewest blocks on a tie; a
    block's work is its tiles a warpgroup plus half a tile for staging the
    targets (about a tenth in instructions, the rest the loads' latency).
    Shapes no plan takes (C outside 1-8, B past 65,535, empty or too long
    clouds) raise ValueError."""
    if not (1 <= C <= MAX_DIMS and 1 <= B <= _MAX_BATCH and 1 <= N <= _MAX_POINTS
            and 1 <= M <= _MAX_POINTS and sms >= 1):
        raise ValueError(f"nn_sweep kernel bounds exceeded: B={B} N={N} M={M} C={C}")
    K = nn_depth(C)
    most = (SMEM_LIMIT - _smem(C, 0)) // (2 * K * _COLS + 16) * _COLS
    chunk = min(most, -(-max(N, M) // _COLS) * _COLS)
    tiles = -(-max(N, M) // _ROWS)
    best = None
    for s in range(1, -(-tiles // _WARPGROUPS) + 1):
        cost = -(-2 * B * s // sms) * (-(-tiles // (_WARPGROUPS * s)) + 0.5)
        if best is None or cost < best[0]:
            best = (cost, s)
    splits = best[1]
    return NnPlan(K, chunk, -(-max(N, M) // chunk), splits, 2 * B * splits,
                  _smem(C, chunk))


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


def _split3(v):
    """v (fp32) = hi + mid + lo, each rounded to bf16 in turn."""
    h = v.to(torch.bfloat16)
    r = v - h.float()
    m = r.to(torch.bfloat16)
    return h, m, (r - m.float()).to(torch.bfloat16)


def nn_centre(x, y, x_mask=None, y_mask=None):
    """The point (B, C) the kernel centres both clouds on: x's first valid
    point, else y's first valid point, else x's first point. A masked
    point's coordinates thus never enter a valid pair's error, which grows
    with the centred norms."""
    B, N, _ = x.shape
    M = y.shape[1]

    def first(mask, n):  # first valid index, n where none is valid
        if mask is None:
            return torch.zeros(B, dtype=torch.long, device=x.device)
        ids = torch.arange(n, device=mask.device).expand_as(mask)
        return torch.where(mask, ids, n).amin(dim=1)

    rows = torch.arange(B, device=x.device)
    fx, fy = first(x_mask, N), first(y_mask, M)
    centre = torch.where((fy < M)[:, None], y[rows, fy.clamp(max=M - 1)], x[:, 0])
    return torch.where((fx < N)[:, None], x[rows, fx.clamp(max=N - 1)], centre)


def nn_operands(q, t, ref):
    """The kernel's bf16 operands for queries q (B, N, C) and targets t
    (B, M, C), both centred on ref (B, C) (the kernel's is `nn_centre`):
    A (B, N, K) and T (B, M, K) with A @ T^T = |q|^2 + |t|^2 - 2 q.t up to
    the split's dropped products. A query row holds, per dimension c at 6c,
    -2v split as (h, h, h, m, m, l), then (n h, n m, n l, 1, 1, 1); a target
    row (h, m, l, h, m, h) of v, then (1, 1, 1, n h, n m, n l); v = point -
    ref and n = |v|^2 summed in dimension order, in fp32 as the kernel."""
    B, _, C = q.shape
    K = nn_depth(C)

    def rows(p, query):
        v = p.float() - ref.float()[:, None, :]
        n2 = torch.zeros(v.shape[:2], dtype=torch.float32, device=v.device)
        for c in range(C):
            n2 = n2 + v[..., c] * v[..., c]
        h, m, lo = _split3(-2.0 * v if query else v)
        cols = ([h, h, h, m, m, lo] if query else [h, m, lo, h, m, h])
        per_dim = torch.stack(cols, dim=-1).reshape(*v.shape[:2], 6 * C)
        nh, nm, nl = _split3(n2)
        one = torch.ones_like(nh)
        norms = torch.stack([nh, nm, nl, one, one, one] if query
                            else [one, one, one, nh, nm, nl], dim=-1)
        pad = torch.zeros((*v.shape[:2], K - 6 * C - 6), dtype=torch.bfloat16,
                          device=v.device)
        return torch.cat([per_dim, norms, pad], dim=-1)

    return rows(q, True), rows(t, False)


@functools.cache
def _launcher():
    fn = _build.load("nn_sweep").nn_sweep_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    Both pick the first index among equal costs after clamping them at 0;
    the kernel's costs differ from the plain version's within the
    expansion's rounding, so near-ties may resolve otherwise.
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
    plan = nn_plan(B, N, M, C, sm_count(device.index))

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
            B, N, M, C, plan.chunk, plan.splits, plan.smem,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_sweep kernel launch failed: CUDA error {err}")
    nn_sweep.launches += 1
    return min_x, amin_x, min_y, amin_y


nn_sweep.launches = 0

