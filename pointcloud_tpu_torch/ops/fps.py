"""Farthest-point sampling: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/fps.py (`farthest_point_sample`,
`farthest_point_sample_xyz`) with the semantics of its TPU kernel
(pointcloud_tpu/ops/pallas_kernels.py:_fps_kernel): distances use the first
3 dims; selection starts at point 0 if it is valid, else at the first valid
point; the running minimum distance `mind` starts at 1e10 on valid points
and -1 on masked ones, which stay at -1; the argmax takes the lowest index
on ties; a cloud with fewer valid points than `npoint` repeats valid points.
A cloud with no valid point gives index 0 in every slot (the TPU kernel
writes N, out of range, in slot 0).

The kernels are csrc/fps.cu; its note states the design and the bound.
`farthest_point_sample` launches one for CUDA tensors, on the route
`fps_plan` picks from the shape alone, and takes the plain version
`fps_reference` only for CPU tensors.

FPS is chaotic: one flipped near-tie changes every later index. Both
versions compute the squared distance as separate rounded operations in the
TPU kernel's order, ((dx*dx + dy*dy) + dz*dz), so they give equal indices.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops.geometry import index_points

_MAX_POINTS = 1 << 29  # N and the scratch's 4N floats stay C ints
_MAX_SLOTS = 24  # points a thread keeps in registers (csrc/fps.cu kMaxSlots)
_BLOCK_THREADS = (64, 128, 256, 512)  # the block route's block sizes
_CLUSTER_THREADS = 512  # (csrc/fps.cu kClusterThreads)
_BLOCK_POINTS = _CLUSTER_THREADS * _MAX_SLOTS  # 12,288: a block's points
_CLUSTER_MAX = 16  # blocks of a cluster (a non-portable size above 8)
_SCRATCH_THREADS = 1024
_ROUTES = ("block", "cluster", "scratch")  # csrc/fps.cu kRoute*


class FpsPlan(NamedTuple):
    """The route and launch geometry of one `farthest_point_sample` call."""
    route: str  # "block", "cluster" or "scratch"
    threads: int  # threads of a block
    slots: int  # points a thread keeps in registers (0 on the scratch route)
    cluster: int  # blocks a cloud (1 but on the cluster route)
    per_block: int  # points a block owns
    smem: int  # dynamic shared memory of a block, bytes
    scratch_floats: int  # floats of global scratch a cloud (scratch route)


@functools.lru_cache(maxsize=256)
def fps_plan(B: int, N: int) -> FpsPlan:
    """The kernel route for B clouds of N points (csrc/fps.cu):

    - block (N <= 12,288): one block per cloud, (x, y, z, mind) in
      registers, `slots` points a thread, and the coordinates in shared
      memory (12 bytes a point): the smallest block (64, 128, 256 or 512
      threads) that gives each thread at most 8 points (4 up to 1,024
      points), and the fewest slots, a multiple of 4 and at most 24, that
      cover the cloud (PointNet2's SA1 and PointMLP's stage 1, N = 2048:
      256 x 8; N = 512: 128 x 4; N = 256: 64 x 4); a step's pass over the
      slots is its longest part, so more warps of fewer slots won where
      chip_smoke.py --kernel-times compared them; many clouds fill the
      card (PointNet2's levels, the MSG levels), one (`encode`) runs on
      one SM;
    - cluster (N <= 16 x 12,288 = 196,608, the sensor's cloud): one cloud
      over a thread block cluster of ceil(N / 12,288) blocks of 512 threads,
      the points split evenly, each block's slice in registers (24 points a
      thread) and its coordinates in shared memory (12 bytes a point);
    - scratch (larger N): one block per cloud over an L2-resident global
      scratch of 16 bytes a point.

    Shapes no route takes (B < 1, N < 1, N >= 2^29) raise ValueError. The
    choice depends on the shape alone; a launch the card refuses raises and
    never falls through to another route."""
    if not (B >= 1 and 1 <= N < _MAX_POINTS):
        raise ValueError(f"farthest_point_sample kernel bounds exceeded: B={B} N={N}")
    if N <= _BLOCK_POINTS:
        per = 4 if N <= 1024 else 8
        threads = next((t for t in _BLOCK_THREADS if t * per >= N), _BLOCK_THREADS[-1])
        slots = -(-N // (4 * threads)) * 4
        return FpsPlan("block", threads, slots, 1, N, 12 * N, 0)
    if N <= _CLUSTER_MAX * _BLOCK_POINTS:
        cl = -(-N // _BLOCK_POINTS)
        per = -(-N // cl)
        return FpsPlan("cluster", _CLUSTER_THREADS, _MAX_SLOTS, cl, per, 12 * per, 0)
    return FpsPlan("scratch", _SCRATCH_THREADS, 0, 1, N, 0, 4 * N)


def _first_valid(valid):
    """Index of the first valid point of each cloud, 0 where there is none."""
    n = valid.shape[1]
    ids = torch.arange(n, device=valid.device).expand_as(valid)
    first = torch.where(valid, ids, n).amin(dim=1)
    return torch.where(first == n, 0, first)


def fps_reference(xyz, npoint: int, mask=None):
    """Plain PyTorch version: the TPU kernel's loop, one step per selected
    point. xyz (B, N, C >= 3), mask (B, N) bool -> int32 (B, npoint)."""
    B, N, _ = xyz.shape
    x, y, z = (xyz[..., c].float() for c in range(3))
    valid = (torch.ones((B, N), dtype=torch.bool, device=xyz.device)
             if mask is None else mask)
    mind = torch.where(valid, 1e10, -1.0)
    ids = torch.arange(N, device=xyz.device).expand(B, N)
    rows = torch.arange(B, device=xyz.device)
    last = _first_valid(valid)
    out = [last]
    for _ in range(1, npoint):
        dx = x - x[rows, last, None]
        dy = y - y[rows, last, None]
        dz = z - z[rows, last, None]
        d = (dx * dx + dy * dy) + dz * dz
        mind = torch.where(valid, torch.minimum(mind, d), -1.0)
        top = mind.amax(dim=1, keepdim=True)
        last = torch.where(mind == top, ids, N).amin(dim=1)
        out.append(last)
    return torch.stack(out, dim=1).int()


@functools.cache
def _library():
    lib = _build.load("fps")
    lib.fps_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                               + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3)
    lib.fps_launch.restype = ctypes.c_int
    return lib


def farthest_point_sample(xyz, npoint: int, mask=None):
    """Select `npoint` indices spreading maximally over each cloud.

    xyz (B, N, C >= 3), mask (B, N) bool (True = valid) or None. Returns
    int32 (B, npoint). CPU tensors take the plain version. CUDA tensors
    launch the kernel on `fps_plan(B, N)`'s route, which takes contiguous
    fp32 clouds; anything else raises. `farthest_point_sample.launches`
    counts the kernel's launches.
    """
    if xyz.dim() != 3 or xyz.shape[2] < 3:
        raise ValueError(f"farthest_point_sample takes xyz (B, N, C >= 3); "
                         f"got {tuple(xyz.shape)}")
    B, N, C = xyz.shape
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (B, N)):
        raise ValueError(f"mask must be bool of shape {(B, N)}; got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if npoint < 1:
        raise ValueError(f"npoint must be >= 1; got {npoint}")
    devices = {t.device for t in (xyz, mask) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"farthest_point_sample inputs lie on several "
                         f"devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return fps_reference(xyz, npoint, mask)
    if device.type != "cuda":
        raise ValueError(f"farthest_point_sample runs on CPU or CUDA tensors, "
                         f"not {device}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"farthest_point_sample kernel takes fp32; got {xyz.dtype}")
    if not all(t.is_contiguous() for t in (xyz, mask) if t is not None):
        raise ValueError("farthest_point_sample kernel takes contiguous tensors")
    plan = fps_plan(B, N)

    out = torch.empty((B, npoint), dtype=torch.int32, device=device)
    lib = _library()
    work = (torch.empty((B, plan.scratch_floats), dtype=torch.float32, device=device)
            if plan.scratch_floats else None)
    with torch.cuda.device(device):
        err = lib.fps_launch(
            xyz.data_ptr(), C, None if mask is None else mask.data_ptr(),
            B, N, npoint, _ROUTES.index(plan.route), plan.threads, plan.slots,
            plan.cluster, plan.per_block, None if work is None else work.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"farthest_point_sample kernel launch failed on the "
                           f"{plan.route} route: CUDA error {err}")
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0


def farthest_point_sample_xyz(xyz, npoint: int, mask=None):
    """(sampled points (B, npoint, C), indices (B, npoint)), as
    pytorch3d.ops.sample_farthest_points returns them."""
    idx = farthest_point_sample(xyz, npoint, mask=mask)
    return index_points(xyz, idx), idx
