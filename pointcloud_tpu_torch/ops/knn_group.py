"""Exact kNN grouping with the row gather: CUDA kernel, plain version,
wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_group_knn_smajor_kernel, both
entry points: `grouped_gather_knn` (grouped xyz and features) and
`grouped_gather_knn_feats` (features only, the LocalGrouper path). The
kernel is csrc/knn_group.cu; its note states the design and the bound.
`knn_group` launches it for CUDA tensors and takes the plain version
`knn_group_reference` only for CPU tensors. Its gradient (a port of
`_gg_knn_bwd` / `_gg_knnf_bwd`) is one `scatter_rows` of the grouped
cotangent back onto the points, on either device.

Selection follows the TPU kernel: the distance is ((pen + dx^2) + dy^2) +
dz^2 on direct differences (centroid minus point), pen = 1e9 on masked
points; slot order is distance order with the lowest index first on ties;
the valid count is the number of distances below 0.5e9, and slots past it
repeat slot 0. (The JAX package's XLA `knn` uses the matmul expansion, which
can swap points whose distances lie within a few ulps.) The TPU kernel's
`k % 8 == 0` gate was an 8-slot store alignment of its VMEM tiles and does
not apply here: any k >= 1 and any N. In bf16 the TPU kernel carries the
grouped xyz as split-bf16 hi + lo (16 significant bits); the port gathers it
exactly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops.geometry import index_points, penalised_sqdist
from pointcloud_tpu_torch.ops.scatter_rows import scatter_grouped

_PEN = 1e9
_MAX_BATCH = 65535  # gridDim.y
_MAX_POINTS = 1 << 30  # N stays a C int with room for the chunk arithmetic


def knn_select(d, k: int):
    """The TPU kernel's selection from penalised distances d (B, S, N):
    idx (B, S, k) int32 in distance order, the lowest index first on ties
    (a stable sort), slots past the count of d < 0.5e9 repeating slot 0."""
    N = d.shape[-1]
    order = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    if k > N:
        order = torch.cat([order, order[..., :1].expand(*order.shape[:-1], k - N)], -1)
    count = (d < 0.5 * _PEN).sum(dim=-1, keepdim=True)
    slots = torch.arange(k, device=d.device)
    return torch.where(slots < count, order, order[..., :1]).int()


def knn_group_reference(xyz, feats, new_xyz, mask, k: int, with_xyz: bool = False):
    """Plain PyTorch version of the kernel; same arguments and results as
    `knn_group`. Differentiable through its gathers by autograd."""
    idx = knn_select(penalised_sqdist(xyz, new_xyz, mask), k)
    gx = index_points(xyz, idx) if with_xyz else None
    gf = None if feats is None else index_points(feats, idx)
    return gx, gf, idx


@functools.cache
def _launcher():
    fn = _build.load("knn_group").knn_group_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def _group(xyz, feats, new_xyz, mask, k: int, with_xyz: bool):
    """`knn_group` without its gradient: checks, then the kernel or the
    plain version."""
    if xyz.dim() != 3 or xyz.shape[2] != 3 or new_xyz.dim() != 3 \
            or new_xyz.shape[2] != 3 or new_xyz.shape[0] != xyz.shape[0]:
        raise ValueError(f"knn_group takes xyz (B, N, 3) and new_xyz (B, S, 3); "
                         f"got {tuple(xyz.shape)} and {tuple(new_xyz.shape)}")
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if feats is not None and (feats.dim() != 3 or feats.shape[:2] != (B, N)):
        raise ValueError(f"feats must be (B, N, F) = ({B}, {N}, F); got "
                         f"{tuple(feats.shape)}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (B, N)):
        raise ValueError(f"mask must be bool of shape {(B, N)}; got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if k < 1:
        raise ValueError(f"knn_group needs k >= 1; got k={k}")
    devices = {t.device for t in (xyz, feats, new_xyz, mask) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"knn_group inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return knn_group_reference(xyz, feats, new_xyz, mask, k, with_xyz)
    if device.type != "cuda":
        raise ValueError(f"knn_group runs on CPU or CUDA tensors, not {device}")
    if xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32 or (
            feats is not None and feats.dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"knn_group kernel takes fp32 xyz and centroids and "
                        f"fp32/bf16 features; got {xyz.dtype}, {new_xyz.dtype}, "
                        f"{None if feats is None else feats.dtype}")
    if not all(t.is_contiguous() for t in (xyz, feats, new_xyz, mask)
               if t is not None):
        raise ValueError("knn_group kernel takes contiguous tensors")
    if not (1 <= B <= _MAX_BATCH and 1 <= N < _MAX_POINTS and S >= 1):
        raise ValueError(f"knn_group kernel bounds exceeded: B={B} N={N} S={S}")

    F = 0 if feats is None else feats.shape[2]
    idx = torch.empty((B, S, k), dtype=torch.int32, device=device)
    gx = (torch.empty((B, S, k, 3), dtype=torch.float32, device=device)
          if with_xyz else None)
    gf = (None if feats is None
          else torch.empty((B, S, k, F), dtype=feats.dtype, device=device))
    esize = 4 if feats is None else feats.element_size()
    vec = int(F > 0 and (F * esize) % 16 == 0 and feats.data_ptr() % 16 == 0
              and gf.data_ptr() % 16 == 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch = _launcher()
    with torch.cuda.device(device):
        err = launch(
            xyz.data_ptr(), ptr(feats), esize, new_xyz.data_ptr(), ptr(mask),
            B, N, S, k, F, vec, idx.data_ptr(), ptr(gx), ptr(gf),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_group kernel launch failed: CUDA error {err}")
    knn_group.launches += 1
    return gx, gf, idx


class _KnnGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, feats, new_xyz, mask, k, with_xyz):
        gx, gf, idx = _group(xyz, feats, new_xyz, mask, k, with_xyz)
        ctx.save_for_backward(idx)
        ctx.n_points = xyz.shape[1]
        ctx.with_xyz = with_xyz
        ctx.feat_dtype = None if feats is None else feats.dtype
        ctx.mark_non_differentiable(idx)
        return gx, gf, idx

    @staticmethod
    def backward(ctx, dgx, dgf, didx):
        del didx
        (idx,) = ctx.saved_tensors
        B, S, k = idx.shape
        # xyz gets the scatter of d grouped_xyz, or no gradient without that
        # output; new_xyz none: the selection is not differentiable
        with_xyz = ctx.with_xyz and ctx.needs_input_grad[0]
        with_feats = ctx.feat_dtype is not None and ctx.needs_input_grad[1]
        d_xyz, d_feats = scatter_grouped(idx, ctx.n_points,
                                         dgx if with_xyz else None,
                                         dgf if with_feats else None,
                                         ctx.feat_dtype)
        return d_xyz, d_feats, None, None, None, None


def knn_group(xyz, feats, new_xyz, mask, k: int, with_xyz: bool = False):
    """Group the k nearest points of each centroid.

    xyz (B, N, 3) fp32, feats (B, N, F) fp32 or bf16 or None, new_xyz
    (B, S, 3) fp32 centroids, mask (B, N) bool (True = valid) or None.
    Returns (grouped_xyz (B, S, k, 3) fp32, not centred, or None unless
    `with_xyz`; grouped_feats (B, S, k, F) in the features' dtype or None
    without features; idx (B, S, k) int32).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes contiguous tensors; anything else raises.
    `knn_group.launches` counts the kernel's launches.

    Differentiable in xyz and feats (the selection is not; new_xyz gets no
    gradient): the cotangents of the gathered rows go back onto the points
    through one `scatter_rows` (deterministic).
    """
    return _KnnGroup.apply(xyz, feats, new_xyz, mask, k, with_xyz)


knn_group.launches = 0
