"""Ball query + centred gather: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_group_ball_smajor_kernel
(`grouped_gather_ball`). The kernel is csrc/ball_group.cu; its note states
the design and the bound. `ball_group` launches it for CUDA tensors and
takes the plain version `ball_group_reference` only for CPU tensors. Its
gradient (a port of `_gg_ball_bwd`) is one `scatter_rows` of the grouped
cotangent back onto the points, on either device.

Membership follows the TPU kernel: ((pen + dx^2) + dy^2) + dz^2 <= r2 on
direct differences, pen = 1e9 on masked points, r2 = float32(radius**2)
taken in double. (The JAX package's XLA `ball_query` uses the matmul
expansion instead, which can flip a point within a few ulps of the radius.)
The TPU kernel's limits (k % 8 == 0, k <= 256, N <= 16384) come from its
VMEM and bf16 index channels and do not apply here: any k >= 1 and any N.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops.geometry import (
    first_k_in_ball,
    index_points,
    penalised_sqdist,
)
from pointcloud_tpu_torch.ops.scatter_rows import scatter_rows

_MAX_BATCH = 65535  # gridDim.y


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
                   + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 4)
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
    if not (1 <= B <= _MAX_BATCH and N >= 1 and S >= 1):
        raise ValueError(f"ball_group kernel bounds exceeded: B={B} N={N} S={S}")

    F = 0 if feats is None else feats.shape[2]
    dtype = torch.float32 if feats is None else feats.dtype
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
            grouped.data_ptr(), idx.data_ptr(), valid.data_ptr(),
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
