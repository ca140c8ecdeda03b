"""Chamfer distance with masks (port of pointcloud_tpu/ops/chamfer.py).

The pytorch3d convention, as in the JAX package:

    cham(x, y) = batch_mean( point_mean_i min_j ||x_i - y_j||^2 )
               + batch_mean( point_mean_j min_i ||x_i - y_j||^2 )

with optional bool validity masks (B, N) / (B, M): masked points neither
compete as targets nor count in the point means.

The 'matmul' method goes through `nn_sweep` (the CUDA kernel on the card, its
plain version on the CPU), so the (B, N, M) cost matrix is never stored on
the card; its backward goes through `chamfer_bwd` at every size (the JAX
package's switch to gathers and segment-sums above 6 << 20 cost elements,
chamfer.py:105-110, came from the TPU kernel's VMEM; on the card the fused
kernel is the faster route on both sides of it). The JAX package's ring
routing of giant clouds
across chips (chamfer.py:249-257) is not ported: this function always runs
on one device.
"""

from __future__ import annotations

import torch

from pointcloud_tpu_torch.ops.chamfer_bwd import chamfer_bwd
from pointcloud_tpu_torch.ops.geometry import _BIG, pairwise_sqdist
from pointcloud_tpu_torch.ops.nn_sweep import MAX_DIMS, nn_sweep


def _masked_mean(values, mask, dim: int):
    if mask is None:
        return torch.mean(values, dim=dim)
    mask = mask.to(values.dtype)
    total = torch.sum(values * mask, dim=dim)
    count = torch.clamp(torch.sum(mask, dim=dim), min=1.0)
    return total / count


class _NearestNeighborDists(torch.autograd.Function):
    """nn_sweep forward; the backward routes each cotangent through the
    matched pair (pointcloud_tpu/ops/chamfer.py:84-138, :194)."""

    @staticmethod
    def forward(ctx, x, y, x_mask, y_mask):
        min_x, amin_x, min_y, amin_y = nn_sweep(x, y, x_mask, y_mask)
        ctx.save_for_backward(x, y, amin_x, amin_y, x_mask, y_mask)
        return min_x, min_y

    @staticmethod
    def backward(ctx, gx, gy):
        x, y, amin_x, amin_y, x_mask, y_mask = ctx.saved_tensors
        # masked rows carry 1e10 distances; their cotangents are zero in the
        # Chamfer means, and are zeroed here as in the JAX package
        if x_mask is not None:
            gx = gx * x_mask
        if y_mask is not None:
            gy = gy * y_mask
        dx, dy = chamfer_bwd(x, y, gx.float().contiguous(), gy.float().contiguous(),
                             amin_x, amin_y)
        return dx.to(x.dtype), dy.to(y.dtype), None, None


def nearest_neighbor_dists(x, y, x_mask=None, y_mask=None):
    """(min_x (B, N), min_y (B, M)) squared nearest-neighbour distances of
    x (B, N, C) and y (B, M, C), C <= 8, under bool validity masks, with
    gradients to x and y (none to the masks)."""
    return _NearestNeighborDists.apply(x, y, x_mask, y_mask)


def masked_chamfer(x, y, x_mask=None, y_mask=None, method: str = "matmul"):
    """Per-batch-element directed chamfer means.

    x: (B, N, C), y: (B, M, C). Returns (cham_x (B,), cham_y (B,)).
    method: 'matmul' (nn_sweep) or 'direct' (exact squared differences over
    the dense cost matrix). C > 8 always takes the dense path.
    """
    if method == "direct" or x.shape[-1] > MAX_DIMS:
        d = pairwise_sqdist(x, y, method=method)  # (B, N, M)
        d_for_x = d if y_mask is None else d.masked_fill(~y_mask[:, None, :], _BIG)
        d_for_y = d if x_mask is None else d.masked_fill(~x_mask[:, :, None], _BIG)
        min_x = torch.amin(d_for_x, dim=2)
        min_y = torch.amin(d_for_y, dim=1)
    elif method == "matmul":
        min_x, min_y = nearest_neighbor_dists(x, y, x_mask, y_mask)
    else:
        raise ValueError(f"unknown method {method!r}")
    cham_x = _masked_mean(min_x, x_mask, dim=1)
    cham_y = _masked_mean(min_y, y_mask, dim=1)
    return cham_x, cham_y


def chamfer_distance(
    x,
    y,
    x_mask=None,
    y_mask=None,
    batch_reduction: str | None = "mean",
    method: str = "matmul",
):
    """pytorch3d-compatible chamfer loss (scalar by default).

    batch_reduction: 'mean' | 'sum' | None (None returns (B,) per element).
    """
    cham_x, cham_y = masked_chamfer(x, y, x_mask, y_mask, method=method)
    per_batch = cham_x + cham_y
    if batch_reduction == "mean":
        return torch.mean(per_batch)
    if batch_reduction == "sum":
        return torch.sum(per_batch)
    if batch_reduction is None:
        return per_batch
    raise ValueError(f"unknown batch_reduction {batch_reduction!r}")
