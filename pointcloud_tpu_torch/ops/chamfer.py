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
kernel is the faster route on both sides of it).

Under a process group of more than one rank, `chamfer_distance` routes
clouds of RING_MIN_ELEMENTS cost elements or more to the point-sharded ring
(parallel/ring.py), as the JAX package does across chips
(chamfer.py:52-64, :249-257).
"""

from __future__ import annotations

import torch

from pointcloud_tpu_torch.ops.chamfer_bwd import chamfer_bwd
from pointcloud_tpu_torch.ops.geometry import _BIG, pairwise_sqdist
from pointcloud_tpu_torch.ops.nn_sweep import MAX_DIMS, nn_sweep
from pointcloud_tpu_torch.parallel.distributed import (
    all_gather_cat,
    batch_group,
    batch_world,
    gather_batch,
    rank,
    sum_cotangents,
    world_size,
)

# Size of the (B, N, M) cost tensor from which chamfer_distance and
# emd_match take the point-sharded ring when the group has more than one
# rank. The JAX package's 1 << 28 is a memory bound (~1 GB of fp32 cost
# matrix on one chip). On the card the one-device Chamfer streams through
# nn_sweep and stores no cost matrix at any size, so the ring is only a
# speed route, and its threshold comes from time. Measured on four H100s of
# one host (NVLink, `chip_smoke.py --multi-card`): one card's forward and
# backward take ~0.72 ps a pair (6.2 ms at B=2, N=M=65,536), while the
# ring over the four pays a near-fixed ~12-16 ms of exchanges (13.6 ms at
# 2.7e8 pairs, 18.2 ms at 8.6e9), so its saving (1 - 1/4) x 0.72 ps a pair
# overtakes that cost only from ~3e10 pairs: 1 << 35 (3.4e10). The JAX
# package's 1 << 28 would send 2.7e8-pair clouds to a ring 9x slower.
# Monkeypatched down by tests.
RING_MIN_ELEMENTS = 1 << 35


def ring_eligible(B: int, N: int, M: int, group=None) -> bool:
    """The ring route's test: `group` (the default group when None) has
    more than one rank and the cost tensor has RING_MIN_ELEMENTS elements
    or more. Divisibility does not matter: the ring pads N and M."""
    return world_size(group) > 1 and B * N * M >= RING_MIN_ELEMENTS


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
    Clouds whose (B, N, M) cost tensor reaches RING_MIN_ELEMENTS take the
    point-sharded ring when a group of more than one rank is active (C <=
    8, method 'matmul'): over the default group, every rank holding the
    same clouds; inside a data-parallel step (`sharded_batch`), over the
    batch's group, each rank holding its own slice of the global batch (B
    counts the global batch). Either way each cloud's value is the one this
    function gives on one device. The route is a collective: every rank of
    the group must make the same call, as every process of a multi-host JAX
    program runs the same computation.
    """
    group = batch_group()
    if method != "direct" and x.shape[-1] <= MAX_DIMS and ring_eligible(
            x.shape[0] * batch_world(), x.shape[1], y.shape[1], group):
        per_batch = _ring_route(x, y, x_mask, y_mask, group)
        return _reduce(per_batch, batch_reduction)
    cham_x, cham_y = masked_chamfer(x, y, x_mask, y_mask, method=method)
    return _reduce(cham_x + cham_y, batch_reduction)


def _ring_route(x, y, x_mask, y_mask, group):
    """(B,) per-cloud values through the ring. Without a batch group every
    rank holds the same clouds; with one, each rank holds its own slice of
    the batch: the ring runs over the global batch (gathered), every rank
    keeps its own clouds' values, and the cotangents of the ranks' values
    are summed before the ring's backward, which takes the same cotangent
    on every rank, so each rank's clouds get their own gradients."""
    from pointcloud_tpu_torch.parallel.ring import ring_chamfer

    if group is None:
        return ring_chamfer(x, y, x_mask=x_mask, y_mask=y_mask, batch_reduction=None)
    gx, gy = gather_batch(x, group), gather_batch(y, group)
    gxm = None if x_mask is None else all_gather_cat(x_mask, group, 0)
    gym = None if y_mask is None else all_gather_cat(y_mask, group, 0)
    per = sum_cotangents(ring_chamfer(gx, gy, group, gxm, gym, batch_reduction=None),
                         group)
    B = x.shape[0]
    r = rank(group)
    return per[r * B:(r + 1) * B]


def _reduce(per_batch, batch_reduction):
    if batch_reduction == "mean":
        return torch.mean(per_batch)
    if batch_reduction == "sum":
        return torch.sum(per_batch)
    if batch_reduction is None:
        return per_batch
    raise ValueError(f"unknown batch_reduction {batch_reduction!r}")
