"""Fixed-shape, mask-based geometry (port of pointcloud_tpu/ops/geometry.py):
pairwise distances, gathers, the kNN and ball queries, the neighbourhood
grouping, the set-abstraction grouping and the 3-NN interpolation.

Layout is channels-last, as in the JAX package: src (..., N, C),
dst (..., M, C) -> (..., N, M). Invalid points stay in the arrays and carry
mask=False.
"""

from __future__ import annotations

import torch

_BIG = 1e10  # used instead of +inf, as in the JAX package
_PEN = 1e9  # the TPU kernels' distance penalty on masked points


def pairwise_sqdist(
    src: torch.Tensor, dst: torch.Tensor, method: str = "matmul"
) -> torch.Tensor:
    """Pairwise squared euclidean distance.

    method='matmul' uses the expansion |x|^2 - 2<x,y> + |y|^2 in fp32,
    clamped at 0 to remove negative round-off; 'direct' sums the squared
    differences exactly. The matmul result is built in place, so the
    (..., N, M) tensor is allocated once.
    """
    if method == "direct":
        diff = src[..., :, None, :] - dst[..., None, :, :]
        return torch.sum(diff * diff, dim=-1)
    if method != "matmul":
        raise ValueError(f"unknown method {method!r}")
    src = src.float()
    dst = dst.float()
    s2 = torch.sum(src * src, dim=-1, keepdim=True)  # (..., N, 1)
    d2 = torch.sum(dst * dst, dim=-1, keepdim=True)  # (..., M, 1)
    # fp32 matmul: TF32 is off (cfg.py), so the cross term is full precision.
    # (-2c + s2) + d2 is bit for bit the reference's (s2 - 2c) + d2.
    d = torch.matmul(src, dst.transpose(-1, -2))
    return d.mul_(-2.0).add_(s2).add_(d2.transpose(-1, -2)).clamp_(min=0.0)


def index_points(points, idx):
    """Batched gather: points (B, N, C), idx (B, *I) int -> (B, *I, C)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1, 1).long().expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def penalised_sqdist(xyz, new_xyz, mask):
    """(B, S, N): ((pen + dx^2) + dy^2) + dz^2 on direct differences
    (centroid minus point), pen = 1e9 on masked points: the TPU grouping
    kernels' distance, in their order. xyz (B, N, 3), new_xyz (B, S, 3),
    mask (B, N) bool or None."""
    B, N, _ = xyz.shape
    acc = (torch.zeros((B, 1, N), device=xyz.device) if mask is None
           else torch.where(mask, 0.0, _PEN)[:, None, :])
    for c in range(3):
        dc = new_xyz[..., c, None] - xyz[:, None, :, c]  # (B, S, N)
        acc = acc + dc * dc
    return acc


def first_k_in_ball(in_ball, k: int):
    """The first k True positions along the last axis, in index order.

    in_ball (..., N) bool -> (idx (..., k) int32, valid (..., k) bool). Slots
    past the True count repeat slot 0; with no True position every slot is
    0 (the reference's pad-with-first, pointnet2_utils.py:93-113).
    """
    n = in_ball.shape[-1]
    ids = torch.arange(n, dtype=torch.int32, device=in_ball.device)
    key = torch.where(in_ball, ids, n)
    first = torch.topk(key, min(k, n), dim=-1, largest=False, sorted=True).values
    if k > n:
        first = torch.cat([first, first.new_full((*first.shape[:-1], k - n), n)], -1)
    valid = first < n
    slot0 = torch.where(valid[..., :1], first[..., :1], 0)
    return torch.where(valid, first, slot0).int(), valid


def knn(k: int, xyz, new_xyz, mask=None, approx=None):
    """The k nearest neighbours of each query in `new_xyz` among `xyz`, as
    the JAX package's XLA path computes them (the matmul expansion of the
    distance): (idx (B, S, k) int32, sqdists (B, S, k)).

    xyz (B, N, C), new_xyz (B, S, C), mask (B, N) bool (True = valid).
    Masked points get the distance 1e10 and never win over a valid one; the
    slots of a cloud with fewer than k valid points repeat slot 0, index and
    distance. Slot order is distance order with the lowest index first on
    ties (a stable sort: torch.topk does not promise that order). `approx`
    (the TPU's approx_max_k) has no counterpart here and raises.
    `group_neighbors` takes the kNN kernel instead, whose direct differences
    follow the TPU kernel.
    """
    if approx:
        raise NotImplementedError(
            "approx=True selects with the TPU's approx_max_k, which has no "
            "PyTorch counterpart; the port's kNN is exact")
    if k > xyz.shape[1]:
        raise ValueError(f"knn needs k <= N; got k={k}, N={xyz.shape[1]}")
    d = pairwise_sqdist(new_xyz, xyz)  # (B, S, N)
    if mask is not None:
        d = torch.where(mask[..., None, :], d, _BIG)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    dist, idx = dist[..., :k], idx[..., :k]
    if mask is not None:  # under-full clouds: the empty slots repeat slot 0
        under = dist >= _BIG
        idx = torch.where(under, idx[..., :1], idx)
        dist = torch.where(under, dist[..., :1], dist)
    return idx.int(), dist


def ball_query(radius: float, k: int, xyz, new_xyz, mask=None):
    """Indices of up to `k` points of `xyz` within `radius` of each query,
    as the JAX package's XLA path computes them (the matmul expansion of
    the distance): (idx (B, S, k) int32, in_ball (B, S, k) bool), the first
    k in-radius points by index order, padded with the first.

    The set-abstraction grouping (`sample_and_group`) takes `ball_group`
    instead, whose direct differences follow the TPU kernel.
    """
    valid = pairwise_sqdist(new_xyz, xyz) <= radius * radius
    if mask is not None:
        valid = valid & mask[..., None, :]
    return first_k_in_ball(valid, k)


def group_neighbors(xyz, feats, new_xyz, k: int, radius=None, mask=None,
                    with_xyz: bool = True):
    """Neighbourhood grouping and gather in one step: kNN through the
    `knn_group` kernel, a ball (`radius` set) through the `group_gather`
    kernel.

    xyz (B, N, 3), feats (B, N, F) or None, new_xyz (B, S, 3) queries, mask
    (B, N) bool or None. Returns (grouped_xyz (B, S, k, 3), not centred, or
    None when `with_xyz` is False; grouped_feats (B, S, k, F) or None;
    idx (B, S, k) int32; valid (B, S, k) bool: all True in kNN mode, the
    in-ball flag in ball mode).

    kNN: slots in distance order, the lowest index first on ties. Ball: the
    first k in-radius points by index order, slots past the in-ball count
    repeating slot 0 (point 0 in an empty ball). Both select on direct
    differences with masked points 1e9 away, as the TPU kernels do. Every
    k >= 1 goes to the kernels, on any N (`knn_group` past its list's 64
    slots by its rounds route, `group_gather` past the 1,806 slots its
    shared memory holds with the slots in the idx output): the JAX
    package's `k % 8` gate (geometry.py:201-202) and ball limits (k <= 256,
    N <= 16384) came from the TPU kernels' tiles and bf16 index channels.
    Past those limits, and for `feats=None`, the JAX package takes its XLA
    `ball_query` (the matmul expansion of the distance), which can differ
    from the direct differences for a point within a few ulps of the radius.
    """
    # imported here: the kernel modules import this one
    from pointcloud_tpu_torch.ops.group_gather import group_gather
    from pointcloud_tpu_torch.ops.knn_group import knn_group

    args = (xyz[..., :3].float().contiguous(),
            None if feats is None else feats.contiguous(),
            new_xyz[..., :3].float().contiguous(),
            None if mask is None else mask.contiguous(), k)
    if radius is None:
        gx, gf, idx = knn_group(*args, with_xyz)
        valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    else:
        gx, gf, idx, valid = group_gather(*args, float(radius), with_xyz)
    return None if gx is None else gx.to(xyz.dtype), gf, idx, valid


def sample_and_group(npoint: int, radius: float, nsample: int, xyz, features,
                     mask=None, use_knn: bool = False):
    """FPS-downsample, then group each centroid's ball (set-abstraction
    input).

    xyz (B, N, 3), features (B, N, F) or None, mask (B, N) bool. Returns
      new_xyz (B, npoint, 3): the FPS centroids,
      grouped (B, npoint, nsample, 3+F): centred xyz (+ features), in the
        features' dtype,
      group_mask (B, npoint, nsample) bool,
      new_mask (B, npoint) bool.
    The ball grouping goes through `ball_group`, whose centred xyz is
    rounded to the features' dtype; `use_knn` groups the nsample nearest
    points through `group_neighbors` instead, and the centred xyz and the
    features are concatenated in their promoted dtype, as in the JAX
    package.
    """
    # imported here: both kernel modules import this one
    from pointcloud_tpu_torch.ops.ball_group import ball_group
    from pointcloud_tpu_torch.ops.fps import farthest_point_sample

    xyz = xyz.float().contiguous()
    fps_idx = farthest_point_sample(xyz, npoint, mask=mask)
    new_xyz = index_points(xyz, fps_idx)
    if mask is not None:
        new_mask = torch.gather(mask, 1, fps_idx.long())
    else:
        new_mask = torch.ones(fps_idx.shape, dtype=torch.bool, device=xyz.device)
    if use_knn:
        grouped_xyz, grouped_feat, _, valid = group_neighbors(
            xyz, features, new_xyz, nsample, mask=mask)
        grouped = grouped_xyz - new_xyz[:, :, None, :]
        if grouped_feat is not None:
            grouped = torch.cat([grouped, grouped_feat], dim=-1)
        return new_xyz, grouped, valid & new_mask[..., None], new_mask
    grouped, _, valid = ball_group(
        xyz, None if features is None else features.contiguous(), new_xyz,
        None if mask is None else mask.contiguous(), nsample, radius)
    return new_xyz, grouped, valid & new_mask[..., None], new_mask


def sample_and_group_all(xyz, features, mask=None):
    """The whole cloud as one neighbourhood at the origin: new_xyz (B, 1, 3)
    zeros, grouped (B, 1, N, 3+F), group_mask (B, 1, N), new_mask (B, 1)."""
    B, N, _ = xyz.shape
    new_xyz = torch.zeros((B, 1, 3), dtype=xyz.dtype, device=xyz.device)
    grouped = xyz[:, None]
    if features is not None:
        grouped = torch.cat([grouped, features[:, None]], dim=-1)
    group_mask = (torch.ones((B, 1, N), dtype=torch.bool, device=xyz.device)
                  if mask is None else mask[:, None, :])
    return (new_xyz, grouped, group_mask,
            torch.ones((B, 1), dtype=torch.bool, device=xyz.device))


def three_nn_interpolate(xyz_to, xyz_from, features_from, mask_from=None,
                         eps: float = 1e-8):
    """Inverse-distance-weighted 3-NN feature upsampling (the JAX package's
    op of the same name, XLA there: plain PyTorch here). xyz_to (B, N, 3),
    xyz_from (B, S, 3), features_from (B, S, F) -> (B, N, F)."""
    idx, d = knn(3, xyz_from, xyz_to, mask=mask_from)  # (B, N, 3)
    w = 1.0 / (d + eps)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    neighbors = index_points(features_from, idx)  # (B, N, 3, F)
    return torch.sum(neighbors * w[..., None], dim=-2)
