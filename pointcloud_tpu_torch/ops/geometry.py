"""Pairwise distances (port of pointcloud_tpu/ops/geometry.py:27-56).

Layout is channels-last, as in the JAX package: src (..., N, C),
dst (..., M, C) -> (..., N, M).
"""

from __future__ import annotations

import torch

_BIG = 1e10  # used instead of +inf, as in the JAX package


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
