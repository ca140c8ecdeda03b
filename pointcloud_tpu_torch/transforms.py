"""Point-cloud transforms (port of pointcloud_tpu/transforms.py:127-155).

A transform is a callable `(pc, mask=None) -> (pc, mask)`. Where the JAX
package maps a single-cloud transform over the batch with `jax.vmap`, these
act on any leading dimensions: pc (..., N, D), mask (..., N) bool.
"""

from __future__ import annotations

import torch


def _ensure_mask(pc, mask):
    if mask is None:
        return torch.ones(pc.shape[:-1], dtype=torch.bool, device=pc.device)
    return mask


class _BBoxAffine:
    def __init__(self, bbox, dim: int = 3):
        self.bbox = torch.tensor(bbox, dtype=torch.float32)[:dim]
        self.dim = dim
        self._on_device = {}  # device -> (lo, span): one host copy each

    def _lo_span(self, pc):
        if pc.device not in self._on_device:
            bbox = self.bbox.to(pc.device)
            self._on_device[pc.device] = (bbox[:, 0], bbox[:, 1] - bbox[:, 0])
        return self._on_device[pc.device]


class Normalize(_BBoxAffine):
    """Map the first `dim` coords from bbox to the unit cube."""

    def __call__(self, pc, mask=None):
        mask = _ensure_mask(pc, mask)
        lo, span = self._lo_span(pc)
        xyz = (pc[..., : self.dim] - lo) / span
        return torch.cat([xyz, pc[..., self.dim :]], dim=-1), mask


class Unnormalize(_BBoxAffine):
    """Inverse of Normalize."""

    def __call__(self, pc, mask=None):
        mask = _ensure_mask(pc, mask)
        lo, span = self._lo_span(pc)
        xyz = pc[..., : self.dim] * span + lo
        return torch.cat([xyz, pc[..., self.dim :]], dim=-1), mask
