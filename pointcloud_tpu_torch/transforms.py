"""Point-cloud transforms (port of pointcloud_tpu/transforms.py:40-55,
:77-155, :219-226).

A transform is a callable `(pc, mask=None) -> (pc, mask)`. Where the JAX
package maps a single-cloud transform over the batch with `jax.vmap`, these
act on any leading dimensions: pc (..., N, D), mask (..., N) bool. Filters
clear mask bits and keep every row; samplers take the mask and return a
fixed-size, fully valid cloud. The sensor's chain is
Compose([FilterBBox(bbox), SampleFurthestPoints(K)]).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from pointcloud_tpu_torch.ops.fps import farthest_point_sample
from pointcloud_tpu_torch.ops.geometry import index_points


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


class Compose:
    """Chain transforms."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, pc, mask=None):
        mask = _ensure_mask(pc, mask)
        for t in self.transforms:
            pc, mask = t(pc, mask)
        return pc, mask


class FilterBBox:
    """Mask out points outside a 3D bounding box, bbox (3, 2) of (min, max)
    per axis."""

    def __init__(self, bbox):
        self.bbox = torch.tensor(bbox, dtype=torch.float32)

    def __call__(self, pc, mask=None):
        mask = _ensure_mask(pc, mask)
        bbox = self.bbox.to(pc.device)
        xyz = pc[..., :3]
        inside = torch.all((xyz >= bbox[:, 0]) & (xyz <= bbox[:, 1]), dim=-1)
        return pc, mask & inside


class SampleFurthestPoints:
    """FPS-downsample to exactly K valid points (ops/fps.py)."""

    def __init__(self, K: int):
        self.K = K

    def __call__(self, pc, mask=None):
        mask = _ensure_mask(pc, mask)
        lead, (N, D) = pc.shape[:-2], pc.shape[-2:]
        flat = pc.reshape(-1, N, D)
        xyz = flat[..., :3].float().contiguous()
        idx = farthest_point_sample(xyz, self.K, mask=mask.reshape(-1, N).contiguous())
        out = index_points(flat, idx)
        ones = torch.ones((*lead, self.K), dtype=torch.bool, device=pc.device)
        return out.reshape(*lead, self.K, D), ones


def apply_np(transform, pc: np.ndarray, mask=None, seed: int = 0):
    """Numpy edge wrapper: run a transform (or Compose) on CPU tensors made
    from numpy data and return numpy (pc, mask). Where the JAX version takes
    a PRNG key from `seed`, this seeds PyTorch's CPU generator for the call
    (forked, so the caller's random state is left as it was)."""
    pc_t = torch.as_tensor(np.asarray(pc))
    mask_t = None if mask is None else torch.as_tensor(np.asarray(mask))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        out_pc, out_mask = transform(pc_t, mask_t)
    return out_pc.numpy(), out_mask.numpy()
