"""Point-cloud transforms (port of pointcloud_tpu/transforms.py).

A transform is a callable `(pc, mask=None) -> (pc, mask)`. Where the JAX
package maps a single-cloud transform over the batch with `jax.vmap`, these
act on any leading dimensions: pc (..., N, D), mask (..., N) bool. Filters
(FilterBBox, FilterClasses) clear mask bits and keep every row; samplers
(SampleFurthestPoints, SampleRandomPoints) take the mask and return a
fixed-size, fully valid cloud. The sensor's chain is
Compose([FilterBBox(bbox), SampleFurthestPoints(K)]).

Where a JAX transform draws from a PRNG key, SampleRandomPoints draws from
an explicit torch.Generator on the cloud's device; the two generators give
other numbers, so its tests compare supports and distributions.
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


class SampleRandomPoints:
    """Uniformly sample K points, with replacement, among the valid rows of
    each cloud, drawing from `generator` (a torch.Generator on the cloud's
    device; the global generator is never used). A cloud without a valid
    row gives its row 0 K times, as the JAX version does (a categorical
    draw over all -inf logits picks index 0)."""

    def __init__(self, K: int, generator: torch.Generator | None = None):
        self.K = K
        self.generator = generator

    def __call__(self, pc, mask=None):
        if self.generator is None:
            raise ValueError("SampleRandomPoints requires a torch.Generator")
        mask = _ensure_mask(pc, mask)
        lead, (N, D) = pc.shape[:-2], pc.shape[-2:]
        flat = pc.reshape(-1, N, D)
        weights = mask.reshape(-1, N).float()
        weights[:, 0] += (~mask.reshape(-1, N).any(dim=1)).float()
        idx = torch.multinomial(weights, self.K, replacement=True,
                                generator=self.generator)
        out = index_points(flat, idx)
        ones = torch.ones((*lead, self.K), dtype=torch.bool, device=pc.device)
        return out.reshape(*lead, self.K, D), ones


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


class FilterClasses:
    """Keep only points whose integer label (column `seg_dim`, truncated to
    int32) is whitelisted."""

    def __init__(self, whitelist: Sequence[int], seg_dim: int):
        self.whitelist = tuple(whitelist)
        self.seg_dim = seg_dim

    def __call__(self, pc, mask=None):
        mask = _ensure_mask(pc, mask)
        label = pc[..., self.seg_dim].to(torch.int32)
        keep = torch.zeros_like(mask)
        for w in self.whitelist:
            keep = keep | (label == w)
        return pc, mask & keep


class OneHotEncode:
    """The integer label column at `seg_dim` -> `num_classes` one-hot
    columns appended after the other columns (a label outside
    [0, num_classes) gives a zero row, as jax.nn.one_hot)."""

    def __init__(self, num_classes: int, seg_dim: int):
        self.num_classes = num_classes
        self.seg_dim = seg_dim

    def __call__(self, pc, mask=None):
        mask = _ensure_mask(pc, mask)
        label = pc[..., self.seg_dim].to(torch.int32)
        ids = torch.arange(self.num_classes, dtype=torch.int32, device=pc.device)
        onehot = (label[..., None] == ids).to(pc.dtype)
        rest = torch.cat([pc[..., : self.seg_dim], pc[..., self.seg_dim + 1 :]],
                         dim=-1)
        return torch.cat([rest, onehot], dim=-1), mask


class IntegerEncode:
    """One-hot (or logit) columns starting at `seg_dim` -> one integer
    column (the first maximal class), which replaces them and every column
    after them."""

    def __init__(self, num_classes: int, seg_dim: int):
        self.num_classes = num_classes
        self.seg_dim = seg_dim

    def __call__(self, pc, mask=None):
        mask = _ensure_mask(pc, mask)
        probs = pc[..., self.seg_dim : self.seg_dim + self.num_classes]
        label = torch.argmax(probs, dim=-1).to(pc.dtype)
        return torch.cat([pc[..., : self.seg_dim], label[..., None]], dim=-1), mask


def class_mean_pos(pc, cls: int, seg_dim: int, mask=None):
    """The centroid of the valid points of class `cls` (label at column
    `seg_dim`): pc (..., N, D) -> (..., 3); the origin for a cloud without
    such a point."""
    mask = _ensure_mask(pc, mask)
    sel = mask & (pc[..., seg_dim].to(torch.int32) == cls)
    w = sel.to(pc.dtype)
    count = torch.sum(w, dim=-1)
    from pointcloud_tpu_torch import cfg

    if cfg.debug:
        print(f"DEBUG: class_mean_pos cls={cls} count={count.tolist()}")
    total = torch.sum(pc[..., :3] * w[..., None], dim=-2)
    return total / torch.clamp(count, min=1.0)[..., None]


def seg_to_color(labels, class_colors):
    """Integer labels (any shape) -> their classes' RGB colours (..., 3)."""
    colors = torch.as_tensor(class_colors, dtype=torch.float32, device=labels.device)
    return colors[labels.to(torch.int64)]


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


def sensor_chain(bbox, K: int, sampler: str | None, seed: int, device) -> Compose:
    """The sensor's chain: FilterBBox(bbox), then SampleFurthestPoints(K)
    ('FPS'), SampleRandomPoints(K) on a torch.Generator on `device` seeded
    with `seed` ('RS'), or nothing (None: the filter alone). The JAX package
    takes a PRNG key from `seed` where this seeds the generator."""
    stages = [FilterBBox(bbox)]
    if sampler == "FPS":
        stages.append(SampleFurthestPoints(K))
    elif sampler == "RS":
        generator = torch.Generator(device=device).manual_seed(seed)
        stages.append(SampleRandomPoints(K, generator))
    return Compose(stages)
