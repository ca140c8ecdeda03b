"""PointNet++ encoders (port of pointcloud_tpu/models/pointnet2.py:38-331).

Three set-abstraction (SA) levels: FPS-downsample, ball-query group, a
shared MLP over each neighbourhood, max-pool per group. FPS and the ball
grouping are the port's CUDA kernels (ops/fps.py, ops/ball_group.py). The
per-group MLP is a bias-free Dense stack with BatchNorm: in eval on the
running statistics, plain matmuls as the JAX package leaves them to XLA; in
train mode on the batch statistics through `mlp_pool_fused`
(ops/preextract_fused.py), the fused Dense-BN-ReLU-pool chain.

In train mode the JAX package takes its fused kernels only on a TPU above
1e7 grouped elements (pointnet2.py:127-129), a threshold measured there.
Here the device decides: CUDA tensors always run the kernels, CPU tensors the
plain version. BatchNorm statistics in train mode include masked rows, as in
the JAX package.

Parameters carry the flax names: `w{i}` (cin, co) in flax's layout (not
transposed), `scale{i}`, `offset{i}`, and buffers `mean{i}`, `var{i}`; the
levels are `SetAbstraction_0..2`.

The multi-scale-grouping (MSG) level, `SetAbstractionMsg`, runs one FPS and
several ball groupings through `group_neighbors` (the `group_gather`
kernel), each branch a Dense (with bias) + BatchNorm + ReLU stack of flax
layers ending in a `DenseBNMaxPool` (the `dense_pool_stats` kernels in train
mode); `PointNet2MSGEncoder` stacks two of them and a group-all level.
"""

from __future__ import annotations

import torch
from torch import nn

from pointcloud_tpu_torch.models.layers import BatchNorm, ChainLayers, Dense
from pointcloud_tpu_torch.models.pointnet import (
    DenseBNMaxPool,
    check_train_mask_contract,
)
from pointcloud_tpu_torch.ops.fps import farthest_point_sample
from pointcloud_tpu_torch.ops.geometry import (
    group_neighbors,
    index_points,
    sample_and_group,
    sample_and_group_all,
)
from pointcloud_tpu_torch.utils.profiling import span

_NEG = -1e9


class SetAbstraction(ChainLayers):
    """One SA level: `group` (FPS + ball grouping, or the whole cloud when
    `group_all`), then `pool` (the shared MLP and the masked max over each
    group). `in_channels` is 3 + the features' width."""

    def __init__(self, npoint: int | None, radius: float | None,
                 nsample: int | None, in_channels: int, mlp,
                 group_all: bool = False, dtype=None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.dtype = dtype
        self.register_chain(list(zip((in_channels, *mlp[:-1]), mlp)))

    def group(self, xyz, features, mask=None):
        """(new_xyz, grouped (B, S, K, Cin), group_mask, new_mask)."""
        if self.dtype is not None and features is not None:
            features = features.to(self.dtype)
        if self.group_all:
            return sample_and_group_all(xyz, features, mask=mask)
        return sample_and_group(self.npoint, self.radius, self.nsample, xyz,
                                features, mask=mask)

    def pool(self, grouped, group_mask):
        """The shared MLP on every grouped row and the max over each group
        (`chain_pool`, then its ReLU): (B, S, K, Cin) -> (B, S, C_last),
        -1e9 on groups without a valid row."""
        B, S, K, cin = grouped.shape
        dt = self.dtype or grouped.dtype
        pen = torch.where(group_mask.reshape(B, S * K), 0.0, 1e9)
        return self.chain_pool(grouped.reshape(B, S * K, cin).to(dt), pen, K)

    def pool_train(self, grouped, group_mask):
        """`pool` on the batch statistics, through `mlp_pool_fused`
        (`chain_pool_train`)."""
        B, S, K, cin = grouped.shape
        dt = self.dtype or grouped.dtype
        pen = torch.where(group_mask.reshape(B, S * K), 0.0, 1e9)
        return self.chain_pool_train(grouped.reshape(B, S * K, cin).to(dt), pen, K)

    def forward(self, xyz, features, train: bool = False, mask=None):
        new_xyz, grouped, group_mask, new_mask = self.group(xyz, features, mask)
        pool = self.pool_train if train else self.pool
        return new_xyz, pool(grouped, group_mask), new_mask


class PointNet2Encoder(nn.Module):
    """PointNet++ SSG global encoder -> (B, 1024).

    Input (B, N, space_dims + feature_dims); xyz drives the geometry, the
    other dims ride along as features.
    """

    ENCODING_DIM = 1024
    NSAMPLE_0 = 32  # neighbours per group at the first level

    def __init__(self, space_dims: int = 3, feature_dims: int = 3, dtype=None):
        super().__init__()
        self.space_dims = space_dims
        self.feature_dims = feature_dims
        self.SetAbstraction_0 = SetAbstraction(
            512, 0.2, self.NSAMPLE_0, 3 + feature_dims, (64, 64, 128), dtype=dtype)
        self.SetAbstraction_1 = SetAbstraction(
            128, 0.4, 64, 3 + 128, (128, 128, 256), dtype=dtype)
        self.SetAbstraction_2 = SetAbstraction(
            None, None, None, 3 + 256, (256, 512, 1024), group_all=True,
            dtype=dtype)
        self._spans = tuple(f"encoder.SetAbstraction_{i}" for i in range(3))

    def forward(self, x, train: bool = False, mask=None):
        check_train_mask_contract(train, mask)
        xyz = x[..., : self.space_dims]
        feats = x[..., self.space_dims :] if self.feature_dims > 0 else None
        for i in range(3):
            with span(self._spans[i], device=True):
                xyz, feats, mask = getattr(self, f"SetAbstraction_{i}")(
                    xyz, feats, train=train, mask=mask)
        return feats[:, 0, :]  # (B, 1024)


class PointNet2SSGEncoder(PointNet2Encoder):
    """The alternative SSG classification encoder (port of
    pointcloud_tpu/models/pointnet2.py:270-296): k=64 at the first level,
    xyz always the first three dims. Not in `backbone_factory`, as in the
    JAX package."""

    NSAMPLE_0 = 64

    def __init__(self, space_dims: int = 3, feature_dims: int = 3, dtype=None):
        if space_dims != 3:
            raise ValueError("PointNet2SSGEncoder reads xyz from the first 3 dims")
        super().__init__(3, feature_dims, dtype)


class SetAbstractionMsg(nn.Module):
    """Multi-scale-grouping SA level (port of pointcloud_tpu/models/
    pointnet2.py:179-235): one FPS, then per (radius, nsample, mlp) branch a
    ball grouping, [features | centred xyz] through Dense + BatchNorm + ReLU
    layers and a last `DenseBNMaxPool` over each group; the branches' pooled
    features concatenate. `in_features` is the width of the features (0
    without). Children carry flax's compact names, numbered across the
    branches: `Dense_{i}`, `BatchNorm_{i}` for the hidden layers,
    `DenseBNMaxPool_{b}` for each branch's last."""

    def __init__(self, npoint: int, radius_list, nsample_list, in_features: int,
                 mlp_list, dtype=None):
        super().__init__()
        if not len(radius_list) == len(nsample_list) == len(mlp_list):
            raise ValueError("one radius, nsample and mlp per branch")
        self.npoint = npoint
        self.radius_list, self.nsample_list = tuple(radius_list), tuple(nsample_list)
        self.dtype = dtype
        self.hidden = []  # per branch: its hidden layers' indices
        i = 0
        for b, mlp in enumerate(mlp_list):
            cin = in_features + 3
            layers = []
            for f in mlp[:-1]:
                self.add_module(f"Dense_{i}", Dense(cin, f, dtype=dtype))
                self.add_module(f"BatchNorm_{i}", BatchNorm(f, dtype=dtype))
                layers.append(i)
                cin, i = f, i + 1
            self.hidden.append(layers)
            self.add_module(f"DenseBNMaxPool_{b}", DenseBNMaxPool(
                cin, mlp[-1], final_relu=True, dtype=dtype))
        self.out_features = sum(mlp[-1] for mlp in mlp_list)

    def forward(self, xyz, features, train: bool = False, mask=None):
        xyz = xyz.float().contiguous()
        fps_idx = farthest_point_sample(xyz, self.npoint, mask=mask)
        new_xyz = index_points(xyz, fps_idx)
        new_mask = (torch.gather(mask, 1, fps_idx.long()) if mask is not None
                    else torch.ones(fps_idx.shape, dtype=torch.bool,
                                    device=xyz.device))
        if features is not None:  # cast (as flax does) and laid out once
            features = features.to(self.dtype or features.dtype).contiguous()
        pooled = []
        for b, (radius, nsample) in enumerate(zip(self.radius_list,
                                                   self.nsample_list)):
            gxyz, gfeat, _, in_ball = group_neighbors(
                xyz, features, new_xyz, nsample, radius=radius, mask=mask)
            h = gxyz - new_xyz[:, :, None, :]
            if gfeat is not None:  # bf16 features meet fp32 xyz in fp32
                h = torch.cat([gfeat, h], dim=-1)
            for i in self.hidden[b]:
                h = torch.relu(getattr(self, f"BatchNorm_{i}")(
                    getattr(self, f"Dense_{i}")(h), train=train))
            pooled.append(getattr(self, f"DenseBNMaxPool_{b}")(
                h, train=train, mask=in_ball & new_mask[..., None]))
        return new_xyz, torch.cat(pooled, dim=-1), new_mask


class PointNet2MSGEncoder(nn.Module):
    """Multi-scale-grouping classification encoder (port of
    pointcloud_tpu/models/pointnet2.py:299-331): two MSG levels, then a
    group-all SA level -> (B, 1024). xyz is the first three dims, the rest
    (`feature_dims` of them) ride along as features. Like the JAX module it
    does not check the train-mode mask contract, and it is not in
    `backbone_factory`."""

    ENCODING_DIM = 1024
    LEVELS = ("SetAbstractionMsg_0", "SetAbstractionMsg_1", "SetAbstraction_0")

    def __init__(self, space_dims: int = 3, feature_dims: int = 3, dtype=None):
        super().__init__()
        if space_dims != 3:
            raise ValueError("PointNet2MSGEncoder reads xyz from the first 3 dims")
        self.feature_dims = feature_dims
        self.SetAbstractionMsg_0 = SetAbstractionMsg(
            512, (0.1, 0.2, 0.4), (16, 32, 128), feature_dims,
            ((32, 32, 64), (64, 64, 128), (64, 96, 128)), dtype=dtype)
        self.SetAbstractionMsg_1 = SetAbstractionMsg(
            128, (0.2, 0.4, 0.8), (32, 64, 128),
            self.SetAbstractionMsg_0.out_features,
            ((64, 64, 128), (128, 128, 256), (128, 128, 256)), dtype=dtype)
        self.SetAbstraction_0 = SetAbstraction(
            None, None, None, 3 + self.SetAbstractionMsg_1.out_features,
            (256, 512, 1024), group_all=True, dtype=dtype)
        self._spans = tuple(f"encoder.{level}" for level in self.LEVELS)

    def forward(self, x, train: bool = False, mask=None):
        if x.shape[-1] != 3 + self.feature_dims:
            raise ValueError(f"PointNet2MSGEncoder takes 3 + {self.feature_dims} "
                             f"dims a point; got {x.shape[-1]}")
        xyz = x[..., :3]
        feats = x[..., 3:] if x.shape[-1] > 3 else None
        for level, name in zip(self.LEVELS, self._spans):
            with span(name, device=True):
                xyz, feats, mask = getattr(self, level)(xyz, feats, train=train, mask=mask)
        return feats[:, 0, :]  # (B, 1024)
