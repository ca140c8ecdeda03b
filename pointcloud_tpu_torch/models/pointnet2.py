"""PointNet++ encoders (port of pointcloud_tpu/models/pointnet2.py:38-176,
:238-296).

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
"""

from __future__ import annotations

import torch
from torch import nn

from pointcloud_tpu_torch.models.layers import lecun_normal_, update_chain_stats
from pointcloud_tpu_torch.models.pointnet import check_train_mask_contract
from pointcloud_tpu_torch.ops.geometry import sample_and_group, sample_and_group_all
from pointcloud_tpu_torch.ops.preextract_fused import mlp_pool_fused

_NEG = -1e9
EPS = 1e-5  # BatchNorm epsilon of the JAX package's SA levels


class SetAbstraction(nn.Module):
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
        self.n_layers = len(mlp)
        cin = in_channels
        for i, co in enumerate(mlp):
            self.register_parameter(f"w{i}", nn.Parameter(torch.empty(cin, co)))
            self.register_parameter(f"scale{i}", nn.Parameter(torch.empty(co)))
            self.register_parameter(f"offset{i}", nn.Parameter(torch.empty(co)))
            self.register_buffer(f"mean{i}", torch.empty(co))
            self.register_buffer(f"var{i}", torch.empty(co))
            cin = co

    def reset_parameters(self, generator: torch.Generator):
        for i in range(self.n_layers):
            w = getattr(self, f"w{i}")
            lecun_normal_(w, generator, fan_in=w.shape[0])
            nn.init.ones_(getattr(self, f"scale{i}"))
            nn.init.zeros_(getattr(self, f"offset{i}"))
            nn.init.zeros_(getattr(self, f"mean{i}"))
            nn.init.ones_(getattr(self, f"var{i}"))

    def group(self, xyz, features, mask=None):
        """(new_xyz, grouped (B, S, K, Cin), group_mask, new_mask)."""
        if self.dtype is not None and features is not None:
            features = features.to(self.dtype)
        if self.group_all:
            return sample_and_group_all(xyz, features, mask=mask)
        return sample_and_group(self.npoint, self.radius, self.nsample, xyz,
                                features, mask=mask)

    def pool(self, grouped, group_mask):
        """The shared MLP on every grouped row and the max over each group:
        (B, S, K, Cin) -> (B, S, C_last), -1e9 on groups without a valid
        row. Each layer's product is rounded to the activation dtype, its
        BatchNorm (running statistics) is fp32, and ReLU(pre) in the
        activation dtype feeds the next layer; the last layer's max is taken
        before its ReLU, over pre - 1e9 on invalid rows."""
        B, S, K, cin = grouped.shape
        dt = self.dtype or grouped.dtype
        a = grouped.reshape(B, S * K, cin).to(dt)
        for i in range(self.n_layers):
            if i:
                a = torch.relu(pre).to(dt)
            h = torch.matmul(a, getattr(self, f"w{i}").to(dt))
            mul = torch.rsqrt(getattr(self, f"var{i}") + EPS) * getattr(self, f"scale{i}")
            # h.float() is h itself in fp32; nothing else reads h
            pre = h.float().sub_(getattr(self, f"mean{i}")).mul_(mul).add_(
                getattr(self, f"offset{i}"))
        pen = torch.where(group_mask.reshape(B, S * K), 0.0, 1e9)
        mx = torch.amax(pre.sub_(pen[..., None]).reshape(B, S, K, -1), dim=2)
        out = torch.relu(mx).masked_fill_(mx < -5e8, _NEG)
        return out.to(dt)

    def pool_train(self, grouped, group_mask):
        """`pool` on the batch statistics, through `mlp_pool_fused`; the
        running statistics move to 0.9 old + 0.1 new (biased variance), in
        place."""
        B, S, K, cin = grouped.shape
        dt = self.dtype or grouped.dtype
        pen = torch.where(group_mask.reshape(B, S * K), 0.0, 1e9)
        ws, scales, offsets = (
            [getattr(self, f"{name}{i}") for i in range(self.n_layers)]
            for name in ("w", "scale", "offset"))
        out, stats = mlp_pool_fused(grouped.reshape(B, S * K, cin).to(dt), ws,
                                    scales, offsets, pen, K)
        update_chain_stats(self, stats, B * S * K)
        return out.to(dt)

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

    def forward(self, x, train: bool = False, mask=None):
        check_train_mask_contract(train, mask)
        xyz = x[..., : self.space_dims]
        feats = x[..., self.space_dims :] if self.feature_dims > 0 else None
        for i in range(3):
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
