"""PointNet encoder (port of pointcloud_tpu/models/pointnet.py).

A spatial transformer (STN) predicts a 3x3 transform for the xyz coords
(the other feature dims pass through), a 64-d feature STN transforms
mid-level features, then a shared MLP with BatchNorm and a global max-pool
give the 1024-d encoding. Layout is channels-last (B, N, C); the shared
per-point layers are Dense layers over the last axis.

Child modules carry the flax names (`Dense_0`, `BatchNorm_1`,
`PointwiseMLP_0`, ...), so a state_dict key is the flax path of the same
variable (interop.py).

In eval, DenseBNMaxPool takes the plain matmul + pool, as the JAX package
does. In train mode it always goes through `dense_pool_stats` (the CUDA
kernels on the card, the plain version on the CPU): the JAX package's 2e8
element threshold (pointnet.py:189-197) was measured on a TPU and does not
carry over. MLPChainPool, off PointNetEncoder's path as in the JAX
package, runs its whole chain through `mlp_pool_fused` in train mode.
BatchNorm statistics in train mode include masked points, as in
the JAX package (check_train_mask_contract).
"""

from __future__ import annotations

import torch
from torch import nn

from pointcloud_tpu_torch.models.layers import (
    BatchNorm,
    ChainLayers,
    Dense,
    batch_stats,
    lecun_normal_,
    update_running_stats,
)
from pointcloud_tpu_torch.ops.dense_bn_pool import dense_pool_stats
from pointcloud_tpu_torch.parallel.distributed import batch_group, batch_sum, batch_world

# Large negative value for the masked max-pool (valid activations are far
# smaller in magnitude).
_NEG = -1e9


def check_train_mask_contract(train: bool, mask) -> None:
    """Document and, under cfg.debug, check the BatchNorm/mask contract.

    BatchNorm batch statistics do NOT respect validity masks: in train mode
    every point (masked or not) contributes to the mean and variance. That is
    right for the supported training pipeline (samplers re-densify clouds
    before they reach a model, and the train step passes no mask) but wrong
    for a masked training pipeline, so under cfg.debug a train-mode forward
    with a mask warns. (Max-pools and grouping do respect masks; only the
    BatchNorm statistics do not.)
    """
    if train and mask is not None:
        from pointcloud_tpu_torch import cfg

        if cfg.debug:
            import warnings

            warnings.warn(
                "training-mode forward with a validity mask: BatchNorm "
                "statistics will include masked-out points (documented "
                "model contract — re-densify with a sampler before "
                "training instead)",
                stacklevel=3,
            )


def masked_max(x, mask, dim: int):
    """Global max-pool that ignores masked-out points."""
    if mask is not None:
        x = x.masked_fill(~mask.unsqueeze(-1), _NEG)
    return torch.amax(x, dim=dim)


def _pool_select(z, mask, scale):
    """where(scale >= 0, max z, min z) over axis -2, masked points excluded.

    BatchNorm is a per-channel monotone affine map whose slope has the sign
    of `scale`, so pooling the raw z first and normalising the pooled values
    is exactly max(BN(z)). One aminmax pass reads z once.
    """
    if mask is not None:
        m = ~mask.unsqueeze(-1)
        pmax = torch.amax(z.masked_fill(m, _NEG), dim=-2)
        pmin = torch.amin(z.masked_fill(m, -_NEG), dim=-2)
    else:
        pmin, pmax = torch.aminmax(z, dim=-2)
    return torch.where(scale >= 0, pmax, pmin)


def _normalize_pooled(sel, mean, var, scale, offset, eps, dt, final_relu, mask):
    """The JAX package's normalisation of the pooled values, in `dt`, in its
    order: (sel - mean) * (rsqrt(var + eps) * scale) + offset."""
    y = sel.to(dt) - mean.to(dt)
    mul = torch.rsqrt(var.to(dt) + eps)
    y = y * (mul * scale.to(dt)) + offset.to(dt)
    if final_relu:
        y = torch.relu(y)
    if mask is not None:
        # all-masked rows keep the masked_max sentinel
        y = y.masked_fill(~torch.any(mask, dim=-1, keepdim=True), _NEG)
    return y


class BNMaxPool(BatchNorm):
    """BatchNorm + (optional ReLU) + max-pool over axis -2, pooled first.

    Exactly `max(where(mask, relu?(BatchNorm(x)), -1e9), axis=-2)`: with the
    running statistics in eval, with the batch statistics (all points,
    masked ones included) in train mode, which also updates the running
    ones. Rows whose mask is all False return -1e9. Its variables are
    BatchNorm's.
    """

    def __init__(self, features: int, final_relu: bool = False,
                 epsilon: float = 1e-5, dtype=None):
        super().__init__(features, dtype=dtype, epsilon=epsilon)
        self.final_relu = final_relu

    def forward(self, x, train: bool = False, mask=None):
        if train:
            mean, var = batch_stats(x)
            update_running_stats(self, mean, var)
        else:
            mean, var = self.mean, self.var
        sel = _pool_select(x, mask, self.scale)
        dt = self.dtype or sel.dtype
        return _normalize_pooled(sel, mean, var, self.scale, self.bias,
                                 self.epsilon, dt, self.final_relu, mask)


class DenseBNMaxPool(nn.Module):
    """Dense + BNMaxPool in one module: `BNMaxPool(final_relu)(Dense(x))`.

    Input (..., R, Cin): 3-D pools the whole R axis -> (..., C); 4-D
    (B, S, K, Cin) pools K per group -> (B, S, C). mask matches the input
    minus the channel dim. The BN parameters are `scale` and `offset`, the
    Dense bias is `bias`, as in flax; `use_bias=False` registers no bias
    (the flax tree has none) and the product takes a zero one. In train
    mode the product, the batch statistics (over all rows, masked ones
    included) and the pool come from `dense_pool_stats`, so the
    (..., R, C) pre-pool tensor is never stored.
    """

    def __init__(self, in_features: int, features: int,
                 final_relu: bool = False, epsilon: float = 1e-5, dtype=None,
                 use_bias: bool = True):
        super().__init__()
        self.final_relu = final_relu
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.scale = nn.Parameter(torch.empty(features))
        self.offset = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))

    def reset_parameters(self, generator: torch.Generator):
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.offset)
        nn.init.zeros_(self.mean)
        nn.init.ones_(self.var)

    def _bias(self, dt):
        if self.bias is None:
            return torch.zeros(self.weight.shape[0], dtype=dt, device=self.weight.device)
        return self.bias.to(dt)

    def forward(self, x, train: bool = False, mask=None):
        dt = self.dtype or x.dtype
        if not train:
            z = torch.nn.functional.linear(x.to(dt), self.weight.to(dt), self._bias(dt))
            sel = _pool_select(z, mask, self.scale)  # (*lead, C)
            return _normalize_pooled(sel, self.mean, self.var, self.scale,
                                     self.offset, self.epsilon, dt,
                                     self.final_relu, mask)

        C = self.weight.shape[0]
        lead = x.shape[:-2]
        pool = x.shape[-2]
        n_rows = x.numel() // x.shape[-1]  # all rows, masked ones included
        # (B, S, K, Cin): K-blocks within each batch row; (B, R, Cin): one
        # block spanning all R rows
        xr = x.reshape(x.shape[0], -1, x.shape[-1]) if x.dim() == 4 else x
        B2, R = xr.shape[:2]
        pen = (None if mask is None else torch.where(
            mask.reshape(B2, R), 0.0, 1e9).float())
        # the kernel pools sign*z once; un-signing is exact and equals
        # where(scale >= 0, max z, min z)
        sgn = torch.where(self.scale >= 0, 1.0, -1.0).float().detach()
        psel, _, ssum, ssq = dense_pool_stats(
            xr.to(dt).contiguous(), self.weight.t().to(dt).contiguous(),
            self._bias(dt), sgn, pen, pool)
        sel = (sgn.to(dt) * psel).reshape(*lead, C)
        if batch_group() is not None:
            # data parallelism: the global batch's sums and rows, between the
            # kernel and the affine step; the sign-pooled sel commutes with
            # the global affine, as with the local one
            ssum, ssq = batch_sum(torch.stack([ssum, ssq])).unbind(0)
            n_rows *= batch_world()
        mean = ssum / float(n_rows)
        var = torch.clamp(ssq / float(n_rows) - mean * mean, min=0.0)
        update_running_stats(self, mean, var)
        return _normalize_pooled(sel, mean, var, self.scale, self.offset,
                                 self.epsilon, dt, self.final_relu, mask)


class MLPChainPool(ChainLayers):
    """L Dense + BatchNorm (+ ReLU) layers, then a masked max-pool over the
    whole cloud: `PointwiseMLP(features[:-1])` and a bias-free
    `DenseBNMaxPool(features[-1], final_relu)` in one module. Each mid
    layer is Dense -> BatchNorm -> ReLU; the last layer's post-BN values
    before any ReLU are max-pooled over the points, and `final_relu`
    rectifies the pooled vector. The layers are ChainLayers' (flax's
    names, no Dense bias; BatchNorm momentum 0.9, epsilon 1e-5, as the JAX
    module's chain uses).

    Input (B, N, Cin) -> (B, features[-1]). Masked points stay out of the
    pool but feed the BatchNorm statistics (check_train_mask_contract); a
    cloud without a valid point gives -1e9. In train mode the chain runs
    through `mlp_pool_fused` with one group of N rows a cloud: on CUDA
    tensors always its four kernels (csrc/mlp_chain.cu), where the JAX
    package takes its fused chain only on a TPU above 1e7 elements (its
    models/pointnet.py:369-373); on the CPU the plain chain. Eval is plain
    matmuls on the running statistics, as the JAX package's.
    """

    def __init__(self, in_features: int, features, final_relu: bool = False,
                 dtype=None):
        super().__init__()
        self.final_relu = final_relu
        self.dtype = dtype
        self.register_chain(list(zip((in_features, *features[:-1]), features)))

    def forward(self, x, train: bool = False, mask=None):
        check_train_mask_contract(train, mask)
        B, N, _ = x.shape
        dt = self.dtype or x.dtype
        pen = (torch.zeros((B, N), dtype=torch.float32, device=x.device)
               if mask is None else torch.where(mask, 0.0, 1e9).float())
        pool = self.chain_pool_train if train else self.chain_pool
        return pool(x.to(dt), pen, N, self.final_relu)[:, 0, :]


class PointwiseMLP(nn.Module):
    """Shared per-point MLP: Dense + BatchNorm (+ ReLU) per layer.

    `final_activation=False` leaves the last layer linear.
    """

    def __init__(self, in_features: int, features, final_activation: bool = True,
                 dtype=None):
        super().__init__()
        self.n_layers = len(features)
        self.final_activation = final_activation
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", Dense(in_features, f, dtype=dtype))
            self.add_module(f"BatchNorm_{i}", BatchNorm(f, dtype=dtype))
            in_features = f

    def forward(self, x, train: bool = False):
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = getattr(self, f"BatchNorm_{i}")(x, train=train)
            if self.final_activation or i < self.n_layers - 1:
                x = torch.relu(x)
        return x


class STN(nn.Module):
    """Spatial transformer predicting a k x k transform. Input (B, N, C) ->
    (B, k, k). The head Dense_2 starts at zero, so the initial transform is
    the identity."""

    def __init__(self, k: int, in_features: int, dtype=None):
        super().__init__()
        self.k = k
        self.PointwiseMLP_0 = PointwiseMLP(in_features, (64, 128), dtype=dtype)
        self.DenseBNMaxPool_0 = DenseBNMaxPool(128, 1024, final_relu=True,
                                               dtype=dtype)
        self.Dense_0 = Dense(1024, 512, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(512, dtype=dtype)
        self.Dense_1 = Dense(512, 256, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(256, dtype=dtype)
        # no dtype: fp32 head on the bf16 features, as flax promotes them
        self.Dense_2 = Dense(256, k * k, zero_init=True)

    def forward(self, x, train: bool = False, mask=None):
        h = self.PointwiseMLP_0(x, train=train)
        h = self.DenseBNMaxPool_0(h, train=train, mask=mask)  # (B, 1024)
        h = torch.relu(self.BatchNorm_0(self.Dense_0(h), train=train))
        h = torch.relu(self.BatchNorm_1(self.Dense_1(h), train=train))
        h = self.Dense_2(h)
        iden = torch.eye(self.k, dtype=h.dtype, device=h.device)
        return (h + iden.reshape(1, self.k * self.k)).reshape(-1, self.k, self.k)


def _transform(x, trans):
    """einsum('bnc,bcd->bnd'): points multiply the transform on the right,
    in the promoted dtype of the two."""
    dt = torch.promote_types(x.dtype, trans.dtype)
    return torch.bmm(x.to(dt), trans.to(dt))


class PointNetEncoder(nn.Module):
    """PointNet global encoder -> (B, 1024).

    The first `space_dims` coords are transformed by the input STN (which
    sees all input dims); the remaining `feature_dims` pass through.
    """

    ENCODING_DIM = 1024

    def __init__(self, space_dims: int = 3, feature_dims: int = 3,
                 input_transform: bool = True, feature_transform: bool = True,
                 dtype=None):
        super().__init__()
        in_dim = space_dims + feature_dims
        self.space_dims = space_dims
        self.stn = STN(space_dims, in_dim, dtype=dtype) if input_transform else None
        self.mlp0 = PointwiseMLP(in_dim, (64, 64), dtype=dtype)
        self.fstn = STN(64, 64, dtype=dtype) if feature_transform else None
        self.mlp1 = PointwiseMLP(64, (64, 128), dtype=dtype)
        # final 128 -> 1024 layer: Dense + BN fused with the global max-pool
        # (no ReLU, as the reference's conv3 + bn3)
        self.dbnpool2 = DenseBNMaxPool(128, 1024, final_relu=False, dtype=dtype)

    def _point_features(self, x, train, mask):
        if self.stn is not None:
            trans = self.stn(x, train=train, mask=mask)
            xyz = _transform(x[..., : self.space_dims], trans)
            x = torch.cat([xyz, x[..., self.space_dims :].to(xyz.dtype)], dim=-1)
        x = self.mlp0(x, train=train)
        if self.fstn is not None:
            x = _transform(x, self.fstn(x, train=train, mask=mask))
        return x

    def forward(self, x, train: bool = False, mask=None):
        check_train_mask_contract(train, mask)
        x = self._point_features(x, train, mask)
        x = self.mlp1(x, train=train)
        return self.dbnpool2(x, train=train, mask=mask)  # (B, 1024)

    def forward_all_features(self, x, train: bool = False, mask=None):
        """Per-point (64-d) + tiled global features, (B, N, 64 + 1024)."""
        pointfeat = self._point_features(x, train, mask)
        x = self.mlp1(pointfeat, train=train)
        # relu commutes with the max-pool; re-assert the all-masked sentinel
        # that relu would clamp to 0
        glob = torch.relu(self.dbnpool2(x, train=train, mask=mask))
        if mask is not None:
            glob = glob.masked_fill(~torch.any(mask, dim=-1, keepdim=True), _NEG)
        B, N = pointfeat.shape[:2]
        glob_tiled = glob[:, None, :].expand(B, N, glob.shape[-1])
        dt = torch.promote_types(pointfeat.dtype, glob.dtype)
        return torch.cat([pointfeat.to(dt), glob_tiled.to(dt)], dim=-1)
