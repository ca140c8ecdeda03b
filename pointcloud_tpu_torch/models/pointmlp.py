"""PointMLP encoder (port of pointcloud_tpu/models/pointmlp.py), eval and
train.

Residual point MLP: a per-point embedding, then 4 stages of
{LocalGrouper (FPS + kNN + learnable affine normalisation), PreExtraction
(a shared residual MLP over each neighbourhood, max-pooled), PosExtraction
(a residual MLP over the groups)}, finished by a global max-pool. FPS and the
kNN grouping are the port's CUDA kernels (ops/fps.py, ops/knn_group.py). In
train mode PreExtraction runs the fused residual chain
(`preextract_pool_fused`, ops/preextract_fused.py: CUDA kernels on the card,
the plain chain on the CPU); everything else is plain PyTorch, as the JAX
package leaves it to XLA (and to flax's BatchNorm in train mode). Only xyz
drives the backbone: extra input dims are sliced off.

In train mode the JAX package takes its fused chain only on a TPU above 1e7
grouped elements (pointmlp.py:223-229), a threshold measured there. Here the
device decides: CUDA tensors always run the kernels, CPU tensors the plain
chain.

`PointMLP` (embed 64, res_expansion 1.0, encoding 1024) and `PointMLPElite`
(embed 32, res_expansion 0.25, encoding 256) are the JAX package's two
configurations. Child modules carry the flax names (`DenseBNAct_0`,
`LocalGrouper_0`, `PreExtraction_0`, `PosExtraction_0`, ...), so a
state_dict key is the flax path of the same variable (interop.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointcloud_tpu_torch.models.layers import (
    BatchNorm,
    ChainLayers,
    Dense,
    update_chain_stats,
)
from pointcloud_tpu_torch.models.pointnet import check_train_mask_contract
from pointcloud_tpu_torch.ops.fps import farthest_point_sample
from pointcloud_tpu_torch.ops.geometry import group_neighbors, index_points
from pointcloud_tpu_torch.ops.preextract_fused import (
    RES_BNRELU,
    RES_DENSE,
    layer_res_cfg,
    preextract_pool_fused,
)



class DenseBNAct(nn.Module):
    """Pointwise Dense + BatchNorm (momentum 0.9) + ReLU."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_features, features, dtype=dtype, use_bias=use_bias)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype)

    def forward(self, x, train: bool = False):
        return torch.relu(self.BatchNorm_0(self.Dense_0(x), train=train))


class ResBlock(nn.Module):
    """Residual pointwise block: Dense -> BN -> ReLU (expand to
    int(channels * res_expansion)) -> Dense -> BN (project), + the input,
    ReLU."""

    def __init__(self, channels: int, res_expansion: float = 1.0,
                 use_bias: bool = True, dtype=None):
        super().__init__()
        mid = int(channels * res_expansion)
        self.DenseBNAct_0 = DenseBNAct(channels, mid, use_bias, dtype)
        self.Dense_0 = Dense(mid, channels, dtype=dtype, use_bias=use_bias)
        self.BatchNorm_0 = BatchNorm(channels, dtype=dtype)

    def forward(self, x, train: bool = False):
        h = self.DenseBNAct_0(x, train=train)
        h = self.BatchNorm_0(self.Dense_0(h), train=train)
        return torch.relu(h + x)


class LocalGrouper(nn.Module):
    """FPS + kNN grouping with learnable affine normalisation.

    Input xyz (B, N, 3), feats (B, N, D) and the number of groups G; output
    new_xyz (B, G, 3), grouped (B, G, K, 2D [+3 with use_xyz]) =
    [normalised neighbour feats (+ xyz) | anchor feats], and new_mask (B, G)
    or None. `normalize` is 'center' (each group's mean), 'anchor' (the FPS
    point's own features) or None. (The flax module takes G as a field; the
    port's modules are built before the input's N is known.)
    """

    def __init__(self, kneighbors: int, in_features: int,
                 use_xyz: bool = False, normalize: str | None = "anchor"):
        super().__init__()
        if normalize not in ("center", "anchor", None):
            raise ValueError(f"unknown normalize {normalize!r}")
        self.kneighbors = kneighbors
        self.use_xyz = use_xyz
        self.normalize = normalize
        if normalize is not None:
            dim = in_features + (3 if use_xyz else 0)
            self.affine_alpha = nn.Parameter(torch.empty(1, 1, 1, dim))
            self.affine_beta = nn.Parameter(torch.empty(1, 1, 1, dim))

    def reset_parameters(self, generator: torch.Generator):
        del generator  # deterministic init
        if self.normalize is not None:
            nn.init.ones_(self.affine_alpha)
            nn.init.zeros_(self.affine_beta)

    def forward(self, xyz, feats, groups: int, mask=None):
        B = xyz.shape[0]
        fps_idx = farthest_point_sample(xyz, groups, mask=mask)
        new_xyz = index_points(xyz, fps_idx)  # (B, G, 3)
        new_feats = index_points(feats, fps_idx)  # (B, G, D)
        grouped_xyz, grouped, _, _ = group_neighbors(
            xyz, feats, new_xyz, self.kneighbors, mask=mask,
            with_xyz=self.use_xyz)
        if self.use_xyz:
            grouped = torch.cat([grouped, grouped_xyz], dim=-1)

        if self.normalize is not None:
            if self.normalize == "center":
                mean = torch.mean(grouped, dim=2, keepdim=True)
            else:
                mean = (torch.cat([new_feats, new_xyz], dim=-1) if self.use_xyz
                        else new_feats)[:, :, None, :]
            # one unbiased fp32 std per cloud over all groups, neighbours and
            # channels, from one pass of sums (the anchor-centred values have
            # no catastrophic cancellation)
            centered = grouped - mean
            cf = centered.float()
            n = centered.numel() // B
            s1 = torch.sum(cf, dim=(1, 2, 3))
            s2 = torch.sum(cf * cf, dim=(1, 2, 3))
            mu = s1 / n
            var = torch.clamp(s2 / n - mu * mu, min=0.0)
            std = torch.sqrt(var * n / max(n - 1, 1))[:, None, None, None]
            grouped = centered / (std.to(centered.dtype) + 1e-5)
            # fp32 parameters promote the result to fp32, as in flax
            grouped = self.affine_alpha * grouped + self.affine_beta

        anchor = new_feats[:, :, None, :].expand(*grouped.shape[:3],
                                                 new_feats.shape[-1])
        grouped = torch.cat([grouped, anchor], dim=-1)
        new_mask = None if mask is None else torch.gather(mask, 1, fps_idx.long())
        return new_xyz, grouped, new_mask


class PreExtraction(ChainLayers):
    """Per-neighbourhood residual MLP + max-pool over K: (B, G, K, D) ->
    (B, G, C).

    The bias-free configurations own their Dense kernels and BatchNorm
    variables directly (ChainLayers: the JAX package's names), for
    the layout [(D, C)] + blocks x [(C, mid), (mid, C)]. Each product is
    dtype-native (bf16 in, bf16 out; fp32 in full fp32), each BatchNorm
    fp32 on the running statistics, the residual adds follow
    `layer_res_cfg`, and the last residual comes before the max over K, then
    ReLU and the cast to the activation dtype. Only the first layer's and
    the stored residuals outlive their layer.

    `use_bias=True` is the DenseBNAct + ResBlock stack followed by the max
    (a different parameter tree; no configuration uses it).
    """

    def __init__(self, in_features: int, out_channels: int, blocks: int = 1,
                 res_expansion: float = 1.0, use_bias: bool = True, dtype=None):
        super().__init__()
        self.use_bias = use_bias
        self.blocks = blocks
        self.dtype = dtype
        if use_bias:
            self.DenseBNAct_0 = DenseBNAct(in_features, out_channels, True, dtype)
            for i in range(blocks):
                self.add_module(f"ResBlock_{i}", ResBlock(
                    out_channels, res_expansion, True, dtype))
            return
        mid = int(out_channels * res_expansion)
        layout = [(in_features, out_channels)]
        for _ in range(blocks):
            layout += [(out_channels, mid), (mid, out_channels)]
        self.register_chain(layout)

    def forward(self, x, train: bool = False):
        if self.use_bias:
            h = self.DenseBNAct_0(x, train=train)
            for i in range(self.blocks):
                h = getattr(self, f"ResBlock_{i}")(h, train=train)
            return torch.amax(h, dim=2)
        if train:
            return self._forward_train(x)

        B, G, K, D = x.shape
        dt = self.dtype or x.dtype
        a = x.reshape(B, G * K, D).to(dt)
        L = self.n_layers
        pre = self.chain_bn(torch.matmul(a, self.w0.to(dt)), 0)
        relu0 = torch.relu(pre)  # RES_BNRELU's source, fp32
        rs = []  # stored block outputs r_j, in dt
        for u in range(1, L):
            res_mode, aux = layer_res_cfg(u, L)
            if res_mode == RES_BNRELU:  # relu0's last use
                pre = pre + relu0
                relu0 = None
            elif res_mode == RES_DENSE:
                pre = pre + rs[aux - 1].float()
            a = torch.relu(pre).to(dt)
            if u % 2 == 1 and (u + 1) // 2 >= 2:
                rs.append(a)
            pre = self.chain_bn(torch.matmul(a, getattr(self, f"w{u}").to(dt)), u)
        if self.blocks == 1:
            pre = pre + relu0
        else:
            pre = pre + rs[self.blocks - 2].float()
        C = pre.shape[-1]
        return torch.relu(torch.amax(pre.reshape(B, G, K, C), dim=2)).to(dt)

    def _forward_train(self, x):
        """The stack on the batch statistics through `preextract_pool_fused`,
        then the running-statistics update."""
        B, G, K, D = x.shape
        dt = self.dtype or x.dtype
        out, stats = preextract_pool_fused(x.reshape(B, G * K, D).to(dt),
                                           self.chain("w"), self.chain("scale"),
                                           self.chain("offset"), K)
        update_chain_stats(self, stats, B * G * K)
        return out


class PosExtraction(nn.Module):
    """Residual MLP over the groups: `blocks` ResBlocks."""

    def __init__(self, channels: int, blocks: int = 1, res_expansion: float = 1.0,
                 use_bias: bool = True, dtype=None):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"ResBlock_{i}", ResBlock(channels, res_expansion,
                                                      use_bias, dtype))

    def forward(self, x, train: bool = False):
        for i in range(self.blocks):
            x = getattr(self, f"ResBlock_{i}")(x, train=train)
        return x


class PointMLPModel(nn.Module):
    """The PointMLP backbone -> (B, encoding_dim)."""

    def __init__(self, points: int = 2048, embed_dim: int = 64,
                 res_expansion: float = 1.0, use_bias: bool = False,
                 use_xyz: bool = False, normalize: str | None = "anchor",
                 dim_expansion: Sequence[int] = (2, 2, 2, 2),
                 pre_blocks: Sequence[int] = (2, 2, 2, 2),
                 pos_blocks: Sequence[int] = (2, 2, 2, 2),
                 k_neighbors: Sequence[int] = (24, 24, 24, 24),
                 reducers: Sequence[int] = (2, 2, 2, 2), dtype=None):
        super().__init__()
        self.points = points  # the JAX package's field; the input's N rules
        self.embed_dim = embed_dim
        self.dim_expansion = tuple(dim_expansion)
        self.reducers = tuple(reducers)
        self.n_stages = len(pre_blocks)
        self.DenseBNAct_0 = DenseBNAct(3, embed_dim, use_bias, dtype)
        last = embed_dim
        for i in range(self.n_stages):
            out = last * dim_expansion[i]
            self.add_module(f"LocalGrouper_{i}", LocalGrouper(
                k_neighbors[i], last, use_xyz, normalize))
            self.add_module(f"PreExtraction_{i}", PreExtraction(
                2 * last + (3 if use_xyz else 0), out, pre_blocks[i],
                res_expansion, use_bias, dtype))
            self.add_module(f"PosExtraction_{i}", PosExtraction(
                out, pos_blocks[i], res_expansion, use_bias, dtype))
            last = out

    @property
    def encoding_dim(self) -> int:
        """embed_dim * prod(dim_expansion): 1024 for PointMLP, 256 for
        PointMLPElite."""
        d = self.embed_dim
        for e in self.dim_expansion:
            d *= e
        return d

    def forward(self, x, train: bool = False, mask=None):
        check_train_mask_contract(train, mask)
        xyz = x[..., :3].float().contiguous()
        feats = self.DenseBNAct_0(x[..., :3], train=train)
        anchor_points = xyz.shape[1]
        for i in range(self.n_stages):
            anchor_points //= self.reducers[i]
            xyz, grouped, mask = getattr(self, f"LocalGrouper_{i}")(
                xyz, feats, anchor_points, mask=mask)
            feats = getattr(self, f"PreExtraction_{i}")(grouped, train=train)
            feats = getattr(self, f"PosExtraction_{i}")(feats, train=train)
        return torch.amax(feats, dim=1)  # no mask, as in the JAX package


def PointMLP(points: int = 2048, **kwargs) -> PointMLPModel:
    """The PointMLP configuration (pointcloud_tpu/models/pointmlp.py:377)."""
    kwargs.pop("space_dims", None)
    kwargs.pop("feature_dims", None)
    return PointMLPModel(
        points=points, embed_dim=64, res_expansion=1.0, use_bias=False,
        use_xyz=False, normalize="anchor", dim_expansion=(2, 2, 2, 2),
        pre_blocks=(2, 2, 2, 2), pos_blocks=(2, 2, 2, 2),
        k_neighbors=(24, 24, 24, 24), reducers=(2, 2, 2, 2), **kwargs)


def PointMLPElite(points: int = 2048, **kwargs) -> PointMLPModel:
    """The PointMLP-Elite configuration
    (pointcloud_tpu/models/pointmlp.py:397)."""
    kwargs.pop("space_dims", None)
    kwargs.pop("feature_dims", None)
    return PointMLPModel(
        points=points, embed_dim=32, res_expansion=0.25, use_bias=False,
        use_xyz=False, normalize="anchor", dim_expansion=(2, 2, 2, 1),
        pre_blocks=(1, 1, 2, 1), pos_blocks=(1, 1, 2, 1),
        k_neighbors=(24, 24, 24, 24), reducers=(2, 2, 2, 2), **kwargs)
