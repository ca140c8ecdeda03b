"""Heads and the autoencoder (port of pointcloud_tpu/models/architectures.py).

`backbone_factory` maps backbone names to encoder constructors; `AE` and
`SegAE` assemble backbone + bottleneck + decoder. Every backbone of the JAX
package's factory is ported, eval and train: PointNet, PointNet2, PointMLP
and PointMLP-Elite. The encoders outside it (PointNet2SSGEncoder,
PointNet2MSGEncoder) are ported too and, as in the JAX package, not listed.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointcloud_tpu_torch.models.layers import Dense
from pointcloud_tpu_torch.models.pointnet import PointNetEncoder
from pointcloud_tpu_torch.models.pointmlp import PointMLP, PointMLPElite
from pointcloud_tpu_torch.models.pointnet2 import PointNet2Encoder

backbone_factory = {
    "PointNet": PointNetEncoder,
    "PointNet2": PointNet2Encoder,
    "PointMLP": PointMLP,
    "PointMLPE": PointMLPElite,
}


def encoding_dim_of(backbone) -> int:
    """Output width of a backbone instance."""
    return getattr(backbone, "encoding_dim", None) or backbone.ENCODING_DIM


class MLP(nn.Module):
    """Plain FC MLP. output_activation: None | 'relu' | 'sigmoid'.

    Hidden layers compute in `dtype`; the last layer is fp32 whatever the
    hidden dtype, so decoder coordinates and logits keep full precision.
    """

    def __init__(self, in_features: int, hidden_sizes: Sequence[int],
                 output_size: int, output_activation: str | None = "relu",
                 dtype=None):
        super().__init__()
        if output_activation not in (None, "relu", "sigmoid"):
            raise ValueError(f"unknown output_activation {output_activation!r}")
        self.output_activation = output_activation
        self.n_hidden = len(hidden_sizes)
        for i, h in enumerate(hidden_sizes):
            self.add_module(f"Dense_{i}", Dense(in_features, h, dtype=dtype))
            in_features = h
        self.add_module(f"Dense_{self.n_hidden}",
                        Dense(in_features, output_size, dtype=torch.float32))

    def forward(self, x, train: bool = False):
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        x = getattr(self, f"Dense_{self.n_hidden}")(x.float())
        if self.output_activation == "relu":
            x = torch.relu(x)
        elif self.output_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x


class PCDecoder(nn.Module):
    """FC cloud decoder: encoding -> (B, out_points, out_dim), sigmoid output
    (coordinates live in the unit cube)."""

    def __init__(self, in_features: int, out_points: int, out_dim: int,
                 hidden_sizes: Sequence[int] = (512, 1024, 2048), dtype=None):
        super().__init__()
        self.out_points = out_points
        self.out_dim = out_dim
        self.MLP_0 = MLP(in_features, hidden_sizes, out_points * out_dim,
                         "sigmoid", dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.MLP_0(x, train=train).reshape(-1, self.out_points,
                                                  self.out_dim)


class PCSegmenter(nn.Module):
    """Decoder emitting xyz (sigmoid) + per-class logits (raw):
    encoding -> (B, out_points, 3 + num_classes)."""

    def __init__(self, in_features: int, out_points: int, num_classes: int,
                 hidden_sizes: Sequence[int] = (512, 1024, 2048), dtype=None):
        super().__init__()
        self.out_points = out_points
        self.out_dim = 3 + num_classes
        self.MLP_0 = MLP(in_features, hidden_sizes, out_points * self.out_dim,
                         None, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = self.MLP_0(x, train=train).reshape(-1, self.out_points, self.out_dim)
        return torch.cat([torch.sigmoid(x[..., :3]), x[..., 3:]], dim=-1)


class PCEncoder(nn.Module):
    """Backbone + bottleneck projection."""

    def __init__(self, backbone: nn.Module, bottleneck: int,
                 hidden_sizes: Sequence[int] = (),
                 output_activation: str | None = None, dtype=None):
        super().__init__()
        self.backbone = backbone
        self.MLP_0 = MLP(encoding_dim_of(backbone), hidden_sizes, bottleneck,
                         output_activation, dtype=dtype)

    def forward(self, x, train: bool = False, mask=None):
        return self.MLP_0(self.backbone(x, train=train, mask=mask), train=train)


class PCEncoderDecoder(nn.Module):
    """Encoder + decoder; `encode()` returns the bottleneck, which the RL
    observation encoders consume."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, x, train: bool = False, mask=None):
        return self.decoder(self.encoder(x, train=train, mask=mask), train=train)

    def encode(self, x, train: bool = False, mask=None):
        return self.encoder(x, train=train, mask=mask)


def AE(preencoder: nn.Module, out_points: int = 2048, out_dim: int = 6,
       bottleneck: int = 16, dtype=None) -> PCEncoderDecoder:
    """Global autoencoder."""
    return PCEncoderDecoder(
        encoder=PCEncoder(preencoder, bottleneck, dtype=dtype),
        decoder=PCDecoder(bottleneck, out_points, out_dim, dtype=dtype),
    )


def SegAE(preencoder: nn.Module, num_classes: int, out_points: int = 2048,
          bottleneck: int = 16, dtype=None) -> PCEncoderDecoder:
    """Autoencoder with segmentation output."""
    return PCEncoderDecoder(
        encoder=PCEncoder(preencoder, bottleneck, dtype=dtype),
        decoder=PCSegmenter(bottleneck, out_points, num_classes, dtype=dtype),
    )
