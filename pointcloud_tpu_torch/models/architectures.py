"""Heads and architectures (port of pointcloud_tpu/models/architectures.py).

`backbone_factory` maps backbone names to encoder constructors; `AE` and
`SegAE` assemble backbone + bottleneck + decoder, `MultiSegAE` a shared
backbone with a bottleneck and a decoder per class, `GTEncoder` and
`MultiGTEncoder` a backbone with state regression heads. Submodules carry
the flax names (`bottleneck_{name}`, `decoder_{name}`, `head_{name}`,
`MLP_0`), so interop.load_flax_variables and strip_decoders apply as they
are. Every backbone of the JAX
package's factory is ported, eval and train: PointNet, PointNet2, PointMLP
and PointMLP-Elite. The encoders outside it (PointNet2SSGEncoder,
PointNet2MSGEncoder) are ported too and, as in the JAX package, not listed.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

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


class GTEncoder(nn.Module):
    """Backbone + state regression head with a sigmoid output."""

    def __init__(self, backbone: nn.Module, out_dim: int,
                 hidden_sizes: Sequence[int] = (512, 256, 128), dtype=None):
        super().__init__()
        self.backbone = backbone
        self.MLP_0 = MLP(encoding_dim_of(backbone), hidden_sizes, out_dim,
                         "sigmoid", dtype=dtype)

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


class MultiSegAE(nn.Module):
    """Shared backbone + one {bottleneck -> decoder} expert per class.

    name_points_dims: (class_name, out_points, bottleneck_dim) triples.
    `forward` returns {name: (B, out_points, 3)}; `encode` the per-class
    bottlenecks {name: (B, bottleneck_dim)}; `encode_flat` those
    concatenated in `name_points_dims` order; `reconstruct_labeled` the
    per-class clouds with their integer label as a fourth column,
    concatenated in that order.
    """

    def __init__(self, preencoder: nn.Module, class_labels: Mapping[str, int],
                 name_points_dims: Sequence[Tuple[str, int, int]], dtype=None):
        super().__init__()
        self.preencoder = preencoder
        self.class_labels = dict(class_labels)
        self.name_points_dims = tuple(tuple(t) for t in name_points_dims)
        dim = encoding_dim_of(preencoder)
        for name, npts, bneck in self.name_points_dims:
            self.add_module(f"bottleneck_{name}",
                            MLP(dim, (512, 256), bneck, None, dtype=dtype))
            self.add_module(f"decoder_{name}",
                            PCDecoder(bneck, npts, 3, hidden_sizes=(256, 512),
                                      dtype=dtype))

    def _names(self):
        return [name for name, _, _ in self.name_points_dims]

    def forward(self, x, train: bool = False, mask=None):
        g = self.preencoder(x, train=train, mask=mask)
        return {name: getattr(self, f"decoder_{name}")(
                    getattr(self, f"bottleneck_{name}")(g), train=train)
                for name in self._names()}

    def encode(self, x, train: bool = False, mask=None):
        """The per-class encodings."""
        g = self.preencoder(x, train=train, mask=mask)
        return {name: getattr(self, f"bottleneck_{name}")(g) for name in self._names()}

    def encode_flat(self, x, train: bool = False, mask=None):
        """The per-class encodings concatenated."""
        enc = self.encode(x, train=train, mask=mask)
        return torch.cat([enc[name] for name in self._names()], dim=-1)

    def reconstruct_labeled(self, x, train: bool = False, mask=None):
        """The per-class clouds with their integer label as a 4th column."""
        clouds = self(x, train=train, mask=mask)
        labeled = []
        for name in self._names():
            pc = clouds[name]
            label = torch.full((*pc.shape[:2], 1), float(self.class_labels[name]),
                               dtype=pc.dtype, device=pc.device)
            labeled.append(torch.cat([pc, label], dim=-1))
        return torch.cat(labeled, dim=1)


class MultiGTEncoder(nn.Module):
    """Shared backbone + one MLP head per state: state_dims {state_name:
    dim}; returns {state_name: (B, dim)} in [0, 1]; `encode` concatenates
    them in `state_dims` order."""

    def __init__(self, preencoder: nn.Module, state_dims: Mapping[str, int],
                 dtype=None):
        super().__init__()
        self.preencoder = preencoder
        self.state_dims = dict(state_dims)
        dim = encoding_dim_of(preencoder)
        for name, d in self.state_dims.items():
            self.add_module(f"head_{name}",
                            MLP(dim, (512, 256, 128), d, "sigmoid", dtype=dtype))

    def forward(self, x, train: bool = False, mask=None):
        g = self.preencoder(x, train=train, mask=mask)
        return {name: getattr(self, f"head_{name}")(g) for name in self.state_dims}

    def encode(self, x, train: bool = False, mask=None):
        out = self(x, train=train, mask=mask)
        return torch.cat([out[name] for name in self.state_dims], dim=-1)
