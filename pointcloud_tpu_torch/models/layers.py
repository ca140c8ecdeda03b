"""The flax layers the port's models are built from: Dense and BatchNorm,
with flax's parameter names, dtype rules and initialisers.

Parameter names follow flax, except that a Dense kernel is stored as
`weight (out, in)`, PyTorch's layout, where flax keeps `kernel (in, out)`;
interop.py transposes. A layer with `dtype` casts its input and parameters
to it (flax's promote_dtype); without one it computes in the promoted dtype
of input and parameters, so a bf16 input meets fp32 parameters in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

def lecun_normal_(weight: torch.Tensor, generator: torch.Generator,
                  fan_in: int | None = None):
    """flax's lecun_normal: truncated normal at two standard deviations,
    scaled to variance 1 / fan_in; fan_in defaults to shape[1], the input
    width of a (out, in) weight."""
    fan_in = weight.shape[1] if fan_in is None else fan_in
    # 0.8796...: std of a unit normal truncated to [-2, 2] (flax's constant)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _promoted(x: torch.Tensor, *params: torch.Tensor) -> torch.dtype:
    dt = x.dtype
    for p in params:
        dt = torch.promote_types(dt, p.dtype)
    return dt


class Dense(nn.Module):
    """flax nn.Dense: y = x @ kernel + bias, weight stored (out, in).
    `use_bias=False` registers no bias, as flax creates none."""

    def __init__(self, in_features: int, features: int, dtype=None,
                 zero_init: bool = False, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.zero_init = zero_init  # flax kernel_init=zeros (the STN head)
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator):
        if self.zero_init:
            nn.init.zeros_(self.weight)
        else:
            lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype or _promoted(x, self.weight)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def batch_stats(x):
    """flax's train-mode BatchNorm statistics (use_fast_variance): fp32
    mean and biased variance over all axes but the last, the variance
    E[x^2] - E[x]^2 clamped at 0."""
    xf = x.float()
    red = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=red)
    var = torch.clamp(torch.mean(xf * xf, dim=red) - mean * mean, min=0.0)
    return mean, var


MOMENTUM = 0.9  # every BatchNorm of the JAX package


def update_running_stats(module: nn.Module, mean, var):
    """flax's running-average update, in place and outside autograd:
    MOMENTUM weights the OLD value and the biased batch variance is kept
    (torch.nn.BatchNorm weights the new one and keeps an unbiased one)."""
    with torch.no_grad():
        module.mean.copy_(MOMENTUM * module.mean + (1.0 - MOMENTUM) * mean)
        module.var.copy_(MOMENTUM * module.var + (1.0 - MOMENTUM) * var)


def update_chain_stats(module: nn.Module, stats, n: int):
    """The running-average update of a fused chain's layers (mean{i},
    var{i} of `module`) from the batch's per-layer column sums (ssum, ssq)
    over n rows: 0.9 old + 0.1 new, biased variance clamped at 0, in place
    and outside autograd."""
    with torch.no_grad():
        for i, (ss, sq) in enumerate(stats):
            mean = ss / n
            var = torch.clamp(sq / n - mean * mean, min=0.0)
            getattr(module, f"mean{i}").mul_(0.9).add_(mean, alpha=0.1)
            getattr(module, f"var{i}").mul_(0.9).add_(var, alpha=0.1)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(use_running_average=not train, momentum=0.9,
    epsilon=1e-5) over the last axis: fp32 normalisation, result cast to
    `dtype` (or to the promoted dtype of input and parameters). In train mode
    it normalises with the batch statistics and updates the running ones."""

    def __init__(self, features: int, dtype=None, epsilon: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))

    def reset_parameters(self, generator: torch.Generator):
        del generator  # deterministic init
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.mean)
        nn.init.ones_(self.var)

    def forward(self, x, train: bool = False):
        if train:
            mean, var = batch_stats(x)
            update_running_stats(self, mean, var)
        else:
            mean, var = self.mean, self.var
        # flax _normalize's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        y = x - mean
        y = y * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(self.dtype or _promoted(x, self.scale, self.bias))


def init_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every layer of `module` as flax would (lecun_normal kernels,
    zero biases, BatchNorm ones/zeros, zero STN head), drawing from
    `generator` in module order. Returns the module."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
    return module
