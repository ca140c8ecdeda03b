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

from pointcloud_tpu_torch.parallel.distributed import batch_group, batch_sum, batch_world


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
    E[x^2] - E[x]^2 clamped at 0. Inside `sharded_batch` E[x] and E[x^2]
    are the global batch's: the mean of the ranks' means, each rank holding
    an equal slice (differentiable; on one rank the same bits)."""
    xf = x.float()
    red = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=red)
    sq = torch.mean(xf * xf, dim=red)
    if batch_group() is not None:
        mean, sq = (batch_sum(torch.stack([mean, sq])) / batch_world()).unbind(0)
    var = torch.clamp(sq - mean * mean, min=0.0)
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
    over this rank's n rows: 0.9 old + 0.1 new, biased variance clamped at
    0, in place and outside autograd. Inside `sharded_batch` the chain's
    sums are the global batch's, over n rows on each rank."""
    n = n * batch_world()
    with torch.no_grad():
        for i, (ss, sq) in enumerate(stats):
            mean = ss / n
            var = torch.clamp(sq / n - mean * mean, min=0.0)
            getattr(module, f"mean{i}").mul_(0.9).add_(mean, alpha=0.1)
            getattr(module, f"var{i}").mul_(0.9).add_(var, alpha=0.1)


CHAIN_EPS = 1e-5  # BatchNorm epsilon of the JAX package's fused chains


class ChainLayers(nn.Module):
    """Base of the modules whose Dense + BatchNorm layers run as one fused
    chain in train mode (SetAbstraction, the bias-free PreExtraction,
    MLPChainPool). The layers carry flax's names: `w{i}` (cin, co) in
    flax's layout (not transposed), `scale{i}`, `offset{i}`, and buffers
    `mean{i}`, `var{i}` (interop maps these numbered leaves). The Dense
    layers have no bias: train-mode BatchNorm absorbs it."""

    n_layers = 0

    def register_chain(self, layout):
        """One layer a (cin, co) of `layout`."""
        self.n_layers = len(layout)
        for i, (cin, co) in enumerate(layout):
            self.register_parameter(f"w{i}", nn.Parameter(torch.empty(cin, co)))
            self.register_parameter(f"scale{i}", nn.Parameter(torch.empty(co)))
            self.register_parameter(f"offset{i}", nn.Parameter(torch.empty(co)))
            self.register_buffer(f"mean{i}", torch.empty(co))
            self.register_buffer(f"var{i}", torch.empty(co))

    def reset_parameters(self, generator: torch.Generator):
        for i in range(self.n_layers):
            w = getattr(self, f"w{i}")
            lecun_normal_(w, generator, fan_in=w.shape[0])
            nn.init.ones_(getattr(self, f"scale{i}"))
            nn.init.zeros_(getattr(self, f"offset{i}"))
            nn.init.zeros_(getattr(self, f"mean{i}"))
            nn.init.ones_(getattr(self, f"var{i}"))

    def chain(self, name: str):
        """Every layer's `name` variable (w, scale, offset), in order."""
        return [getattr(self, f"{name}{i}") for i in range(self.n_layers)]

    def chain_bn(self, h, i: int):
        """Layer i's BatchNorm of its product h on the running statistics,
        fp32, in flax's order (in place where h is fp32: nothing else reads
        h)."""
        mul = torch.rsqrt(getattr(self, f"var{i}") + CHAIN_EPS) * getattr(self, f"scale{i}")
        return h.float().sub_(getattr(self, f"mean{i}")).mul_(mul).add_(
            getattr(self, f"offset{i}"))

    def chain_pool(self, a, pen, pool: int, final_relu: bool = True):
        """The chain in eval over a (B, R, Cin) in the activation dtype and
        the max over each group of `pool` rows -> (B, R / pool, C_last) in
        that dtype. Each layer's product is rounded to the activation
        dtype, its BatchNorm (running statistics) is fp32, and ReLU(pre) in
        the activation dtype feeds the next layer; the last layer's max is
        taken before its ReLU (applied with final_relu) over pre - pen (pen
        (B, R): +1e9 on rows kept out of the pool), and a group without a
        valid row gives -1e9."""
        dt = a.dtype
        for i in range(self.n_layers):
            if i:
                a = torch.relu(pre).to(dt)
            pre = self.chain_bn(torch.matmul(a, getattr(self, f"w{i}").to(dt)), i)
        B, R, C = pre.shape
        mx = torch.amax(pre.sub_(pen[..., None]).reshape(B, R // pool, pool, C), dim=2)
        out = torch.relu(mx) if final_relu else mx
        return out.masked_fill(mx < -5e8, -1e9).to(dt)

    def chain_pool_train(self, a, pen, pool: int, final_relu: bool = True):
        """`chain_pool` on the batch statistics, through `mlp_pool_fused`;
        the running statistics move to 0.9 old + 0.1 new (biased variance),
        in place."""
        from pointcloud_tpu_torch.ops.preextract_fused import mlp_pool_fused

        out, stats = mlp_pool_fused(a, self.chain("w"), self.chain("scale"),
                                    self.chain("offset"), pen, pool, final_relu)
        update_chain_stats(self, stats, a.shape[0] * a.shape[1])
        return out.to(a.dtype)


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
