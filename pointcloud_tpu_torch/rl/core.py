"""RL network cores (port of pointcloud_tpu/rl/core.py; reference:
rl/core.py:23-65).

MLPActorCritic: deterministic tanh actor + Q critic (DDPG). TQC networks
(squashed-Gaussian actor, quantile critics) live here too so trainers share
one module vocabulary.

The modules carry the flax names (`MLP_0.Dense_0`, the squashed actor's
`Dense_0..`, `QuantileCritic_{i}`, `pi` / `q`), so interop.load_flax_variables
reads the JAX package's variables and interop.flax_params writes them.
`init_params` initialises every Dense as flax's nn.Dense does (LeCun normal
truncated at 2 std over fan-in, zero bias) from an explicit torch.Generator.
The squashed actor takes its Gaussian draw as an argument (`noise`), drawn by
the caller from its own generator. The nets are plain fp32 Linear stacks.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0

# stddev of a standard normal truncated to [-2, 2]: flax's truncated_normal
# variance scaling divides by it (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every nn.Linear of `module`, in registration order: weight LeCun
    normal (std sqrt(1 / fan_in) / 0.8796, truncated at 2 std), bias zero, as
    flax.linen.Dense's defaults."""
    for layer in module.modules():
        if isinstance(layer, nn.Linear):
            std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
            w = torch.empty(layer.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            layer.weight.copy_(w)
            layer.bias.zero_()
    return module


def _dense_stack(module: nn.Module, in_dim: int, widths: Sequence[int]) -> None:
    """Register Dense_0..Dense_{n-1} of the given widths on `module`."""
    for i, w in enumerate(widths):
        module.add_module(f"Dense_{i}", nn.Linear(in_dim, w))
        in_dim = w


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int], out: int,
                 out_activation: str | None = None):
        super().__init__()
        self.hidden, self.out, self.out_activation = tuple(hidden), out, out_activation
        _dense_stack(self, in_dim, (*self.hidden, out))

    def forward(self, x):
        n = len(self.hidden)
        for i in range(n):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        x = getattr(self, f"Dense_{n}")(x)
        if self.out_activation == "tanh":
            x = torch.tanh(x)
        return x


class Actor(nn.Module):
    """Deterministic tanh actor scaled to the action limit (rl/core.py:23-33)."""

    def __init__(self, in_dim: int, act_dim: int, act_limit: float,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.act_dim, self.act_limit, self.hidden = act_dim, act_limit, tuple(hidden)
        self.MLP_0 = MLP(in_dim, hidden, act_dim, "tanh")

    def forward(self, obs):
        return self.act_limit * self.MLP_0(obs)


class QCritic(nn.Module):
    """Q(s, a) scalar critic (rl/core.py:36-43); in_dim is obs + act."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.hidden = tuple(hidden)
        self.MLP_0 = MLP(in_dim, hidden, 1)

    def forward(self, obs, act):
        return self.MLP_0(torch.cat([obs, act], dim=-1))[..., 0]


class MLPActorCritic(nn.Module):
    """Actor + critic bundle (reference MLPActorCritic, rl/core.py:45-65)."""

    def __init__(self, obs_dim: int, act_dim: int, act_limit: float,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.pi = Actor(obs_dim, act_dim, act_limit, hidden)
        self.q = QCritic(obs_dim + act_dim, hidden)

    def forward(self, obs, act):
        return self.pi(obs), self.q(obs, act)

    def act(self, obs):
        return self.pi(obs)

    def q_value(self, obs, act):
        return self.q(obs, act)


class SquashedGaussianActor(nn.Module):
    """Tanh-squashed Gaussian policy (TQC/SAC-style). Dense_0..Dense_{n-1}
    are the hidden layers, Dense_n the mean and Dense_{n+1} the log std."""

    def __init__(self, in_dim: int, act_dim: int, act_limit: float,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.act_dim, self.act_limit, self.hidden = act_dim, act_limit, tuple(hidden)
        _dense_stack(self, in_dim, self.hidden)
        h = self.hidden[-1] if self.hidden else in_dim
        n = len(self.hidden)
        self.add_module(f"Dense_{n}", nn.Linear(h, act_dim))
        self.add_module(f"Dense_{n + 1}", nn.Linear(h, act_dim))

    def forward(self, obs, noise=None, deterministic: bool = False):
        """(act_limit * tanh(pre), log prob of pre with the tanh correction);
        pre = mu + std * noise, or mu when deterministic or noise is None."""
        h = obs
        n = len(self.hidden)
        for i in range(n):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        mu = getattr(self, f"Dense_{n}")(h)
        log_std = torch.clamp(getattr(self, f"Dense_{n + 1}")(h), LOG_STD_MIN, LOG_STD_MAX)
        std = torch.exp(log_std)
        if deterministic or noise is None:
            pre = mu
        else:
            pre = mu + std * noise
        act = torch.tanh(pre)
        # log prob with tanh correction
        logp = (
            -0.5 * (((pre - mu) / std) ** 2 + 2 * log_std + math.log(2 * math.pi))
        ).sum(-1)
        logp = logp - (2 * (math.log(2.0) - pre - F.softplus(-2 * pre))).sum(-1)
        return self.act_limit * act, logp


class QuantileCritic(nn.Module):
    """One quantile network emitting n_quantiles values (TQC); in_dim is
    obs + act."""

    def __init__(self, in_dim: int, n_quantiles: int = 25,
                 hidden: Sequence[int] = (512, 512, 512)):
        super().__init__()
        self.MLP_0 = MLP(in_dim, hidden, n_quantiles)

    def forward(self, obs, act):
        return self.MLP_0(torch.cat([obs, act], dim=-1))


class QuantileEnsemble(nn.Module):
    """n_critics quantile networks, outputs stacked (B, n_critics, n_q)."""

    def __init__(self, in_dim: int, n_critics: int = 2, n_quantiles: int = 25,
                 hidden: Sequence[int] = (512, 512, 512)):
        super().__init__()
        self.n_critics, self.n_quantiles = n_critics, n_quantiles
        for i in range(n_critics):
            self.add_module(f"QuantileCritic_{i}",
                            QuantileCritic(in_dim, n_quantiles, hidden))

    def forward(self, obs, act):
        outs = [getattr(self, f"QuantileCritic_{i}")(obs, act)
                for i in range(self.n_critics)]
        return torch.stack(outs, dim=-2)
