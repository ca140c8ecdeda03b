"""The port's flax-style layers (pointcloud_tpu_torch/models/layers.py) with
dtype=bfloat16 on bf16 input against flax's `nn.BatchNorm` and `nn.Dense`
with dtype=jnp.bfloat16, on the CPU, on the same randomised variables
(interop): the layers PointMLP's DenseBNAct, ResBlock and PosExtraction run
in bf16 on the card, now in train mode too.

Tolerances. BatchNorm: at most 1 of the 8,192 entries of a (2, 32, 128)
output may differ, by at most 4.8e-7 (one bf16 ulp of a value near 1e-4),
in train and in eval mode, and the updated running statistics 1e-6 (the
probe recorded in ROADMAP Queue 3 measured that; this seed measures 0 of
8,192). Dense: every entry within one bf16 ulp of flax's plus 1e-3 of the
largest entry (XLA's CPU bf16 product rounds elsewhere than PyTorch's fp32
accumulation rounded once: ~28% of the entries sit one ulp apart, and sums
that cancel to near 0 keep the difference of their summands' roundings,
up to 2.6e-5 of the largest entry; measured).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch_port_utils import random_variables, to_np

from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import layers as tl


class JBatchNorm(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                             dtype=jnp.bfloat16)(x)


class TBatchNorm(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.BatchNorm_0 = tl.BatchNorm(features, dtype=torch.bfloat16)

    def forward(self, x, train: bool = False):
        return self.BatchNorm_0(x, train=train)


class JDense(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Dense(128, dtype=jnp.bfloat16)(x)


class TDense(nn.Module):
    def __init__(self, in_features):
        super().__init__()
        self.Dense_0 = tl.Dense(in_features, 128, dtype=torch.bfloat16)

    def forward(self, x, train: bool = False):
        return self.Dense_0(x)


def run_pair(jm, tm, shape, seed, train):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    v = random_variables(jax.tree_util.tree_map(np.asarray, dict(
        jm.init(jax.random.PRNGKey(0), xb))), np.random.default_rng(seed))
    load_flax_variables(tm, v)
    if train:
        jout, mutated = jm.apply(v, xb, train=True, mutable=["batch_stats"])
    else:
        jout, mutated = jm.apply(v, xb), {}
    with torch.no_grad():
        tout = tm(torch.from_numpy(x).to(torch.bfloat16), train=train)
    assert tout.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    return to_np(tout.float()), np.asarray(jout, np.float32), mutated, tm


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_bf16_matches_flax(train):
    got, want, mutated, tm = run_pair(JBatchNorm(), TBatchNorm(128), (2, 32, 128), 0,
                                      train)
    diff = np.abs(got - want)
    assert diff.size == 8192 and (diff > 0).sum() <= 1 and diff.max() <= 4.8e-7
    if train:
        stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
            np.asarray, mutated["batch_stats"])})
        for k, b in tm.named_buffers():
            np.testing.assert_allclose(to_np(b), stats[k], rtol=1e-6, atol=1e-6)


def test_dense_bf16_within_one_ulp_of_flax():
    got, want, _, _ = run_pair(JDense(), TDense(16), (2, 32, 16), 1, False)
    # the ulp of the larger of the two (they may sit on either side of a power of 2)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.maximum(np.abs(got), np.abs(want)),
                                              1e-30))) - 7)
    assert (np.abs(got - want) <= ulp + 1e-3 * np.abs(want).max()).all()
    assert (got != want).mean() < 0.5  # most entries equal
