"""The port's PointMLP modules in train mode against pointcloud_tpu's flax
modules (`apply(..., train=True, mutable=["batch_stats"])`) on the CPU, fp32,
on the same randomised flax variables (interop): PreExtraction (1 and 2
blocks, res_expansion 1.0 and 0.25, `use_bias` both ways) against the JAX
package's fused chain in interpret mode (`impl="fused", interpret=True`) and
its XLA path (`impl="xla"`); one stage (LocalGrouper + PreExtraction +
PosExtraction, the gradient through the kNN grouping). The whole backbone
is held in tests/test_torch_pointmlp_backbone_train.py. Off the TPU the
port's CPU tensors take the plain residual chain.

Tolerances. Outputs 1e-5 absolute and relative, running statistics 1e-5. Gradients by `close_grads` of
tests/test_torch_pointnet2_train.py: 1e-3 relative plus 1e-3 of the
tensor's largest entry plus 1e-5 of the module's largest gradient, on all
but 2 entries a tensor, and 4e-3 of the largest on all (a ReLU gate within
round-off of 0 may flip between the packages). A pool whose best two rows
lie within round-off sends its gradient to another row in the other
package, so every input here keeps each pool's best row `POOL_GAP` above its
runner-up (`record_pool_gaps`) and, where it groups, every centroid's 24th
and 25th float64 distances 1e-5 apart (relative). `use_bias=True` puts a
Dense bias in front of each train-mode BatchNorm: the batch mean removes it,
so its true gradient is 0 and both packages leave round-off there (held
below 1e-4 of the module's largest gradient).
"""

import flax.linen as fnn
import numpy as np
import pytest
from test_torch_pointnet2_train import close_grads, largest
from torch import nn
from torch_port_utils import (
    jax_variables,
    record_pool_gaps,
    stage_margins,
    train_mode_pair,
)

from pointcloud_tpu.models import pointmlp as jpm
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import pointmlp as tpm

TOL = dict(atol=1e-5, rtol=1e-5)
STAT_TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-5
POOL_GAP = 1e-5


def check_pair(res, variables, out_tol=TOL):
    """Outputs, every gradient (the input's too), the running statistics
    (all moved) of a `train_mode_pair` result."""
    (jout, jgr, jstats, jdx), (tout, tgr, tstats, tdx) = res["jax"], res["port"]
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, **out_tol)
    assert set(tgr) == set(jgr)
    top = largest(jgr.values())
    for k in jgr:
        if k.endswith("bias") and k.split(".")[-2].startswith("Dense_"):
            # a Dense bias before a train-mode BatchNorm
            assert np.abs(tgr[k]).max() <= 1e-4 * top, k
            assert np.abs(jgr[k]).max() <= 1e-4 * top, k
            continue
        close_grads(tgr[k], jgr[k], k, top)
    close_grads(tdx, jdx, "input", 0.0)
    assert set(tstats) == set(jstats) and len(tstats) > 0
    before = {k: np.asarray(v) for k, v in _flat_stats(variables).items()}
    for k in jstats:
        assert not np.allclose(tstats[k], before[k]), k  # it moved
        np.testing.assert_allclose(tstats[k], jstats[k], **STAT_TOL, err_msg=k)


def _flat_stats(variables):
    return flax_to_state_dict({"batch_stats": variables["batch_stats"]})


@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("blocks,res_expansion", [(1, 1.0), (1, 0.25), (2, 1.0),
                                                  (2, 0.25)])
def test_pre_extraction_train_matches_flax(blocks, res_expansion, impl,
                                           monkeypatch):
    """Bias-free (the configurations): the port's plain residual chain
    against the JAX package's interpret-mode kernels and its XLA oracle."""
    B, G, K, D, C = 2, 6, 8, 10, 16
    x = np.random.default_rng(blocks).standard_normal((B, G, K, D)).astype(np.float32)
    jm = jpm.PreExtraction(C, blocks, res_expansion, False)
    v = jax_variables(jm, x, 10 * blocks + int(4 * res_expansion))
    tm = tpm.PreExtraction(D, C, blocks, res_expansion, False)
    load_flax_variables(tm, v)
    gaps = record_pool_gaps(monkeypatch, distinct=True)
    jtrain = dict(train=True, impl=impl, interpret=impl == "fused")
    check_pair(train_mode_pair(jm, tm, v, x, seed=3, jtrain=jtrain), v)
    assert len(gaps) == 1 and gaps[0] > POOL_GAP


@pytest.mark.parametrize("blocks", [1, 2])
def test_pre_extraction_with_bias_train_matches_flax(blocks):
    """use_bias=True: the DenseBNAct + ResBlock stack in train mode, then the
    max over K (no configuration uses it)."""
    B, G, K, D, C = 2, 6, 8, 10, 16
    x = np.random.default_rng(20 + blocks).standard_normal((B, G, K, D)).astype(
        np.float32)
    jm = jpm.PreExtraction(C, blocks, 0.5, True)
    v = jax_variables(jm, x, 30 + blocks)
    tm = tpm.PreExtraction(D, C, blocks, 0.5, True)
    load_flax_variables(tm, v)
    check_pair(train_mode_pair(jm, tm, v, x, seed=4), v)


class JStage(fnn.Module):
    """One PointMLP stage as the flax backbone runs it."""

    groups: int
    out_channels: int
    blocks: int
    res_expansion: float

    @fnn.compact
    def __call__(self, x, train: bool = False):
        _, grouped, _ = jpm.LocalGrouper(groups=self.groups, kneighbors=24)(
            x[..., :3], x[..., 3:])
        h = jpm.PreExtraction(self.out_channels, self.blocks, self.res_expansion,
                              False)(grouped, train=train)
        return jpm.PosExtraction(self.out_channels, self.blocks, self.res_expansion,
                                 False)(h, train=train)


class TStage(nn.Module):
    """The port's counterpart of JStage, with the flax names."""

    def __init__(self, groups, in_features, out_channels, blocks, res_expansion):
        super().__init__()
        self.groups = groups
        self.LocalGrouper_0 = tpm.LocalGrouper(24, in_features)
        self.PreExtraction_0 = tpm.PreExtraction(2 * in_features, out_channels, blocks,
                                                 res_expansion, False)
        self.PosExtraction_0 = tpm.PosExtraction(out_channels, blocks, res_expansion,
                                                 False)

    def forward(self, x, train: bool = False):
        _, grouped, _ = self.LocalGrouper_0(x[..., :3].contiguous(), x[..., 3:],
                                            self.groups)
        return self.PosExtraction_0(self.PreExtraction_0(grouped, train=train),
                                    train=train)


@pytest.mark.parametrize("blocks,res_expansion,seed", [(2, 1.0, 40), (1, 0.25, 41)])
def test_one_stage_train_matches_flax(blocks, res_expansion, seed, monkeypatch):
    """LocalGrouper + PreExtraction + PosExtraction: the input's gradient
    reaches the features through the residual chain, the grouper's affine
    normalisation and unbiased per-cloud std, and the kNN grouping's
    scatter; xyz gets none."""
    B, N, D, C = 2, 128, 8, 16
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.random((B, N, 3), dtype=np.float32),
                        rng.standard_normal((B, N, D)).astype(np.float32)], -1)
    assert stage_margins(x[..., :3].copy(), stages=1)[0] > MARGIN
    jm = JStage(N // 2, C, blocks, res_expansion)
    v = jax_variables(jm, x, 50 + blocks)
    tm = TStage(N // 2, D, C, blocks, res_expansion)
    load_flax_variables(tm, v)
    gaps = record_pool_gaps(monkeypatch, distinct=True)
    res = train_mode_pair(jm, tm, v, x, seed=5)
    check_pair(res, v)
    assert len(gaps) == 1 and gaps[0] > POOL_GAP
    assert np.abs(res["port"][3][..., :3]).max() == 0  # no gradient to xyz
    assert np.abs(res["port"][3][..., 3:]).max() > 0
