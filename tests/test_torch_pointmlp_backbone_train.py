"""The port's PointMLP and PointMLP-Elite backbones in train mode against
pointcloud_tpu's flax backbones (`apply(..., train=True,
mutable=["batch_stats"])`) on the CPU, fp32, on the same randomised flax
variables (interop); the modules are held in
tests/test_torch_pointmlp_train.py, whose helpers this file shares.
"""

import numpy as np
import pytest
from test_torch_pointmlp_train import MARGIN, _flat_stats
from test_torch_pointnet2_train import largest
from torch_port_utils import (
    jax_variables,
    record_pool_gaps,
    stage_margins,
    train_mode_pair,
)

from pointcloud_tpu.models import pointmlp as jpm
from pointcloud_tpu_torch.interop import load_flax_variables
from pointcloud_tpu_torch.models import pointmlp as tpm

POOL_GAP_BACKBONE = 1.5e-6


@pytest.mark.parametrize("factory,seed", [("PointMLP", 294), ("PointMLPElite", 22)])
def test_backbone_train_matches_flax(factory, seed, monkeypatch):
    """The whole backbone at B=2 x 256 points (6 dims). At this size its
    train-mode forward is ill-conditioned: BatchNorm over the 32 to 64 rows
    of a late PosExtraction and many ReLU gates and pools per parameter
    make a one-ulp move of every xyz coordinate change the port's own output
    by 2.9e-4 and its gradients by up to 8e-2 of a tensor's largest entry
    (measured, PointMLP at this seed). So the modules are held tightly
    above, and here: outputs 1e-3 (measured 4.3e-4), running statistics
    1e-4, every gradient within 1e-2 of the model's largest gradient entry
    (measured 4.8e-3). The seed keeps every kNN set 1e-5 apart and every
    pool 1.5e-6 above its runner-up (PointMLP's 128 to 1024 channels a pool
    leave no seed in 300 with 3e-6)."""
    x = np.random.default_rng(seed).random((2, 256, 6), dtype=np.float32)
    assert min(stage_margins(x[..., :3].copy())) > MARGIN
    jm = getattr(jpm, factory)(feature_dims=3)
    tm = getattr(tpm, factory)(feature_dims=3)
    v = jax_variables(jm, x, 60)
    load_flax_variables(tm, v)
    gaps = record_pool_gaps(monkeypatch, distinct=True)
    res = train_mode_pair(jm, tm, v, x, seed=8)
    assert len(gaps) == 4 and min(gaps) > POOL_GAP_BACKBONE, gaps
    (jout, jgr, jstats, _), (tout, tgr, tstats, _) = res["jax"], res["port"]
    assert tout.shape == jout.shape == (2, tm.encoding_dim)
    np.testing.assert_allclose(tout, jout, atol=1e-3, rtol=1e-3)
    assert set(tgr) == set(jgr)
    top = largest(jgr.values())
    for k in jgr:
        assert np.abs(tgr[k] - jgr[k]).max() <= 1e-2 * top, k
    assert set(tstats) == set(jstats)
    before = _flat_stats(v)
    for k in jstats:
        assert not np.allclose(tstats[k], before[k]), k  # it moved
        np.testing.assert_allclose(tstats[k], jstats[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
