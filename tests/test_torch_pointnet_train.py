"""The port's PointNet modules in train mode against flax
`apply(..., train=True, mutable=["batch_stats"])` of
pointcloud_tpu.models.pointnet on the CPU: outputs, the gradients of
sum(out * r) for a fixed random r (from jax.grad and from autograd) to the
parameters and the input, and the updated running statistics.

Tolerances: fp32 on both sides, differing only in the order of fp32 sums.
Outputs and running statistics 1e-4 absolute and relative, as the eval-mode
tests (tests/test_torch_pointnet.py). Gradients 1e-4 relative plus 1e-4 of
the largest entry of the same gradient: the batch-statistics backward
subtracts O(1) terms to leave small ones, so each entry carries round-off
on the scale of the tensor's largest entry. That floor also covers the
biases of a Dense layer that feeds a train-mode BatchNorm: their true
gradient is exactly zero (the batch mean removes them), and both packages
leave only round-off there; the tests check that it is round-off.

The STN heads normalise (B, 512) and (B, 256) features over the batch alone,
so their tests use B=8: with two clouds, a channel whose two values nearly
coincide has a batch variance far below eps, and BatchNorm scales the
difference of the two values (and its round-off) by 1/sqrt(eps). Even at
B=8 each head BatchNorm multiplies the ~1e-6 round-off of its input by
scale / std over 8 values (std down to ~0.2 here), twice in a row, so the
modules with an STN head are held to 1e-3 (measured up to 6e-4 on outputs).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import random_variables, train_mode_pair

from pointcloud_tpu.models import pointnet as jpn
from pointcloud_tpu_torch.interop import load_flax_variables
from pointcloud_tpu_torch.models import pointnet as tpn
from pointcloud_tpu_torch.models.layers import BatchNorm

HEAD_REL = 1e-3  # modules with an STN head, see the module docstring


def pair(jmod, tmod, x, seed, **init_kw):
    """Random flax variables for `jmod`, loaded into `tmod` too."""
    v = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), **init_kw))
    v = random_variables(v, np.random.default_rng(seed))
    load_flax_variables(tmod, v)
    return v


def assert_pair_close(res, zero_grad_keys=(), rel=1e-4):
    """Outputs and running statistics within `rel` (absolute and relative);
    gradients within `rel` relative plus `rel` of the tensor's largest entry
    and rel/100 of the largest gradient entry of the module (the scale of
    the round-off that flows back through the batch statistics)."""
    jout, jgr, jstats, jdx = res["jax"]
    tout, tgr, tstats, tdx = res["port"]
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, atol=rel, rtol=rel)
    assert set(tstats) == set(jstats) and tstats
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], err_msg=k, atol=rel,
                                   rtol=rel)
    assert set(tgr) == set(jgr)
    top = max(float(np.abs(v).max()) for v in jgr.values())
    for k, want in [*jgr.items(), ("input", jdx)]:
        got = tdx if k == "input" else tgr[k]
        if k in zero_grad_keys:  # true gradient 0: round-off on both sides
            assert np.abs(got).max() <= 1e-4 * top, k
            continue
        floor = rel * float(np.abs(want).max()) + rel * 1e-2 * top
        np.testing.assert_allclose(got, want, rtol=rel, atol=floor, err_msg=k)


def masks(rng, shape):
    """~20% of points masked, and row 0 masked completely."""
    m = rng.random(shape) > 0.2
    m[0] = False
    return m


def test_batchnorm():
    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal((2, 24, 16))).astype(np.float32)
    jm = fnn.BatchNorm(momentum=0.9)
    tm = BatchNorm(16)
    v = pair(jm, tm, x, 1, use_running_average=True)
    res = train_mode_pair(jm, tm, v, x, 2, jtrain={"use_running_average": False})
    assert_pair_close(res)
    # flax's update: 0.9 * old + 0.1 * batch, biased variance
    xf = x.reshape(-1, 16).astype(np.float64)
    want_var = 0.9 * v["batch_stats"]["var"] + 0.1 * xf.var(axis=0)
    np.testing.assert_allclose(res["port"][2]["var"], want_var, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("final_relu", [False, True])
def test_bnmaxpool(masked, final_relu):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    kw = {"mask": masks(rng, (2, 32))} if masked else {}
    jm, tm = jpn.BNMaxPool(final_relu=final_relu), tpn.BNMaxPool(16, final_relu)
    v = pair(jm, tm, x, 4, train=False)
    assert_pair_close(train_mode_pair(jm, tm, v, x, 5, **kw))


@pytest.mark.parametrize("groups", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_bn_maxpool(groups, masked):
    """3-D input pools the whole R axis; 4-D (B, S, K, Cin) pools K per
    group (the reshape PointNet2 uses). The port goes through
    dense_pool_stats, the JAX package's CPU path through its XLA branch."""
    rng = np.random.default_rng(6 + groups)
    shape = (2, 4, 16, 8) if groups else (2, 64, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    kw = {"mask": masks(rng, shape[:-1])} if masked else {}
    jm = jpn.DenseBNMaxPool(24, final_relu=True)
    tm = tpn.DenseBNMaxPool(8, 24, final_relu=True)
    v = pair(jm, tm, x, 7, train=False)
    res = train_mode_pair(jm, tm, v, x, 8, **kw)
    assert_pair_close(res, zero_grad_keys=["bias"])
    if masked:  # the all-masked row keeps the sentinel
        assert (res["port"][0][0] == -1e9).all()


def test_pointwise_mlp():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    jm = jpn.PointwiseMLP((16, 32), final_activation=False)
    tm = tpn.PointwiseMLP(6, (16, 32), final_activation=False)
    v = pair(jm, tm, x, 10, train=False)
    assert_pair_close(train_mode_pair(jm, tm, v, x, 11),
                      zero_grad_keys=["Dense_0.bias", "Dense_1.bias"])


@pytest.mark.parametrize("masked", [False, True])
def test_stn(masked):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((8, 24, 6)).astype(np.float32)
    kw = {"mask": rng.random((8, 24)) > 0.2} if masked else {}
    jm, tm = jpn.STN(k=3), tpn.STN(3, 6)
    v = pair(jm, tm, x, 13, train=False)
    res = train_mode_pair(jm, tm, v, x, 14, **kw)
    assert_pair_close(res, zero_grad_keys=[
        "PointwiseMLP_0.Dense_0.bias", "PointwiseMLP_0.Dense_1.bias",
        "DenseBNMaxPool_0.bias", "Dense_0.bias", "Dense_1.bias"], rel=HEAD_REL)


@pytest.mark.parametrize("masked,seed", [(False, 16), (True, 18)])
def test_pointnet_encoder(masked, seed):
    """The whole encoder in train mode: both STNs, both MLPs and the three
    fused Dense-BN-pool layers, with their running statistics.

    A max-pool routes its gradient to one row, so where the round-off of the
    two packages (amplified by the STN heads, see above) exceeds a pool's
    gap between its top two rows, the routed row flips and every gradient
    upstream of it differs. About half of random seeds have such a near tie
    among the 16 x 1024 pools of each layer here; these seeds have none."""
    rng = np.random.default_rng(seed)
    x = rng.random((16, 16, 6), dtype=np.float32)
    kw = {"mask": rng.random((16, 16)) > 0.2} if masked else {}
    jm, tm = jpn.PointNetEncoder(), tpn.PointNetEncoder()
    v = pair(jm, tm, x, 16, train=False)
    res = train_mode_pair(jm, tm, v, x, 17, **kw)
    assert res["port"][0].shape == (16, 1024)
    assert_pair_close(res, zero_grad_keys=[
        k for k in res["jax"][1] if k.endswith(("Dense_0.bias", "Dense_1.bias"))
        and "Dense_2" not in k and not k.startswith(("stn.Dense", "fstn.Dense"))
    ] + ["dbnpool2.bias"], rel=HEAD_REL)


def test_encoder_forward_all_features_in_train_mode():
    rng = np.random.default_rng(18)
    x = rng.random((8, 16, 6), dtype=np.float32)
    jm, tm = jpn.PointNetEncoder(), tpn.PointNetEncoder()
    v = pair(jm, tm, x, 19, train=False)
    want, _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                       method=jm.forward_all_features)
    got = tm.forward_all_features(torch.from_numpy(x), train=True)
    assert got.shape == (8, 16, 64 + 1024)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=HEAD_REL, rtol=HEAD_REL)
