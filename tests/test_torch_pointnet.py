"""The port's PointNet modules (eval mode) against flax
`apply(..., train=False)` of pointcloud_tpu.models.pointnet on the CPU, on
the same randomised parameters and positive running statistics.

Tolerance 1e-4 (absolute and relative): both sides run fp32, but XLA and
PyTorch's CPU matmuls sum in different orders and PyTorch adds the Dense
bias inside the matmul, so the layers differ by a few ulp each; through the
two STNs and ten layers of O(1..10) activations that stays under 1e-5 here,
and 1e-4 leaves room for other seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import random_variables, to_np

from pointcloud_tpu.models import pointnet as jpn
from pointcloud_tpu_torch.interop import load_flax_variables
from pointcloud_tpu_torch.models.layers import init_flax_
from pointcloud_tpu_torch.models import pointnet as tpn

TOL = dict(atol=1e-4, rtol=1e-4)


def pair(jmod, tmod, x, seed, **init_kw):
    """Random flax variables for `jmod`, loaded into `tmod` too."""
    v = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False, **init_kw))
    v = random_variables(v, np.random.default_rng(seed))
    load_flax_variables(tmod, v)
    return v


def masks(rng, shape):
    """~20% of points masked, and row 0 masked completely."""
    m = rng.random(shape) > 0.2
    m[0] = False
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("final_relu", [False, True])
def test_bnmaxpool(masked, final_relu):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    m = masks(rng, (2, 32)) if masked else None
    jm, tm = jpn.BNMaxPool(final_relu=final_relu), tpn.BNMaxPool(16, final_relu)
    v = pair(jm, tm, x, 1)
    want = jm.apply(v, jnp.asarray(x), train=False,
                    mask=None if m is None else jnp.asarray(m))
    got = tm(torch.from_numpy(x), mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    if masked:
        assert (to_np(got)[0] == -1e9).all()  # all-masked row: the sentinel


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("groups", [False, True])
def test_dense_bn_maxpool(masked, groups):
    """3-D input pools the whole cloud; 4-D (B, S, K, C) pools K per group."""
    rng = np.random.default_rng(1)
    shape = (2, 4, 16) if groups else (2, 48)
    x = rng.standard_normal(shape + (8,)).astype(np.float32)
    m = masks(rng, shape) if masked else None
    jm = jpn.DenseBNMaxPool(64, final_relu=True)
    tm = tpn.DenseBNMaxPool(8, 64, final_relu=True)
    v = pair(jm, tm, x, 2)
    want = jm.apply(v, jnp.asarray(x), train=False,
                    mask=None if m is None else jnp.asarray(m))
    got = tm(torch.from_numpy(x), mask=None if m is None else torch.from_numpy(m))
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    if masked:
        assert (to_np(got)[0] == -1e9).all()


def test_pointwise_mlp_and_stn():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 6)).astype(np.float32)
    jm, tm = jpn.PointwiseMLP((64, 128)), tpn.PointwiseMLP(6, (64, 128))
    v = pair(jm, tm, x, 3)
    np.testing.assert_allclose(
        to_np(tm(torch.from_numpy(x))),
        np.asarray(jm.apply(v, jnp.asarray(x), train=False)), **TOL)
    js, ts = jpn.STN(k=3), tpn.STN(3, 6)
    v = pair(js, ts, x, 4)
    want = js.apply(v, jnp.asarray(x), train=False)
    got = ts(torch.from_numpy(x))
    assert got.shape == (2, 3, 3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_pointnet_encoder(masked):
    rng = np.random.default_rng(3)
    x = rng.random((2, 64, 6), dtype=np.float32)
    m = None
    if masked:
        m = rng.random((2, 64)) > 0.2
    jm, tm = jpn.PointNetEncoder(), tpn.PointNetEncoder()
    v = pair(jm, tm, x, 5)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jmask = None if m is None else jnp.asarray(m)
    tmask = None if m is None else torch.from_numpy(m)
    want = jm.apply(v, jx, train=False, mask=jmask)
    got = tm(tx, mask=tmask)
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    want_all = jm.apply(v, jx, train=False, mask=jmask,
                        method=jm.forward_all_features)
    got_all = tm.forward_all_features(tx, mask=tmask)
    assert got_all.shape == (2, 64, 64 + 1024)
    np.testing.assert_allclose(to_np(got_all), np.asarray(want_all), **TOL)


def test_masked_max_and_all_masked_sentinel():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 5)).astype(np.float32)
    m = masks(rng, (2, 10))
    want = np.asarray(jpn.masked_max(jnp.asarray(x), jnp.asarray(m), axis=1))
    got = to_np(tpn.masked_max(torch.from_numpy(x), torch.from_numpy(m), dim=1))
    np.testing.assert_array_equal(got, want)
    encoder = tpn.PointNetEncoder()
    init_flax_(encoder, torch.Generator().manual_seed(0))
    out = encoder(torch.rand(2, 16, 6), mask=torch.from_numpy(masks(rng, (2, 16))))
    assert (out[0] == -1e9).all() and (out[1] != -1e9).all()


def test_train_mode_updates_running_stats_and_eval_does_not():
    """train=True normalises with the batch statistics and moves the running
    ones (flax's 0.9 / 0.1 update); eval leaves them alone (the JAX train-mode
    parity is in tests/test_torch_pointnet_train.py)."""
    encoder = tpn.PointNetEncoder()
    init_flax_(encoder, torch.Generator().manual_seed(0))
    x = torch.rand(2, 8, 6)
    before = {k: b.clone() for k, b in encoder.named_buffers()}
    encoder(x)
    assert all(torch.equal(b, before[k]) for k, b in encoder.named_buffers())
    out = encoder(x, train=True)
    assert out.shape == (2, 1024) and torch.isfinite(out).all()
    moved = [k for k, b in encoder.named_buffers() if not torch.equal(b, before[k])]
    assert sorted(moved) == sorted(before)
    pool = tpn.DenseBNMaxPool(6, 8)
    init_flax_(pool, torch.Generator().manual_seed(1))
    pool(x, train=True)
    z = x.reshape(-1, 6) @ pool.weight.t() + pool.bias
    torch.testing.assert_close(pool.mean, 0.1 * z.mean(0).detach())
