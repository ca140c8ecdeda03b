"""The port's PointNet2 pieces in eval mode against pointcloud_tpu on the
CPU, fp32, on the same randomised flax variables: `sample_and_group`,
`sample_and_group_all`, `SetAbstraction` at narrow widths and the
`PointNet2Encoder` at its own widths on B=2 clouds of 1024 points. Train
mode is held in tests/test_torch_pointnet2_train.py.

Off the TPU the JAX package groups through its XLA `ball_query` (the matmul
expansion of the distance); the port follows the TPU kernel's direct
differences. The two agree on membership unless a squared distance lies
within fp32 round-off of r^2, so every test asserts that no float64 squared
distance lies within 1e-5 (relative) of r^2 for its seed (the round-off of
either formula is ~1e-6 of r^2 here).

Tolerances: FPS centroids, group masks and grouped tensors exact (the same
gathers and one fp32 subtraction on both sides); MLP outputs 1e-4 absolute
and relative (XLA and PyTorch's CPU matmuls sum in different orders, a few
ulp a layer, as tests/test_torch_pointnet.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import ball_margin as margin
from torch_port_utils import fps_centroids as centroids
from torch_port_utils import random_variables, to_np

from pointcloud_tpu.models import pointnet2 as jpn2
from pointcloud_tpu.ops import geometry as jgeo
from pointcloud_tpu_torch.interop import load_flax_variables
from pointcloud_tpu_torch.models import pointnet2 as tpn2
from pointcloud_tpu_torch.ops import geometry as tgeo

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-5


def pair(jmod, tmod, args, seed, **kw):
    v = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args], train=False, **kw))
    v = random_variables(v, np.random.default_rng(seed))
    load_flax_variables(tmod, v)
    return v


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_feats", [False, True])
def test_sample_and_group(masked, with_feats):
    rng = np.random.default_rng(0)
    xyz = rng.random((2, 256, 3), dtype=np.float32)
    feats = rng.standard_normal((2, 256, 4)).astype(np.float32) if with_feats else None
    mask = (rng.random((2, 256)) > 0.25) if masked else None
    assert margin(xyz, centroids(xyz, 32, mask), 0.25) > MARGIN
    t = [torch.from_numpy(a) if a is not None else None for a in (xyz, feats, mask)]
    j = [jnp.asarray(a) if a is not None else None for a in (xyz, feats, mask)]
    got = tgeo.sample_and_group(32, 0.25, 12, t[0], t[1], mask=t[2])
    want = jgeo.sample_and_group(32, 0.25, 12, j[0], j[1], mask=j[2])
    assert got[1].shape == (2, 32, 12, 3 + (4 if with_feats else 0))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    got = tgeo.sample_and_group_all(t[0], t[1], mask=t[2])
    want = jgeo.sample_and_group_all(j[0], j[1], mask=j[2])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("group_all", [False, True])
def test_set_abstraction(masked, group_all):
    rng = np.random.default_rng(1)
    xyz = rng.random((2, 128, 3), dtype=np.float32)
    feats = rng.standard_normal((2, 128, 5)).astype(np.float32)
    mask = (rng.random((2, 128)) > 0.25) if masked else None
    if masked and group_all:
        mask[1] = False  # no valid row: the -1e9 sentinel
    if not group_all:
        assert margin(xyz, centroids(xyz, 16, mask), 0.3) > MARGIN
    kw = dict(npoint=None if group_all else 16, radius=None if group_all else 0.3,
              nsample=None if group_all else 8, mlp=(16, 32), group_all=group_all)
    jm = jpn2.SetAbstraction(**kw)
    tm = tpn2.SetAbstraction(kw["npoint"], kw["radius"], kw["nsample"], 3 + 5,
                             kw["mlp"], group_all=group_all)
    m = None if mask is None else jnp.asarray(mask)
    v = pair(jm, tm, (xyz, feats), 2, mask=m)
    jx, jf, jmask = jm.apply(v, jnp.asarray(xyz), jnp.asarray(feats), train=False,
                             mask=m)
    tx, tf, tmask = tm(torch.from_numpy(xyz), torch.from_numpy(feats),
                       mask=None if mask is None else torch.from_numpy(mask))
    assert tf.shape == (2, 1 if group_all else 16, 32)
    np.testing.assert_array_equal(to_np(tx), np.asarray(jx))
    np.testing.assert_array_equal(to_np(tmask), np.asarray(jmask))
    np.testing.assert_allclose(to_np(tf), np.asarray(jf), **TOL)
    if masked and group_all:
        assert (to_np(tf)[1] == -1e9).all()


def test_pointnet2_encoder_at_its_widths():
    """B=2 clouds of 1024 points in the unit cube, xyz + 3 features."""
    rng = np.random.default_rng(2)
    x = rng.random((2, 1024, 6), dtype=np.float32)
    c1 = centroids(x[..., :3].copy(), 512)
    assert margin(x[..., :3], c1, 0.2) > MARGIN
    assert margin(c1, centroids(c1, 128), 0.4) > MARGIN
    jm, tm = jpn2.PointNet2Encoder(), tpn2.PointNet2Encoder()
    v = pair(jm, tm, (x,), 3)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 1024) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_train_mode_raises_and_init_follows_flax():
    """Train mode runs (tests/test_torch_pointnet2_train.py holds it against
    the JAX package); what still raises there is a feature width the level's
    weights do not take."""
    sa = tpn2.SetAbstraction(8, 0.3, 4, 6, (16, 32))
    from pointcloud_tpu_torch.models.layers import init_flax_

    init_flax_(sa, torch.Generator().manual_seed(0))
    _, out, _ = sa(torch.rand(1, 32, 3), torch.rand(1, 32, 3), train=True)
    assert out.shape == (1, 8, 32) and out.requires_grad
    assert not torch.equal(sa.mean0, torch.zeros(16))  # the statistics moved
    with pytest.raises(ValueError, match="do not chain"):
        sa(torch.rand(1, 32, 3), torch.rand(1, 32, 5), train=True)
    init_flax_(sa, torch.Generator().manual_seed(0))
    assert sa.w1.shape == (16, 32)  # flax's (in, out) layout
    assert float(sa.w1.detach().std()) == pytest.approx(16 ** -0.5, rel=0.2)
    assert float(sa.w1.detach().abs().max()) <= 2 * 16 ** -0.5 / 0.8796 + 1e-6
    assert torch.equal(sa.scale0, torch.ones(16)) and torch.equal(sa.var1, torch.ones(32))
    assert torch.equal(sa.offset1, torch.zeros(32)) and torch.equal(sa.mean0, torch.zeros(16))
