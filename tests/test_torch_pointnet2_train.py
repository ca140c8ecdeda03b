"""The port's PointNet2 modules in train mode against pointcloud_tpu on the
CPU, fp32, on the same randomised flax variables (interop): `SetAbstraction`
with a ball grouping and with `group_all`, `PointNet2Encoder` and
`PointNet2SSGEncoder` at their own widths on B=2 clouds of 1024 points. Off
the TPU the JAX modules train through the XLA oracle `mlp_pool_reference`
and the XLA grouping; the port's CPU tensors take its plain versions.

Tolerances: outputs 1e-4 absolute and relative (other summation orders, a
few ulp a layer, amplified by each BatchNorm's scale / std); updated running
statistics 1e-5. Gradients (`close_grads`): 1e-3 relative plus 1e-3 of the
tensor's largest entry (entries below that are sums that cancel) plus 1e-5
of the module's largest gradient (the last offset of a level that feeds
another level's BatchNorm shifts every row alike, so its true gradient is 0
and both packages leave round-off there), on all but 2 entries of a tensor,
and 4e-3 of the largest entry on all. The slack is for ReLU gates: a level
pushes millions of pre-activations through `pre > 0`, a few lie within fp32
round-off of 0 and flip between the packages, and one flipped gate moves its
channel's sums (cancelling sums over all rows) by one row's cotangent.
Measured over the 137 tensors these tests and
tests/test_torch_pointnet2_train_slice.py compare: 135 have no entry outside
the tight rule and 2 have one (the SSG encoder's input gradient and the
slice's SetAbstraction_1.w0), at 1.30e-3 and 1.33e-3 of the largest entry.
Every seed keeps each squared distance more than 1e-5 (relative) away from
r^2, so the two packages agree on ball membership
(tests/test_torch_pointnet2.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import ball_margin as margin
from torch_port_utils import fps_centroids as centroids
from torch_port_utils import jax_variables, random_variables, to_np, train_mode_pair

from pointcloud_tpu.models import pointnet2 as jpn2
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import pointnet2 as tpn2

TOL = dict(atol=1e-4, rtol=1e-4)
STAT_TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-5


def close_grads(got, want, name, top):
    """`top`: the largest gradient entry of the whole module."""
    err, big = np.abs(got - want), float(np.abs(want).max())
    tight = err <= 1e-3 * np.abs(want) + 1e-3 * big + 1e-5 * top
    assert (~tight).sum() <= 2, name
    assert err.max() <= 4e-3 * big + 1e-5 * top, name


def largest(grads):
    return max(float(np.abs(np.asarray(g)).max()) for g in grads)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("group_all", [False, True])
def test_set_abstraction_train(group_all, masked):
    """Output, gradients of every parameter and of the features and xyz,
    and the running statistics after one train-mode call; then eval reads
    the new statistics and leaves them alone."""
    rng = np.random.default_rng(3)
    xyz = rng.random((2, 128, 3), dtype=np.float32)
    feats = rng.standard_normal((2, 128, 5)).astype(np.float32)
    mask = (rng.random((2, 128)) > 0.25) if masked else None
    if not group_all:
        assert margin(xyz, centroids(xyz, 16, mask), 0.3) > MARGIN
    kw = dict(npoint=None if group_all else 16, radius=None if group_all else 0.3,
              nsample=None if group_all else 8, mlp=(16, 16, 24), group_all=group_all)
    jm = jpn2.SetAbstraction(**kw)
    tm = tpn2.SetAbstraction(kw["npoint"], kw["radius"], kw["nsample"], 3 + 5,
                             kw["mlp"], group_all=group_all)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    v = random_variables(jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats), train=False,
        mask=jmask)), np.random.default_rng(4))
    load_flax_variables(tm, v)
    S = 1 if group_all else 16
    r = rng.standard_normal((2, S, 24)).astype(np.float32)

    def jloss(params, xyz_, feats_):
        (_, out, _), mutated = jm.apply({**v, "params": params}, xyz_, feats_,
                                        train=True, mask=jmask, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, mutated["batch_stats"])

    (_, (jout, jstats)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        v["params"], jnp.asarray(xyz), jnp.asarray(feats))
    txyz = torch.from_numpy(xyz).requires_grad_()
    tfeats = torch.from_numpy(feats).requires_grad_()
    _, tout, _ = tm(txyz, tfeats, train=True, mask=tmask)
    (tout * torch.from_numpy(r)).sum().backward()

    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    top = largest(jg[0].values())
    for k, p in tm.named_parameters():
        close_grads(to_np(p.grad), np.asarray(jg[0][k]), k, top)
    close_grads(to_np(txyz.grad), np.asarray(jg[1]), "xyz", 0.0)
    close_grads(to_np(tfeats.grad), np.asarray(jg[2]), "features", 0.0)
    for k, b in tm.named_buffers():
        assert not np.allclose(to_np(b), v["batch_stats"][k])  # it moved
        np.testing.assert_allclose(to_np(b), np.asarray(jstats[k]), **STAT_TOL,
                                   err_msg=k)

    after = {k: to_np(b).copy() for k, b in tm.named_buffers()}
    _, jeval, _ = jm.apply({"params": v["params"], "batch_stats": jstats},
                           jnp.asarray(xyz), jnp.asarray(feats), train=False, mask=jmask)
    with torch.no_grad():
        _, teval, _ = tm(txyz, tfeats, train=False, mask=tmask)
    np.testing.assert_allclose(to_np(teval), np.asarray(jeval), **TOL)
    for k, b in tm.named_buffers():
        np.testing.assert_array_equal(to_np(b), after[k])


def encoder_cloud(seed, side=1.0):
    """B=2 clouds of 1024 points in a cube of the given side (xyz + 3
    features) whose ball memberships are clear at both levels."""
    x = np.random.default_rng(seed).random((2, 1024, 6), dtype=np.float32)
    x[..., :3] *= np.float32(side)
    c1 = centroids(x[..., :3].copy(), 512)
    assert margin(x[..., :3], c1, 0.2) > MARGIN
    assert margin(c1, centroids(c1, 128), 0.4) > MARGIN
    return x


@pytest.mark.parametrize("name", ["PointNet2Encoder", "PointNet2SSGEncoder"])
def test_encoder_train_mode_matches_jax(name):
    # the SSG level 1 takes 64 neighbours: in a cube of side 0.6 its balls
    # are full, where the unit cube would fill them with ~30 copies of their
    # first point, and a flipped gate on that row would count ~30 times
    x = encoder_cloud(16, side=0.6) if "SSG" in name else encoder_cloud(2)
    jm, tm = getattr(jpn2, name)(), getattr(tpn2, name)()
    assert tm.SetAbstraction_0.nsample == (64 if "SSG" in name else 32)
    v = jax_variables(jm, x, 5)
    load_flax_variables(tm, v)
    res = train_mode_pair(jm, tm, v, x, seed=6)
    (jout, jgr, jstats, jdx), (tout, tgr, tstats, tdx) = res["jax"], res["port"]
    assert tout.shape == (2, 1024)
    np.testing.assert_allclose(tout, jout, **TOL)
    assert set(tgr) == set(jgr) and len(tgr) == 27
    top = largest(jgr.values())
    for k in jgr:
        close_grads(tgr[k], jgr[k], k, top)
    close_grads(tdx, jdx, "input", 0.0)
    assert set(tstats) == set(jstats) and len(tstats) == 18
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], **STAT_TOL, err_msg=k)


def test_ssg_encoder_eval_matches_jax():
    x = encoder_cloud(2)
    jm, tm = jpn2.PointNet2SSGEncoder(), tpn2.PointNet2SSGEncoder()
    v = jax_variables(jm, x, 7)
    assert set(flax_to_state_dict(v)) == set(tm.state_dict())
    load_flax_variables(tm, v)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="first 3 dims"):
        tpn2.PointNet2SSGEncoder(space_dims=2)
