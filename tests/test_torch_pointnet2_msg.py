"""The port's multi-scale-grouping set abstraction (`SetAbstractionMsg`)
against pointcloud_tpu's on the CPU, fp32, at narrow widths (npoint 32 of
128 points, radii 0.2 / 0.4, 8 / 16 neighbours, branch MLPs (8, 16) and
(8, 8, 16)), on the same randomised flax variables (interop): eval and train
mode, with and without features, with masks that leave a cloud under-full
and one fully masked (its groups pool to the -1e9 sentinel).

Off the TPU the JAX module groups through XLA's `ball_query` (the matmul
expansion of the distance), the port through `group_gather`'s plain version
(direct differences): every seed keeps each float64 squared distance more
than 1e-5 (relative) away from each r^2, so both agree on membership.
Tolerances: eval outputs 1e-5 absolute and relative. Train outputs 1e-4
(with features): the JAX module's batch statistics are E[z^2] - E[z]^2 over
~1500 rows summed in fp32 on XLA's CPU, which loses digits (measured, masked
clouds: the JAX module's train output 8.3e-5 from the port's in float64, the
port's in fp32 2.5e-6 from it; PointNet2's SA tests hold 1e-4 for the same
reason). Without features the first layer sees only three centred
coordinates (|x| <= 0.4) plus a bias, a batch variance that is a small
difference of large sums: 3e-4 there (measured 1.2e-4; the port's fp32
output 2.3e-6 from its float64 one). Train mode without features on the
masked clouds is not compared: their many repeated rows (the fully masked
cloud's groups are all one point, the under-full cloud's repeat 20 points)
leave the JAX module's fp32 output 3.4e-3 from its own float64 run, the
port's 1.6e-5 from its own. Running statistics after one train forward
1e-5. Gradients by `close_grads` of tests/test_torch_pointnet2_train.py
(1e-3 relative plus 1e-3 of the tensor's largest entry, with its stated
slack for ReLU gates within round-off of 0); the biases of Dense layers that
feed a train-mode BatchNorm have a true gradient of 0 and are held to be
round-off (below 1e-4 of the largest gradient) on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pointnet2_train import close_grads, largest
from torch_port_utils import ball_margin as margin
from torch_port_utils import fps_centroids as centroids
from torch_port_utils import random_variables, to_np

from pointcloud_tpu.models import pointnet2 as jpn2
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import pointnet2 as tpn2
from pointcloud_tpu_torch.train.harness import zero_gradient_biases

TOL = dict(atol=1e-5, rtol=1e-5)
TRAIN_TOL = {True: dict(atol=1e-4, rtol=1e-4), False: dict(atol=3e-4, rtol=3e-4)}
MARGIN = 1e-5
KW = dict(npoint=32, radius_list=(0.2, 0.4), nsample_list=(8, 16),
          mlp_list=((8, 16), (8, 8, 16)))
N, F = 128, 4


def setup(seed, masked, with_feats=True):
    """Clouds, mask (with `masked`, cloud 1 under-full: 20 valid points for
    32 centroids, and cloud 2 fully masked), the two modules holding the same random
    variables."""
    rng = np.random.default_rng(seed)
    B = 3 if masked else 2
    xyz = rng.random((B, N, 3), dtype=np.float32)
    feats = rng.standard_normal((B, N, F)).astype(np.float32) if with_feats else None
    mask = None
    if masked:
        mask = rng.random((B, N)) > 0.25
        mask[1] = False
        mask[1, rng.choice(N, 20, replace=False)] = True
        mask[2] = False
    cents = centroids(xyz, KW["npoint"], mask)
    for r in KW["radius_list"]:
        assert margin(xyz, cents, r) > MARGIN
    jm = jpn2.SetAbstractionMsg(**KW)
    tm = tpn2.SetAbstractionMsg(KW["npoint"], KW["radius_list"], KW["nsample_list"],
                                F if with_feats else 0, KW["mlp_list"])
    jf = None if feats is None else jnp.asarray(feats)
    jmask = None if mask is None else jnp.asarray(mask)
    v = random_variables(jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(xyz), jf, train=False, mask=jmask)),
        np.random.default_rng(seed + 1))
    load_flax_variables(tm, v)
    tf = None if feats is None else torch.from_numpy(feats)
    tmask = None if mask is None else torch.from_numpy(mask)
    return xyz, (jf, jmask), (tf, tmask), jm, tm, v


def test_flax_names_and_interop():
    """Children carry flax's compact names across the branches, and interop
    loads the JAX module's variables with no missing or extra key."""
    _, _, _, _, tm, v = setup(0, False)
    assert sorted(v["params"]) == ["BatchNorm_0", "BatchNorm_1", "BatchNorm_2",
                                   "DenseBNMaxPool_0", "DenseBNMaxPool_1",
                                   "Dense_0", "Dense_1", "Dense_2"]
    assert set(flax_to_state_dict(v)) == set(tm.state_dict())
    np.testing.assert_array_equal(to_np(tm.Dense_2.weight),
                                  v["params"]["Dense_2"]["kernel"].T)
    assert tm.out_features == 32


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_feats", [True, False])
def test_eval_matches_jax(masked, with_feats):
    xyz, (jf, jmask), (tf, tmask), jm, tm, v = setup(3, masked, with_feats)
    jxyz, jout, jnew = jm.apply(v, jnp.asarray(xyz), jf, train=False, mask=jmask)
    with torch.inference_mode():
        txyz, tout, tnew = tm(torch.from_numpy(xyz), tf, train=False, mask=tmask)
    assert tout.shape == (xyz.shape[0], 32, 32) and tout.dtype == torch.float32
    np.testing.assert_array_equal(to_np(txyz), np.asarray(jxyz))
    np.testing.assert_array_equal(to_np(tnew), np.asarray(jnew))
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TOL)
    if masked:  # the fully masked cloud pools to the sentinel, the rest not
        assert (to_np(tout)[2] == -1e9).all() and not to_np(tnew)[2].any()
        assert (to_np(tout)[:2] > -5e8).all() and to_np(tnew)[:2].all()


@pytest.mark.parametrize("masked,with_feats",
                         [(False, True), (True, True), (False, False)])
def test_train_matches_jax(masked, with_feats):
    """Output, every parameter's gradient and the features' after one
    train-mode call, and the running statistics it leaves."""
    xyz, (jf, jmask), (tf, tmask), jm, tm, v = setup(5, masked, with_feats)
    r = np.random.default_rng(6).standard_normal((xyz.shape[0], 32, 32)).astype(
        np.float32)

    def jloss(params, feats_):
        (_, out, _), mutated = jm.apply({**v, "params": params}, jnp.asarray(xyz),
                                        feats_, train=True, mask=jmask,
                                        mutable=["batch_stats"])
        # the -1e9 sentinel carries no gradient; keep it out of the sum
        return jnp.sum(jnp.where(out > -5e8, out, 0.0) * r), (out, mutated)

    args = (v["params"],) + ((jf,) if with_feats else ())
    (_, (jout, mutated)), jg = jax.value_and_grad(
        lambda p, *f: jloss(p, f[0] if f else None), argnums=tuple(range(len(args))),
        has_aux=True)(*args)
    tfg = None if tf is None else tf.clone().requires_grad_()
    _, tout, _ = tm(torch.from_numpy(xyz), tfg, train=True, mask=tmask)
    (torch.where(tout > -5e8, tout, 0.0) * torch.from_numpy(r)).sum().backward()

    np.testing.assert_allclose(to_np(tout), np.asarray(jout), **TRAIN_TOL[with_feats])
    jgrads = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, jg[0])})
    tgrads = {k: to_np(p.grad) for k, p in tm.named_parameters()}
    assert set(tgrads) == set(jgrads)
    top = largest(to_np(g) for g in jgrads.values())
    zero = zero_gradient_biases(tm)
    assert len(zero) == 5  # the hidden Dense layers' and the DenseBNMaxPools' biases
    for k, w in jgrads.items():
        if k in zero:
            assert np.abs(tgrads[k]).max() <= 1e-4 * top, k
            assert np.abs(to_np(w)).max() <= 1e-4 * top, k
            continue
        close_grads(tgrads[k], to_np(w), k, top)
    if with_feats:
        close_grads(to_np(tfg.grad), np.asarray(jg[1]), "features", 0.0)
    jstats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mutated["batch_stats"])})
    tstats = dict(tm.named_buffers())
    assert set(tstats) == set(jstats) and len(tstats) == 10
    for k, w in jstats.items():
        assert not np.allclose(to_np(w), flax_to_state_dict(v)[k].numpy())  # moved
        np.testing.assert_allclose(to_np(tstats[k]), to_np(w), **TOL, err_msg=k)
