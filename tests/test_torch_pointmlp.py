"""The port's PointMLP modules in eval mode against pointcloud_tpu's flax
modules on the CPU, on the same interop-converted (randomised) variables:
LocalGrouper (every `normalize` mode, `use_xyz` both ways, with a mask),
PreExtraction (1 and 2 blocks, res_expansion 1.0 and 0.25, `use_bias` both
ways), PosExtraction, ResBlock and DenseBNAct at narrow widths; and the
train-mode forwards of PreExtraction and the backbone (their gradients are
held in tests/test_torch_pointmlp_train.py).

Tolerances (fp32 on both sides): 1e-5 absolute and relative for a module,
1e-4 for the whole backbone (four stages of that round-off). The products
and BatchNorms compute the same operations, summed in other orders (BLAS
against XLA), ~1e-7 relative; the per-cloud std of LocalGrouper sums
~10^4 values in fp32 in other orders. The JAX package groups through its
XLA kNN (the matmul expansion), the port through the kernel's direct
differences: each input keeps every centroid's k-th and (k+1)-th float64
distances 1e-5 apart (relative), so both pick the same neighbours, and the
slot order within a group does not matter downstream (the std, the group
mean and the max over K ignore it); the grouped outputs are compared
per group as sorted columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import fps_centroids, knn_margin, random_variables, to_np

from pointcloud_tpu.models import pointmlp as jpm
from pointcloud_tpu_torch.interop import flax_to_state_dict, load_flax_variables
from pointcloud_tpu_torch.models import pointmlp as tpm
from pointcloud_tpu_torch.ops.fps import fps_reference

TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-5


def flax_vars(module, seed, *args, **kw):
    """Random flax variables (torch_port_utils.random_variables) of `module`
    for the given call."""
    v = module.init(jax.random.PRNGKey(0), *[jnp.asarray(a) for a in args], **kw)
    return random_variables(jax.tree_util.tree_map(np.asarray, dict(v)),
                            np.random.default_rng(seed))


def apply(module, v, *args, **kw):
    kw = {k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
          for k, a in kw.items()}
    return module.apply(v, *[jnp.asarray(a) for a in args], **kw)


def cloud(seed, B, N, D, masked=False):
    rng = np.random.default_rng(seed)
    xyz = rng.random((B, N, 3), dtype=np.float32)
    feats = rng.standard_normal((B, N, D)).astype(np.float32)
    mask = (rng.random((B, N)) > 0.2) if masked else None
    return xyz, feats, mask


@pytest.mark.parametrize("normalize", ["anchor", "center", None])
@pytest.mark.parametrize("use_xyz", [False, True])
def test_local_grouper_matches_flax(normalize, use_xyz):
    B, N, D, G, K = 2, 96, 6, 24, 10
    xyz, feats, mask = cloud(3, B, N, D, masked=True)
    assert knn_margin(xyz, fps_centroids(xyz, G, mask), K, mask) > MARGIN
    jm = jpm.LocalGrouper(groups=G, kneighbors=K, use_xyz=use_xyz,
                          normalize=normalize)
    v = (flax_vars(jm, 1, xyz, feats, mask=mask) if normalize is not None
         else {})
    tm = tpm.LocalGrouper(K, D, use_xyz=use_xyz, normalize=normalize)
    load_flax_variables(tm, v)
    jx, jg, jmask = apply(jm, v, xyz, feats, mask=mask)
    with torch.inference_mode():
        tx, tg, tmask = tm(torch.from_numpy(xyz), torch.from_numpy(feats), G,
                           mask=torch.from_numpy(mask))
    width = 2 * D + (3 if use_xyz else 0)
    assert tg.shape == (B, G, K, width) and tg.dtype == torch.float32
    np.testing.assert_array_equal(to_np(tx), np.asarray(jx))
    np.testing.assert_array_equal(to_np(tmask), np.asarray(jmask))
    np.testing.assert_allclose(np.sort(to_np(tg), axis=2),
                               np.sort(np.asarray(jg), axis=2), **TOL)


@pytest.mark.parametrize("residual", [True, False])
def test_layer_res_cfg_is_a_copy_of_the_jax_packages(residual):
    """The port's copy of preextract_fused._layer_res_cfg, which sets
    PreExtraction's residual adds, gives the same (mode, source) for every
    layer of 1- to 3-block stacks."""
    from pointcloud_tpu.ops.preextract_fused import _layer_res_cfg

    for L in (3, 5, 7):
        for u in range(L):
            assert tpm.layer_res_cfg(u, L, residual) == _layer_res_cfg(u, L, residual)


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("res_expansion", [1.0, 0.25])
@pytest.mark.parametrize("use_bias", [False, True])
def test_pre_extraction_eval_matches_flax(blocks, res_expansion, use_bias):
    B, G, K, D, C = 2, 6, 8, 10, 16
    x = np.random.default_rng(blocks).standard_normal((B, G, K, D)).astype(np.float32)
    jm = jpm.PreExtraction(C, blocks, res_expansion, use_bias)
    v = flax_vars(jm, 10 * blocks + int(4 * res_expansion), x, train=False)
    tm = tpm.PreExtraction(D, C, blocks, res_expansion, use_bias)
    load_flax_variables(tm, v)
    want = np.asarray(apply(jm, v, x, train=False))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.shape == (B, G, C)
    np.testing.assert_allclose(to_np(got), want, **TOL)
    if not use_bias:  # mid width int(C * res_expansion), as the JAX package
        assert tm.w1.shape == (C, int(C * res_expansion))
    # train mode: the batch statistics, and the running ones move as flax's
    want, mutated = apply(jm, v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mutated["batch_stats"])})
    assert set(stats) == {k for k, _ in tm.named_buffers()}
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(to_np(b), stats[k], **TOL, err_msg=k)


@pytest.mark.parametrize("blocks,res_expansion", [(1, 1.0), (2, 0.25)])
def test_pos_extraction_and_res_block_match_flax(blocks, res_expansion):
    B, G, C = 2, 20, 16
    x = np.random.default_rng(7).standard_normal((B, G, C)).astype(np.float32)
    for jm, tm in (
            (jpm.PosExtraction(C, blocks, res_expansion, False),
             tpm.PosExtraction(C, blocks, res_expansion, False)),
            (jpm.ResBlock(C, res_expansion, True), tpm.ResBlock(C, res_expansion, True)),
            (jpm.DenseBNAct(C, False), tpm.DenseBNAct(C, C, False))):
        v = flax_vars(jm, blocks, x, train=False)
        load_flax_variables(tm, v)
        with torch.inference_mode():
            got = tm(torch.from_numpy(x))
        np.testing.assert_allclose(to_np(got), np.asarray(apply(jm, v, x, train=False)),
                                   **TOL)
    # a bias-free Dense registers no bias, as flax creates none
    assert "Dense_0.bias" not in tpm.DenseBNAct(C, C, False).state_dict()


@pytest.mark.parametrize("factory", ["PointMLP", "PointMLPElite"])
def test_backbone_matches_flax_with_a_mask(factory):
    """The whole backbone at narrow input (B=2 x 256 points, 6 dims, ~20% of
    the points masked): FPS and the kNN grouping honour the mask at every
    stage, the final max does not (as in the JAX package)."""
    B, N = 2, 256
    rng = np.random.default_rng(11)
    x = rng.random((B, N, 6), dtype=np.float32)
    mask = rng.random((B, N)) > 0.2
    xyz, m = x[..., :3], mask
    for _ in range(4):  # every stage's centroids keep their k-NN set apart
        idx = to_np(fps_reference(torch.from_numpy(xyz), xyz.shape[1] // 2,
                                  torch.from_numpy(m))).astype(np.int64)
        cents = np.take_along_axis(xyz, idx[..., None], 1)
        assert knn_margin(xyz, cents, 24, m) > MARGIN
        m = np.take_along_axis(m, idx, 1)
        xyz = cents
    jm = getattr(jpm, factory)(feature_dims=3)
    tm = getattr(tpm, factory)(feature_dims=3)
    v = flax_vars(jm, 12, x, train=False, mask=mask)
    load_flax_variables(tm, v)
    want = np.asarray(apply(jm, v, x, train=False, mask=mask))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
    assert got.shape == (B, tm.encoding_dim) == want.shape
    np.testing.assert_allclose(to_np(got), want, atol=1e-4, rtol=1e-4)
    # train mode with the same mask (the BatchNorm statistics include the
    # masked points, as in the JAX package)
    want = apply(jm, v, x, train=True, mask=mask, mutable=["batch_stats"])[0]
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
