"""The port's kNN grouping (its plain version, which CPU tensors take, and
the autograd Function around it) against pointcloud_tpu on the CPU: the
Pallas kernel in interpret mode (`grouped_gather_knn(_feats)(...,
interpret=True)`, which needs k % 8 == 0) and `jax.vjp` of it; the port's
`knn`, `group_neighbors`, `sample_and_group(use_knn=True)` and
`three_nn_interpolate` against the JAX package's.

Tolerances: against the TPU kernel, idx equal slot by slot and the gathered
values bit-equal (both compute the same rounded direct differences and the
same selection; the kernel's one-hot gather is exact in fp32); gradients
1e-6 relative to the largest entry (the two scatter in other orders). For k
not a multiple of 8 the TPU kernel runs at the next multiple of 8: slots
below the valid count are the same extraction order, slots past it repeat
slot 0, so the k-slot result is the prefix of that one. Against the XLA
path (the matmul expansion of the distance) the inputs keep every
centroid's k-th and (k+1)-th float64 distances 1e-5 apart (relative), so
both pick the same set; `knn` (matmul expansion on both sides) is held slot
by slot with every gap up to the (k+1)-th kept 1e-5 apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import fps_centroids, knn_margin, to_np

from pointcloud_tpu.ops import geometry as jgeo
from pointcloud_tpu.ops.pallas_kernels import (
    grouped_gather_knn,
    grouped_gather_knn_feats,
)
from pointcloud_tpu_torch.ops import geometry as tgeo
from pointcloud_tpu_torch.ops.knn_group import knn_group, knn_group_reference

MARGIN = 1e-5  # fp32 round-off of either distance formula is ~1e-7 here


def case(seed, B, N, S, F, valid=0.7):
    """Unit-cube clouds, centroids on every (N // S)-th point, masks with
    ~30% of the points invalid; cloud 1 keeps only 3 valid points (an
    under-full cloud) when B > 1."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((B, N, 3), dtype=np.float32)
    feats = rng.standard_normal((B, N, F)).astype(np.float32)
    cents = xyz[:, :: N // S][:, :S].copy()
    mask = rng.random((B, N)) < valid
    if B > 1:
        mask[1] = False
        mask[1, [2, N // 2, N - 1]] = True
    return xyz, feats, cents, mask


def tpu_kernel(xyz, feats, cents, mask, k, with_xyz):
    """The interpret-mode TPU kernel at k8 = k rounded up to a multiple of 8,
    cut to k slots: (gx or None, gf, idx) as numpy."""
    k8 = -(-k // 8) * 8
    pen = (jnp.zeros((xyz.shape[0], xyz.shape[1], 1), jnp.float32) if mask is None
           else jnp.where(jnp.asarray(mask)[..., None], 0.0, jnp.float32(1e9)))
    args = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(cents), pen, k8, True)
    if with_xyz:
        gx, gf, idx = grouped_gather_knn(*args)
        gx = np.asarray(gx)[:, :, :k]
    else:
        (gf, idx), gx = grouped_gather_knn_feats(*args), None
    return gx, np.asarray(gf)[:, :, :k], np.asarray(idx)[:, :, :k]


def port(xyz, feats, cents, mask, k, with_xyz):
    gx, gf, idx = knn_group(torch.from_numpy(xyz),
                            None if feats is None else torch.from_numpy(feats),
                            torch.from_numpy(cents),
                            None if mask is None else torch.from_numpy(mask),
                            k, with_xyz)
    return (None if gx is None else to_np(gx), None if gf is None else to_np(gf),
            to_np(idx))


@pytest.mark.parametrize("k", [5, 8, 13, 24])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_xyz", [False, True])
def test_matches_the_tpu_kernel(k, masked, with_xyz):
    """Both entry points (grouped_gather_knn and its feats-only variant),
    N not a multiple of 8, k not a multiple of 8, an under-full cloud."""
    xyz, feats, cents, mask = case(k, 2, 100, 12, 5)
    mask = mask if masked else None
    gx, gf, idx = port(xyz, feats, cents, mask, k, with_xyz)
    tgx, tgf, tidx = tpu_kernel(xyz, feats, cents, mask, k, with_xyz)
    assert idx.dtype == np.int32 and idx.shape == (2, 12, k)
    np.testing.assert_array_equal(idx, tidx)
    np.testing.assert_array_equal(gf, tgf)
    if with_xyz:
        np.testing.assert_array_equal(gx, tgx)
        np.testing.assert_array_equal(gx, xyz[np.arange(2)[:, None, None], idx])
    else:
        assert gx is None
    if masked:  # the under-full cloud: its 3 valid points, then slot 0 again
        valid = np.flatnonzero(mask[1])
        assert set(idx[1, :, :3].ravel()) <= set(valid)
        np.testing.assert_array_equal(idx[1, :, 3:],
                                      np.repeat(idx[1, :, :1], k - 3, axis=1))


def test_small_clouds_fully_masked_clouds_and_no_features():
    """k > N (every slot past N repeats slot 0); a cloud without a valid
    point (every slot the least penalised distance: point 0 at unit scale,
    as the XLA path gives too); feats=None (the F = 0 case)."""
    xyz, feats, cents, mask = case(40, 2, 20, 4, 3)
    mask[0] = False
    gx, gf, idx = port(xyz, feats, cents, mask, 24, True)
    tgx, tgf, tidx = tpu_kernel(xyz, feats, cents, mask, 24, True)
    np.testing.assert_array_equal(idx, tidx)
    np.testing.assert_array_equal(gf, tgf)
    np.testing.assert_array_equal(gx, tgx)
    assert (idx[0] == 0).all()
    jidx, _ = jgeo.knn(3, jnp.asarray(xyz), jnp.asarray(cents), jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(jidx)[0], idx[0, :, :3])
    nx, nf, nidx = port(xyz, None, cents, mask, 24, True)
    assert nf is None
    np.testing.assert_array_equal(nidx, idx)
    np.testing.assert_array_equal(nx, gx)
    _, nf, nidx = port(xyz, None, cents, None, 7, False)
    assert nf is None and nidx.shape == (2, 4, 7)


def jax_grads(xyz, feats, cents, mask, k, cots, with_xyz):
    pen = jnp.where(jnp.asarray(mask)[..., None], 0.0, jnp.float32(1e9))
    fn = grouped_gather_knn if with_xyz else grouped_gather_knn_feats

    def loss(x, f):
        out = fn(x, f, jnp.asarray(cents), pen, k, True)
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(out, cots))

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1))(jnp.asarray(xyz), jnp.asarray(feats))]


@pytest.mark.parametrize("with_xyz", [False, True])
@pytest.mark.parametrize("k", [8, 24])
def test_gradients_match_the_tpu_kernels_vjp(with_xyz, k):
    """One scatter of the grouped cotangent back onto the points; xyz gets
    none in the feats-only variant (the JAX package's zeros)."""
    xyz, feats, cents, mask = case(50 + k, 2, 96, 16, 6)
    rng = np.random.default_rng(k)
    cots = [rng.standard_normal((2, 16, k, 3)).astype(np.float32)] if with_xyz else []
    cots.append(rng.standard_normal((2, 16, k, 6)).astype(np.float32))
    want = jax_grads(xyz, feats, cents, mask, k, cots, with_xyz)

    def grads(fn):
        x = torch.from_numpy(xyz).requires_grad_()
        f = torch.from_numpy(feats).requires_grad_()
        gx, gf, _ = fn(x, f, torch.from_numpy(cents), torch.from_numpy(mask), k,
                       with_xyz)
        outs = ([gx] if with_xyz else []) + [gf]
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
        loss.backward()
        return x.grad, f.grad

    got = grads(knn_group)
    plain = grads(knn_group_reference)  # autograd through its gathers
    for g, p, w in zip(got, plain, want):
        if g is None:  # the feats-only variant's xyz: zero in the JAX package
            assert not with_xyz and not w.any() and p is None
            continue
        tol = 1e-6 * np.abs(w).max()
        assert np.abs(to_np(g) - w).max() <= tol
        assert np.abs(to_np(p) - w).max() <= tol


@pytest.mark.parametrize("k", [5, 24])
@pytest.mark.parametrize("masked", [False, True])
def test_knn_matches_the_jax_package(k, masked):
    """`knn` (the matmul expansion on both sides): idx slot by slot and the
    distances, under-full clouds repeating slot 0, at k not a multiple of
    8; three_nn_interpolate over it."""
    xyz, feats, cents, mask = case(60 + k, 2, 120, 15, 4)
    mask = mask if masked else None
    assert knn_margin(xyz, cents, k, mask, gaps=k) > MARGIN
    jm = None if mask is None else jnp.asarray(mask)
    ji, jd = jgeo.knn(k, jnp.asarray(xyz), jnp.asarray(cents), jm)
    ti, td = tgeo.knn(k, torch.from_numpy(xyz), torch.from_numpy(cents),
                      None if mask is None else torch.from_numpy(mask))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    np.testing.assert_allclose(to_np(td), np.asarray(jd), rtol=1e-6, atol=1e-6)
    want = jgeo.three_nn_interpolate(jnp.asarray(cents), jnp.asarray(xyz),
                                     jnp.asarray(feats), jm)
    got = tgeo.three_nn_interpolate(torch.from_numpy(cents), torch.from_numpy(xyz),
                                    torch.from_numpy(feats),
                                    None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_knn_rejects_what_it_cannot_do():
    xyz, _, cents, _ = case(70, 1, 32, 4, 1)
    with pytest.raises(NotImplementedError, match="approx_max_k"):
        tgeo.knn(4, torch.from_numpy(xyz), torch.from_numpy(cents), approx=True)
    with pytest.raises(ValueError):
        tgeo.knn(40, torch.from_numpy(xyz), torch.from_numpy(cents))


@pytest.mark.parametrize("with_xyz", [False, True])
def test_group_neighbors_matches_both_jax_routes(with_xyz):
    """The TPU route (interpret mode) exactly; the XLA route (knn +
    index_points) as sets, on an input with a margin; radius mode is the
    legacy kernel's ball mode (tests/test_torch_group_gather.py), equal to
    the TPU route's."""
    xyz, feats, cents, mask = case(80, 2, 128, 16, 5)
    k = 16
    args = [torch.from_numpy(a) for a in (xyz, feats, cents)]
    gx, gf, idx, valid = tgeo.group_neighbors(*args, k, mask=torch.from_numpy(mask),
                                              with_xyz=with_xyz)
    jargs = [jnp.asarray(a) for a in (xyz, feats, cents)]
    jgx, jgf, jidx, jvalid = jgeo.group_neighbors(
        *jargs, k, mask=jnp.asarray(mask), impl="pallas", interpret=True,
        with_xyz=with_xyz)
    np.testing.assert_array_equal(to_np(idx), np.asarray(jidx))
    np.testing.assert_array_equal(to_np(gf), np.asarray(jgf))
    np.testing.assert_array_equal(to_np(valid), np.asarray(jvalid))
    assert (gx is None) == (jgx is None) == (not with_xyz)
    if with_xyz:
        np.testing.assert_array_equal(to_np(gx), np.asarray(jgx))

    assert knn_margin(xyz, cents, k, mask) > MARGIN
    _, xgf, xidx, _ = jgeo.group_neighbors(*jargs, k, mask=jnp.asarray(mask),
                                           impl="xla", with_xyz=with_xyz)
    np.testing.assert_array_equal(np.sort(to_np(idx), -1),
                                  np.sort(np.asarray(xidx), -1))
    ball = tgeo.group_neighbors(*args, k, radius=0.2, mask=torch.from_numpy(mask),
                                with_xyz=with_xyz)
    jball = jgeo.group_neighbors(*jargs, k, radius=0.2, mask=jnp.asarray(mask),
                                 impl="pallas", interpret=True, with_xyz=with_xyz)
    for got, want in zip(ball, jball):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_sample_and_group_with_knn_matches_the_jax_package(masked):
    """FPS, the kNN grouping, the centring and the concatenation; the rows of
    each group compared as sets (sorted by point index)."""
    rng = np.random.default_rng(90)
    xyz = rng.random((2, 160, 3), dtype=np.float32)
    feats = rng.standard_normal((2, 160, 4)).astype(np.float32)
    mask = (rng.random((2, 160)) > 0.25) if masked else None
    k = 12
    assert knn_margin(xyz, fps_centroids(xyz, 20, mask), k, mask) > MARGIN
    jm = None if mask is None else jnp.asarray(mask)
    jn, jg, jgm, jnm = jgeo.sample_and_group(20, 0.2, k, jnp.asarray(xyz),
                                             jnp.asarray(feats), jm, use_knn=True)
    tn, tg, tgm, tnm = tgeo.sample_and_group(
        20, 0.2, k, torch.from_numpy(xyz), torch.from_numpy(feats),
        None if mask is None else torch.from_numpy(mask), use_knn=True)
    np.testing.assert_array_equal(to_np(tn), np.asarray(jn))
    np.testing.assert_array_equal(to_np(tgm), np.asarray(jgm))
    np.testing.assert_array_equal(to_np(tnm), np.asarray(jnm))
    assert tg.shape == (2, 20, k, 7) and tg.dtype == torch.float32
    # each group's values channel by channel, in sorted order: equal sets
    # of rows give equal columns
    np.testing.assert_allclose(np.sort(to_np(tg), axis=2),
                               np.sort(np.asarray(jg), axis=2), rtol=0, atol=1e-6)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    xyz, feats, cents, mask = case(100, 1, 64, 8, 2)
    args = [torch.from_numpy(a) for a in (xyz, feats, cents, mask)]
    before = knn_group.launches
    got = knn_group(*args, 8, True)
    assert knn_group.launches == before
    for a, b in zip(got, knn_group_reference(*args, 8, True)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        knn_group(*args, 0)
    with pytest.raises(ValueError):
        knn_group(torch.rand(1, 64, 4), *args[1:], 8)
    with pytest.raises(ValueError):
        knn_group(args[0], args[1], args[2], args[3][:, :10], 8)
