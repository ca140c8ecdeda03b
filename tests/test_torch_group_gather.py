"""The port's legacy grouping (`group_gather`, the ball mode of the TPU's
`_group_kernel`; its plain version, which CPU tensors take) against
pointcloud_tpu on the CPU: the Pallas kernel in interpret mode
(`grouped_gather(..., interpret=True)`, transposed from its (B, k, C, S)
layout) and `group_neighbors(impl="pallas", interpret=True)`, which reaches
it; `feats=None` against the XLA route (`ball_query` + `index_points`); the
gradient against `jax.vjp` of the interpret-mode kernel. Also the kNN mode
of that TPU kernel (the JAX package's `group_neighbors` at k % 8 != 0),
which the port computes with the `knn_group` kernel.

Tolerances: idx and valid equal, gathers bit-equal in fp32 (both sides test
membership on direct differences in the same order, and the TPU kernel's
one-hot products are exact in fp32). In bf16 the features stay bit-equal
and the port's xyz is an exact gather, where the TPU kernel carries xyz as
split-bf16 hi + lo (16 significant bits): within 2e-4 of it. The XLA route
uses the matmul expansion of the distance: its inputs keep every float64
squared distance more than 1e-5 (relative) away from r^2. Gradients: fp32
1e-5 relative (other summation orders of the segment-sum); bf16 rows are
rounded to bf16 before the sums on both sides, 1e-3 relative.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import ball_margin as margin
from torch_port_utils import to_np

from pointcloud_tpu.ops import geometry as jgeo
from pointcloud_tpu.ops.pallas_kernels import grouped_gather
from pointcloud_tpu_torch.ops import geometry as tgeo
from pointcloud_tpu_torch.ops.group_gather import group_gather, group_gather_reference

MARGIN = 1e-5  # fp32 round-off of either formula is ~1e-6 of r^2 here


def case(seed, B, N, S, F, far=0, masked=True):
    """Unit-cube clouds, centroids on every (N // S)-th point, the last
    `far` centroids moved far outside (their balls are empty), masks with
    ~1/3 of the points invalid."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((B, N, 3), dtype=np.float32)
    feats = rng.standard_normal((B, N, F)).astype(np.float32)
    cents = xyz[:, :: N // S][:, :S].copy()
    if far:
        cents[:, S - far:] += 5.0
    mask = rng.random((B, N)) > 0.33 if masked else None
    return xyz, feats, cents, mask


def pen_of(mask, B, N):
    if mask is None:
        return jnp.zeros((B, N, 1), jnp.float32)
    return jnp.where(jnp.asarray(mask)[..., None], 0.0, jnp.float32(1e9))


def tpu_kernel(xyz, feats, cents, mask, k, radius, dtype=jnp.float32):
    """grouped_gather in interpret mode, in group_neighbors' layout."""
    B, N, _ = xyz.shape
    gx, gf, i, v = grouped_gather(
        jnp.asarray(xyz), jnp.asarray(feats).astype(dtype), jnp.asarray(cents),
        pen_of(mask, B, N), k, radius, True)
    return (np.asarray(gx.transpose(0, 3, 1, 2)),
            np.asarray(gf.transpose(0, 3, 1, 2).astype(jnp.float32)),
            np.asarray(jnp.swapaxes(i, 1, 2)),
            np.asarray(jnp.swapaxes(v, 1, 2)) > 0.5)


def port(xyz, feats, cents, mask, k, radius, dtype=torch.float32, with_xyz=True):
    return group_gather(
        torch.from_numpy(xyz),
        None if feats is None else torch.from_numpy(feats).to(dtype),
        torch.from_numpy(cents), None if mask is None else torch.from_numpy(mask),
        k, radius, with_xyz)


# (k, radius, N, S, far): k not a multiple of 8, k above most balls' in-ball
# count (r = 0.15 holds ~14 of 200 points), empty balls, and S = 96 over
# N = 200, which the TPU kernel cuts into three 32-centroid tiles
CASES = [(4, 0.3, 128, 16, 2), (6, 0.2, 128, 16, 1), (8, 0.35, 128, 16, 2),
         (24, 0.15, 200, 96, 3)]


@pytest.mark.parametrize("k,radius,N,S,far", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_fp32_matches_the_tpu_kernel(k, radius, N, S, far, masked):
    xyz, feats, cents, mask = case(k + N, 2, N, S, 5, far, masked)
    gx, gf, idx, valid = port(xyz, feats, cents, mask, k, radius)
    tgx, tgf, tidx, tvalid = tpu_kernel(xyz, feats, cents, mask, k, radius)
    assert gx.shape == (2, S, k, 3) and gf.shape == (2, S, k, 5)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(to_np(idx), tidx)
    np.testing.assert_array_equal(to_np(valid), tvalid)
    np.testing.assert_array_equal(to_np(gx), tgx)
    np.testing.assert_array_equal(to_np(gf), tgf)
    i, v = to_np(idx), to_np(valid)
    # empty balls: every slot point 0, invalid; under-full balls repeat slot 0
    assert (i[:, S - far:] == 0).all() and not v[:, S - far:].any()
    if k == 24:  # balls of ~3 points: under-full
        assert (~v).any(axis=-1)[:, : S - far].all()
    assert (np.where(v, i, i[..., :1]) == i).all()
    if masked:
        assert mask[np.arange(2)[:, None, None], i][v].all()
    np.testing.assert_array_equal(
        to_np(gx), np.take_along_axis(xyz[:, None], i[..., None].astype(np.int64), 2))


@pytest.mark.parametrize("with_xyz", [False, True])
def test_group_neighbors_matches_the_tpu_route(with_xyz):
    """The port's group_neighbors(radius=) against the JAX package's
    through its legacy kernel, a fully masked cloud included (every ball
    empty: point 0, invalid)."""
    xyz, feats, cents, mask = case(30, 3, 128, 16, 1)
    mask[2] = False
    k, radius = 12, 0.3
    got = tgeo.group_neighbors(*(torch.from_numpy(a) for a in (xyz, feats, cents)),
                               k, radius=radius, mask=torch.from_numpy(mask),
                               with_xyz=with_xyz)
    want = jgeo.group_neighbors(*(jnp.asarray(a) for a in (xyz, feats, cents)), k,
                                radius=radius, mask=jnp.asarray(mask), impl="pallas",
                                interpret=True, with_xyz=with_xyz)
    assert (got[0] is None) == (want[0] is None) == (not with_xyz)
    for g, w in zip(got, want):
        if g is not None:
            np.testing.assert_array_equal(to_np(g), np.asarray(w))
    assert (to_np(got[2])[2] == 0).all() and not to_np(got[3])[2].any()


@pytest.mark.parametrize("k", [8, 24])
def test_bf16_features_exact_xyz_within_the_tpu_split(k):
    xyz, feats, cents, mask = case(10 + k, 2, 128, 16, 4, far=1)
    radius = 0.3
    gx, gf, idx, valid = port(xyz, feats, cents, mask, k, radius, torch.bfloat16)
    tgx, tgf, tidx, tvalid = tpu_kernel(xyz, feats, cents, mask, k, radius,
                                        jnp.bfloat16)
    assert gf.dtype == torch.bfloat16 and gx.dtype == torch.float32
    np.testing.assert_array_equal(to_np(idx), tidx)
    np.testing.assert_array_equal(to_np(valid), tvalid)
    np.testing.assert_array_equal(to_np(gf.float()), tgf)
    i = to_np(idx)[..., None].astype(np.int64)
    np.testing.assert_array_equal(to_np(gx), np.take_along_axis(xyz[:, None], i, 2))
    np.testing.assert_allclose(to_np(gx), tgx, rtol=0, atol=2e-4)
    bf = torch.from_numpy(feats).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(to_np(gf.float()),
                                  np.take_along_axis(bf[:, None], i, 2))


@pytest.mark.parametrize("masked", [False, True])
def test_without_features_matches_the_xla_route(masked):
    """F = 0: the port takes its kernel (plain version here); the JAX
    package, off the TPU and without features, its XLA ball_query."""
    xyz, _, cents, mask = case(40, 2, 160, 20, 0, far=1, masked=masked)
    k, radius = 16, 0.25
    assert margin(xyz, cents, radius) > MARGIN
    gx, gf, idx, valid = tgeo.group_neighbors(
        torch.from_numpy(xyz), None, torch.from_numpy(cents), k, radius=radius,
        mask=None if mask is None else torch.from_numpy(mask))
    jgx, jgf, jidx, jvalid = jgeo.group_neighbors(
        jnp.asarray(xyz), None, jnp.asarray(cents), k, radius=radius,
        mask=None if mask is None else jnp.asarray(mask))
    assert gf is None and jgf is None
    np.testing.assert_array_equal(to_np(idx), np.asarray(jidx))
    np.testing.assert_array_equal(to_np(valid), np.asarray(jvalid))
    np.testing.assert_array_equal(to_np(gx), np.asarray(jgx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_matches_jax_vjp(dtype):
    """Cotangents of the gathered xyz and features (padded slots and empty
    balls included) back onto the points, against jax.vjp of the
    interpret-mode kernel on the same cotangents; new_xyz gets none."""
    xyz, feats, cents, mask = case(50, 2, 128, 16, 6, far=1)
    k, radius = 12, 0.3
    rng = np.random.default_rng(51)
    cgx = rng.standard_normal((2, 16, k, 3)).astype(np.float32)
    cgf = rng.standard_normal((2, 16, k, 6)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(x, fe):
        gx, gf, _, _ = grouped_gather(x, fe, jnp.asarray(cents), pen_of(mask, 2, 128),
                                      k, radius, True)
        return gx, gf

    _, vjp = jax.vjp(f, jnp.asarray(xyz), jnp.asarray(feats).astype(jdt))
    jdx, jdf = vjp((jnp.asarray(cgx).transpose(0, 2, 3, 1),
                    jnp.asarray(cgf).astype(jdt).transpose(0, 2, 3, 1)))

    tx = torch.from_numpy(xyz).requires_grad_()
    tf = torch.from_numpy(feats).to(tdt).requires_grad_()
    tc = torch.from_numpy(cents).requires_grad_()
    gx, gf, _, _ = group_gather(tx, tf, tc, torch.from_numpy(mask), k, radius)
    torch.autograd.backward((gx, gf), (torch.from_numpy(cgx),
                                       torch.from_numpy(cgf).to(tdt)))
    assert tc.grad is None and tf.grad.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-3
    for got, want in ((tx.grad, jdx), (tf.grad, jdf)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(to_np(got.float()) - want).max() / np.abs(want).max()
        assert err <= tol, (dtype, err)
    # masked points fill no slot; point 0 fills the empty ball's
    unused = ~mask
    unused[:, 0] = False
    assert (to_np(tf.grad.float())[unused] == 0).all()
    assert (to_np(tf.grad.float())[:, 0] != 0).all()


def test_only_the_needed_gradients_are_formed(monkeypatch):
    """Features that need no gradient and no xyz output: nothing to scatter,
    so the backward calls no scatter_rows; xyz alone scatters 3 channels."""
    srmod = sys.modules["pointcloud_tpu_torch.ops.scatter_rows"]
    calls = []
    real = srmod.scatter_rows
    monkeypatch.setattr(srmod, "scatter_rows",
                        lambda g, *a, **kw: calls.append(g.shape) or real(g, *a, **kw))
    xyz, feats, cents, mask = case(60, 2, 64, 8, 4)
    tx = torch.from_numpy(xyz).requires_grad_()
    _, gf, _, _ = group_gather(tx, torch.from_numpy(feats), torch.from_numpy(cents),
                               None, 8, 0.4, with_xyz=False)
    gf.sum().backward()
    assert calls == [] and tx.grad is None
    gx, gf, _, _ = group_gather(tx, torch.from_numpy(feats), torch.from_numpy(cents),
                                None, 8, 0.4)
    gx.sum().backward()
    assert calls == [(2, 64, 3)]


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    xyz, feats, cents, mask = case(70, 2, 64, 8, 3)
    before = group_gather.launches
    got = port(xyz, feats, cents, mask, 8, 0.3)
    want = group_gather_reference(*(torch.from_numpy(a) for a in (xyz, feats, cents,
                                                                    mask)), 8, 0.3)
    assert group_gather.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        group_gather(torch.from_numpy(xyz), None, torch.from_numpy(cents), None, 0, 0.3)
    with pytest.raises(ValueError):
        group_gather(torch.from_numpy(xyz), None, torch.from_numpy(cents), None, 4, 0.0)
    with pytest.raises(ValueError):
        group_gather(torch.from_numpy(xyz), None, torch.from_numpy(cents[..., :2]),
                     None, 4, 0.3)


@pytest.mark.parametrize("k", [4, 6])
@pytest.mark.parametrize("under_full", [False, True])
def test_knn_mode_matches_the_legacy_kernel(k, under_full):
    """The TPU kernel's kNN mode (k % 8 != 0 sends the JAX package's
    group_neighbors there) against the port's group_neighbors(radius=None),
    which takes the knn_group kernel: idx, xyz and features equal. Under
    full: a cloud with fewer than k valid points, whose empty slots repeat
    slot 0."""
    xyz, feats, cents, mask = case(80 + k, 2, 96, 12, 5)
    if under_full:
        mask[1] = False
        mask[1, [3, 40, 77]] = True
    got = tgeo.group_neighbors(*(torch.from_numpy(a) for a in (xyz, feats, cents)),
                               k, mask=torch.from_numpy(mask))
    want = jgeo.group_neighbors(*(jnp.asarray(a) for a in (xyz, feats, cents)), k,
                                mask=jnp.asarray(mask), impl="pallas", interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    if under_full:
        i = to_np(got[2])[1]
        assert set(np.unique(i)) <= {3, 40, 77}
        assert (i[:, 3:] == i[:, :1]).all()
