"""The port's ring Chamfer and ring Sinkhorn (pointcloud_tpu_torch/parallel/
ring.py) and their routing, on d = 2 and 3 CPU ranks over gloo, against the
JAX package's ring on a JAX mesh of the same size (tests/conftest.py forces
8 host devices; the mesh takes the first d) and against the one-device
`chamfer_distance`, on the JAX ring tests' shapes (tests/test_sharding.py).

One spawn of d ranks a size runs every case (a module fixture); each rank
returns its results and the tests compare them in this process.

  * Chamfer: value within 1e-5 of the JAX ring's and of `chamfer_distance`'s,
    gradients with respect to x and y within 1e-5 (atol), with masks, with
    N and M that do not divide d, and x against itself; every rank's
    gradients bit-equal (each rank runs the same `chamfer_bwd` over the
    gathered indices).
  * Sinkhorn: the EMD rule of tests/test_torch_emd_slice.py against the JAX
    ring: 99.5% of rows with equal assignments, every other row's column
    within 1e-6 of its best score (`matching_difference`, scored by the
    plain version's potentials), dists within 1e-6 on the agreeing rows;
    every rank's outputs equal.
  * Routing: with RING_MIN_ELEMENTS patched low, `chamfer_distance` and
    `emd_match` on clouds every rank holds take the ring (counted) and give
    its values; without the patch, neither does. The route inside a
    data-parallel step is tests/test_torch_data_parallel.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from jax.sharding import Mesh
from torch_dist_utils import calls, ring_cases, routed_cases, run_ranks

from pointcloud_tpu.parallel import ring as jring
from pointcloud_tpu_torch.ops import chamfer, chamfer_distance, emd_match
from pointcloud_tpu_torch.ops.sinkhorn import (
    eps_schedule,
    matching_difference,
    sinkhorn_reference,
)

TOL = 1e-5
FLIP_SHARE = 0.995
FLIP_GAP = 1e-6
SIZES = (2, 3)


def _clouds():
    rng = np.random.default_rng(0)

    def r(*shape):
        return rng.random(shape, dtype=np.float32)

    x2, y2 = r(2, 128, 3), r(2, 128, 3)
    xm = np.ones((2, 128), bool)
    xm[0, ::2] = False
    ym = np.ones((2, 128), bool)
    ym[:, 40:] = False  # ragged: only the first 40 y are valid
    xn, yn = r(2, 101, 3), r(2, 67, 3)
    chamfer_cases = {
        "value": (r(2, 256, 3), r(2, 512, 3), None, None),
        "asymmetric": (r(1, 128, 3), r(1, 64, 3), None, None),
        "self": (r(1, 128, 3), None, None, None),
        "grads": (r(1, 64, 3), r(1, 64, 3), None, None),
        "masked": (x2, y2, xm, ym),
        "non-divisible": (xn, yn, None, None),
        "non-divisible-masked": (xn, yn, rng.random((2, 101)) > 0.3, None),
        "six-dims": (r(2, 50, 6), r(2, 70, 6), None, None),
    }
    sinkhorn_cases = {
        "constant": (r(2, 64, 3), r(2, 64, 3), 0.02, 40, None),
        "annealed": (r(1, 64, 3), r(1, 64, 3), 0.005, 30, 0.1),
        "non-divisible": (r(1, 61, 3), r(1, 43, 3), 0.02, 40, None),
        "train-point": (r(2, 128, 3), r(2, 128, 3), 0.005, 50, None),
    }
    route = (r(2, 40, 6), r(2, 50, 6), r(2, 40, 3))
    return chamfer_cases, sinkhorn_cases, route


CHAMFER, SINKHORN, ROUTE = _clouds()
ROUTE_EMD = (0.01, 30)


@pytest.fixture(scope="module", params=SIZES, ids=lambda d: f"d{d}")
def ranks(request):
    """Every rank's results of one spawn of d ranks: the ring cases, then
    the routed cases with the threshold low and at its default."""
    d = request.param
    x, y, y_emd = ROUTE
    return d, run_ranks(calls, d,
                        (ring_cases, (CHAMFER, SINKHORN)),
                        (routed_cases, (1, x, y, y_emd, *ROUTE_EMD)),
                        (routed_cases, (chamfer.RING_MIN_ELEMENTS, x, y, y_emd,
                                        *ROUTE_EMD)))


def jax_mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ("points",))


def jax_ring_chamfer(d, x, y, xm, ym):
    """The JAX ring's value and gradients with respect to x and y (y None:
    x against itself, one gradient)."""
    mesh = jax_mesh(d)
    kw = dict(mesh=mesh, x_mask=None if xm is None else jnp.asarray(xm),
              y_mask=None if ym is None else jnp.asarray(ym))
    # under jit: the eager shard_map's gradient takes ~15 s a case on the CPU
    if y is None:
        v, gx = jax.jit(jax.value_and_grad(lambda a: jring.ring_chamfer(a, a, **kw)))(
            jnp.asarray(x))
        return float(v), np.asarray(gx), None
    v, (gx, gy) = jax.jit(jax.value_and_grad(
        lambda a, b: jring.ring_chamfer(a, b, **kw), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(y))
    return float(v), np.asarray(gx), np.asarray(gy)


def port_chamfer(x, y, xm, ym):
    """The one-device chamfer_distance's value and gradients."""
    tx = torch.from_numpy(x).requires_grad_()
    ty = tx if y is None else torch.from_numpy(y).requires_grad_()
    v = chamfer_distance(tx, ty, x_mask=None if xm is None else torch.from_numpy(xm),
                         y_mask=None if ym is None else torch.from_numpy(ym))
    v.backward()
    return float(v.detach()), tx.grad.numpy(), None if y is None else ty.grad.numpy()


@pytest.mark.parametrize("case", list(CHAMFER))
def test_ring_chamfer_matches_jax_ring_and_one_device(ranks, case):
    d, results = ranks
    got = results[0][0][0][case]
    x, y, xm, ym = CHAMFER[case]
    for want in (jax_ring_chamfer(d, x, y, xm, ym), port_chamfer(x, y, xm, ym)):
        assert abs(got[0] - want[0]) <= TOL, (got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=TOL)
        if y is not None:
            np.testing.assert_allclose(got[2], want[2], atol=TOL)
    if y is None:
        assert got[0] <= 1e-6
    for other in results[1:]:
        for a, b in zip(got, other[0][0][case]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(SINKHORN))
def test_ring_sinkhorn_matches_jax_ring(ranks, case):
    d, results = ranks
    x, y, eps, iters, anneal = SINKHORN[case]
    dists, asn = results[0][0][1][case]
    assert dists.shape == asn.shape == x.shape[:2] and asn.dtype == np.int32
    assert (asn >= 0).all() and (asn < y.shape[1]).all()  # no pad column
    mesh = jax_mesh(d)
    jd, ja = jax.jit(lambda a, b: jring.ring_sinkhorn_match(
        a, b, eps=eps, iters=iters, anneal_from=anneal, mesh=mesh))(
        jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _, _, f, g = sinkhorn_reference(tx, ty, eps_schedule(eps, iters, anneal))
    same, gap, d_err = matching_difference(
        tx, ty, f, g, (torch.from_numpy(dists), torch.from_numpy(asn)),
        (torch.from_numpy(np.array(jd)), torch.from_numpy(np.array(ja))))
    assert same >= FLIP_SHARE and gap <= FLIP_GAP and d_err <= 1e-6, (same, gap, d_err)
    for other in results[1:]:
        np.testing.assert_array_equal(other[0][1][case][0], dists)
        np.testing.assert_array_equal(other[0][1][case][1], asn)


def test_routes_take_the_ring_above_the_threshold(ranks):
    d, results = ranks
    x, y, y_emd = ROUTE
    value, gx, gy, dists, asn, ran = results[0][1]
    assert ran == {"ring_chamfer": 1, "ring_sinkhorn_match": 1}
    want = port_chamfer(x, y, None, None)
    assert abs(value - want[0]) <= TOL
    np.testing.assert_allclose(gx, want[1], atol=TOL)
    np.testing.assert_allclose(gy, want[2], atol=TOL)
    tx, ty = torch.from_numpy(x[..., :3].copy()), torch.from_numpy(y_emd)
    wd, wa, f, g = sinkhorn_reference(tx, ty, eps_schedule(*ROUTE_EMD))
    same, gap, d_err = matching_difference(
        tx, ty, f, g, (torch.from_numpy(dists), torch.from_numpy(asn)), (wd, wa))
    assert same >= FLIP_SHARE and gap <= FLIP_GAP and d_err <= 1e-6, (same, gap, d_err)
    for other in results[1:]:
        for a, b in zip(results[0][1][:5], other[1][:5]):
            np.testing.assert_array_equal(a, b)


def test_routes_stay_on_one_device_below_the_threshold(ranks):
    _, results = ranks
    value, gx, gy, dists, asn, ran = results[0][2]
    assert ran == {"ring_chamfer": 0, "ring_sinkhorn_match": 0}
    x, y, y_emd = ROUTE
    want = port_chamfer(x, y, None, None)
    assert value == want[0]
    np.testing.assert_array_equal(gx, want[1])
    d, a = emd_match(torch.from_numpy(x[..., :3].copy()), torch.from_numpy(y_emd),
                     *ROUTE_EMD)
    np.testing.assert_array_equal(dists, d.numpy())
    np.testing.assert_array_equal(asn, a.numpy())


def test_ring_eligible_needs_a_group_and_the_size():
    """Size only under a group of more than one rank; never without one
    (this process has no group)."""
    from pointcloud_tpu_torch.ops.chamfer import RING_MIN_ELEMENTS, ring_eligible

    assert RING_MIN_ELEMENTS == 1 << 35
    assert not ring_eligible(64, 1 << 20, 1 << 20)
    assert not ring_eligible(1, 1024, 1024)


def test_ring_on_one_process_without_a_group():
    """No group: the ring runs on one rank, its value and gradients those
    of chamfer_distance, its matching that of the plain Sinkhorn."""
    from pointcloud_tpu_torch.parallel import ring_chamfer, ring_sinkhorn_match

    x, y, xm, ym = CHAMFER["masked"]
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    v = ring_chamfer(tx, ty, x_mask=torch.from_numpy(xm), y_mask=torch.from_numpy(ym))
    v.backward()
    want = port_chamfer(x, y, xm, ym)
    assert abs(float(v.detach()) - want[0]) <= TOL
    np.testing.assert_allclose(tx.grad.numpy(), want[1], atol=TOL)
    np.testing.assert_allclose(ty.grad.numpy(), want[2], atol=TOL)
    x, y, eps, iters, anneal = SINKHORN["annealed"]
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    wd, wa, f, g = sinkhorn_reference(tx, ty, eps_schedule(eps, iters, anneal))
    got = ring_sinkhorn_match(tx, ty, eps, iters, anneal)
    same, gap, d_err = matching_difference(tx, ty, f, g, got, (wd, wa))
    assert same >= FLIP_SHARE and gap <= FLIP_GAP and d_err <= 1e-6, (same, gap, d_err)
