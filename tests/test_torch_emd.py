"""The port's EMD matching (ops/sinkhorn.py, ops/emd.py) against the JAX
package on the CPU, on the same numpy inputs: `sinkhorn_reference` (the
kernel's plain version) and `emd.sinkhorn_match` (the XLA formulation)
against `pointcloud_tpu.ops.emd.sinkhorn_match` and the interpret-mode Pallas
kernel, `auction_match`, and `emd_match`'s gradient.

The matching is an argmax over scores f_i + g_j - C_ij, so it is
discontinuous: a row whose two best scores lie within the potentials'
round-off (~1e-8) may go to another target in another implementation. Each
Sinkhorn case therefore first asserts that its seed keeps every row's two
best scores MARGIN = 1e-6 apart (recomputed in float64 from the plain
version's potentials; measured 1.4e-5 or more on these seeds), then demands
equal assignments and dists within 1e-6 (the JAX package's own tolerance,
tests/test_pallas.py: the XLA path forms the cost by the matmul expansion, the
kernel and its plain version by direct differences). The auction compares
equal: both sides run the same rounded operations on the same stored cost.
Gradients: 1e-5 relative to the largest entry. `pytest -s` prints what the
Sinkhorn cases measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.ops import emd as jemd
from pointcloud_tpu.ops.pallas_kernels import sinkhorn_match_pallas
from pointcloud_tpu_torch.ops import (
    auction_match,
    emd_match,
    eps_schedule,
    sinkhorn,
    sinkhorn_match,
    sinkhorn_reference,
    top_two_gap,
)

MARGIN = 1e-6
DIST_TOL = 1e-6

# (seed, B, N, M, C, eps, iters, anneal_from)
SINKHORN_CASES = {
    "128x128-const": (0, 2, 128, 128, 3, 0.01, 30, None),
    "64x128-6dims": (0, 1, 64, 128, 6, 0.01, 20, None),
    "64x64-annealed": (0, 1, 64, 64, 3, 0.005, 40, 0.1),
    "100x77-eval-point": (0, 2, 100, 77, 3, 0.002, 60, 0.1),
    "128x128-train-point": (1, 2, 128, 128, 3, 0.005, 50, None),
    "64x64-one-iteration": (0, 1, 64, 64, 3, 0.005, 1, None),
}


def clouds(seed, B, N, M, C):
    rng = np.random.default_rng(seed)
    return (rng.random((B, N, C), dtype=np.float32),
            rng.random((B, M, C), dtype=np.float32))


@pytest.mark.parametrize("case", list(SINKHORN_CASES))
def test_sinkhorn_matches_jax(case):
    seed, B, N, M, C, eps, iters, anneal = SINKHORN_CASES[case]
    x, y = clouds(seed, B, N, M, C)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    d_ref, a_ref, f, g = sinkhorn_reference(
        tx, ty, eps_schedule(eps, iters, anneal))
    gap = float(top_two_gap(tx, ty, f, g).min())
    assert gap > MARGIN
    assert a_ref.dtype == torch.int32 and d_ref.dtype == torch.float32

    jd, ja = jemd.sinkhorn_match(jnp.asarray(x[..., :3]), jnp.asarray(y[..., :3]),
                                 eps, iters, anneal)
    np.testing.assert_array_equal(to_np(a_ref), np.asarray(ja))
    np.testing.assert_allclose(to_np(d_ref), np.asarray(jd), atol=DIST_TOL)
    print(f"measured: smallest top-two gap {gap:.2e}; dists vs JAX "
          f"{np.abs(to_np(d_ref) - np.asarray(jd)).max():.2e}")

    # the XLA formulation, on the dims the matching uses
    d_xla, a_xla = sinkhorn_match(tx[..., :3], ty[..., :3], eps, iters, anneal)
    np.testing.assert_array_equal(to_np(a_xla), np.asarray(ja))
    np.testing.assert_allclose(to_np(d_xla), np.asarray(jd), atol=DIST_TOL)

    if N % 64 == 0:  # the TPU kernel's own gate
        pd, pa = sinkhorn_match_pallas(jnp.asarray(x), jnp.asarray(y), eps=eps,
                                       iters=iters, anneal_from=anneal,
                                       interpret=True)
        np.testing.assert_array_equal(to_np(a_ref), np.asarray(pa))
        np.testing.assert_allclose(to_np(d_ref), np.asarray(pd), atol=DIST_TOL)


def test_sinkhorn_identical_clouds_give_the_identity():
    x = np.random.default_rng(3).random((1, 64, 3), dtype=np.float32)
    tx = torch.from_numpy(x)
    _, pa = sinkhorn_match_pallas(jnp.asarray(x), jnp.asarray(x), eps=0.002,
                                  iters=100, interpret=True)
    for d, a in (sinkhorn(tx, tx, 0.002, 100), sinkhorn_match(tx, tx, 0.002, 100)):
        np.testing.assert_array_equal(to_np(a)[0], np.arange(64))
        np.testing.assert_array_equal(to_np(a), np.asarray(pa))
        assert float(d.max()) <= 1e-6 and float(d.min()) >= 0.0


def test_eps_schedule_follows_the_jax_formula():
    const = eps_schedule(0.005, 50)
    assert const.dtype == torch.float32 and const.shape == (50,)
    assert bool((const == np.float32(0.005)).all())
    got = to_np(eps_schedule(0.002, 60, 0.1))
    frac = jnp.arange(60).astype(jnp.float32) / 59
    want = np.asarray(jnp.float32(0.1) * (0.002 / 0.1) ** frac)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == np.float32(0.1) and abs(got[-1] - 0.002) < 1e-9
    assert to_np(eps_schedule(0.002, 1, 0.1))[0] == np.float32(0.1)


def test_sinkhorn_wrapper_takes_the_plain_version_only_on_the_cpu():
    x, y = clouds(4, 2, 48, 40, 6)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    before = sinkhorn.launches
    got = sinkhorn(tx.requires_grad_(), ty, 0.01, 10, 0.05)
    want = sinkhorn_reference(tx, ty, eps_schedule(0.01, 10, 0.05))
    assert sinkhorn.launches == before  # no kernel on the CPU
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[0].requires_grad
    # dims 3: take no part
    x2 = x.copy()
    x2[..., 3:] += 1.0
    again = sinkhorn(torch.from_numpy(x2), ty, 0.01, 10, 0.05)
    assert torch.equal(again[1], want[1])
    with pytest.raises(ValueError, match="B, N, >=3"):
        sinkhorn(tx[..., :2], ty)
    with pytest.raises(ValueError, match="B, N, >=3"):
        sinkhorn(tx, ty[:1])
    with pytest.raises(TypeError):
        sinkhorn(tx.long(), ty)
    with pytest.raises(ValueError, match="iters"):
        sinkhorn(tx, ty, iters=-1)
    with pytest.raises(ValueError, match="devices"):
        sinkhorn(tx, ty.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sinkhorn(tx.to("meta"), ty.to("meta"))


# (seed, B, N, M, eps, iters)
AUCTION_CASES = {
    "64x64-converged": (0, 2, 64, 64, 0.005, 400),
    "48x64": (1, 2, 48, 64, 0.005, 100),
    "64x64-too-few-rounds": (2, 1, 64, 64, 0.005, 3),
    "128x128-train-point": (3, 1, 128, 128, 0.005, 50),
}


@pytest.mark.parametrize("case", list(AUCTION_CASES))
def test_auction_matches_jax(case):
    seed, B, N, M, eps, iters = AUCTION_CASES[case]
    x, y = clouds(seed, B, N, M, 3)
    d, a = auction_match(torch.from_numpy(x), torch.from_numpy(y), eps, iters)
    jd, ja = jemd.auction_match(jnp.asarray(x), jnp.asarray(y), eps, iters)
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(to_np(a), np.asarray(ja))
    np.testing.assert_allclose(to_np(d), np.asarray(jd), atol=DIST_TOL)
    if case == "64x64-converged":  # every point owns its own target
        assert all(len(set(row)) == N for row in to_np(a).tolist())
    if case == "64x64-too-few-rounds":  # some points fell back to the nearest
        cost = ((x[:, :, None] - y[:, None]) ** 2).sum(-1)
        assert any(len(set(row)) < N for row in to_np(a).tolist())
        fallback = to_np(a) == cost.argmin(2)
        assert fallback.any()


def test_auction_equal_bids_go_to_the_lowest_bidder():
    """Points 5 and 9 are the same point, so they bid the same for the same
    target in round one: the lower index wins it and the other is evicted to
    its next choice, in both packages."""
    x, y = clouds(5, 1, 32, 32, 3)
    x[0, 9] = x[0, 5]
    for iters in (1, 200):
        d, a = auction_match(torch.from_numpy(x), torch.from_numpy(y), 0.005, iters)
        jd, ja = jemd.auction_match(jnp.asarray(x), jnp.asarray(y), 0.005, iters)
        np.testing.assert_array_equal(to_np(a), np.asarray(ja))
        np.testing.assert_allclose(to_np(d), np.asarray(jd), atol=DIST_TOL)
    # after one round point 5 owns the shared best target; point 9, without
    # one, falls back to its nearest target, which is that same one
    cost = ((x[0, :, None] - y[0, None]) ** 2).sum(-1)
    d1, a1 = auction_match(torch.from_numpy(x), torch.from_numpy(y), 0.005, 1)
    assert int(a1[0, 5]) == int(a1[0, 9]) == int(cost[5].argmin())
    d200, a200 = auction_match(torch.from_numpy(x), torch.from_numpy(y), 0.005, 200)
    assert int(a200[0, 5]) != int(a200[0, 9])


@pytest.mark.parametrize("method", ["sinkhorn", "auction"])
def test_emd_match_gradient_goes_to_x_only(method):
    x, y = clouds(6, 2, 64, 64, 6)
    w = np.random.default_rng(7).standard_normal((2, 64)).astype(np.float32)
    if method == "sinkhorn":  # matched on xyz; the margin makes it unambiguous
        _, _, f, g = sinkhorn_reference(torch.from_numpy(x), torch.from_numpy(y),
                                        eps_schedule(0.01, 30))
        assert float(top_two_gap(torch.from_numpy(x), torch.from_numpy(y),
                                 f, g).min()) > MARGIN
    # the JAX XLA path matches on every dim it is given: hand both xyz clouds
    # for the matching and compare the gradient's formula on those
    x3, y3 = x[..., :3].copy(), y[..., :3].copy()

    def jloss(xx):
        d, _ = jemd.emd_match(xx, jnp.asarray(y3), 0.01, 30, method)
        return jnp.sum(d * w)

    jval, jdx = jax.value_and_grad(jloss)(jnp.asarray(x3))
    tx = torch.from_numpy(x3).requires_grad_()
    ty = torch.from_numpy(y3).requires_grad_()
    d, a = emd_match(tx, ty, 0.01, 30, method)
    assert not a.requires_grad and a.dtype == torch.int32
    (d * torch.from_numpy(w)).sum().backward()
    assert ty.grad is None
    np.testing.assert_allclose((d.detach() * torch.from_numpy(w)).sum().item(), float(jval),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(jdx),
                               atol=1e-5 * float(np.abs(jdx).max()))


def test_emd_match_gradient_covers_every_dim_of_x():
    """With 6-dim clouds the Sinkhorn backend matches on xyz and the
    gradient 2 g (x - y[assignment]) runs over all six dims."""
    x, y = clouds(8, 1, 32, 32, 6)
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y)
    d, a = emd_match(tx, ty, 0.01, 30)
    d.sum().backward()
    want = 2.0 * (x - np.take_along_axis(y, to_np(a)[..., None].astype(np.int64), 1))
    np.testing.assert_allclose(to_np(tx.grad), want, atol=1e-6)
