"""The port's fused Dense -> BN-statistics -> pool op
(pointcloud_tpu_torch.ops.dense_bn_pool) on the CPU against the JAX
package's `dense_pool_stats` run as tests/test_dense_bn_pool.py runs it: the
TPU kernel in interpret mode, its outputs and its custom VJP.

Tolerances: fp32 on both sides, differing only in the order of the fp32 sums
(the interpret-mode kernel accumulates per row tile; PyTorch's CPU matmul and
sums in their own order): 2e-5 on outputs and 3e-5 on gradients, the bounds
of tests/test_dense_bn_pool.py; the pooled indices are equal.
The CUDA kernels themselves are held against the plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.ops import dense_bn_pool as jdbp
from pointcloud_tpu_torch.ops import (
    dense_pool_stats,
    dense_pool_stats_bwd,
    dense_pool_stats_reference,
)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=3e-5, atol=3e-5)


def case(seed, B=2, R=64, Cin=8, C=16, masked=False):
    """Inputs with mixed per-channel signs (max- and min-pool channels) and,
    masked, +1e9 penalties on ~25% of the rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, R, Cin)).astype(np.float32)
    w = (rng.standard_normal((Cin, C)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    s = np.where(rng.random(C) > 0.5, 1.0, -1.0).astype(np.float32)
    pen = None
    if masked:
        pen = np.where(rng.random((B, R)) > 0.25, 0.0, 1e9).astype(np.float32)
    return x, w, b, s, pen


def as_torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def as_jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("pool", [8, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C", [16, 32])
def test_forward_matches_interpret_kernel(pool, masked, C):
    x, w, b, s, pen = case(C + pool, C=C, masked=masked)
    got = dense_pool_stats(*as_torch(x, w, b, s, pen), pool)
    want = jdbp.dense_pool_stats(*as_jax(x, w, b, s, pen), pool, True)
    assert got[0].shape == (2, 64 // pool, C) and got[1].dtype == torch.int32
    for name, g, r in zip(["psel", "asel", "ssum", "ssq"], got, want):
        if name == "asel":
            np.testing.assert_array_equal(to_np(g), np.asarray(r))
        else:
            np.testing.assert_allclose(to_np(g), np.asarray(r), err_msg=name,
                                       **FWD_TOL)


@pytest.mark.parametrize("pool", [8, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_vjp_matches_jax_grad(pool, masked):
    """Every differentiable output with its own weight, as
    tests/test_dense_bn_pool.py; grads to x, w and bias."""
    x, w, b, s, pen = case(pool, C=24, masked=masked)

    def scalar(psel, ssum, ssq, lib):
        return (lib.sum(psel * 1.3) + lib.sum(ssum * 0.11)
                + lib.sum(ssq * 0.05))

    js, jpen = jnp.asarray(s), None if pen is None else jnp.asarray(pen)

    def jloss(x_, w_, b_):
        psel, _, ssum, ssq = jdbp.dense_pool_stats(x_, w_, b_, js, jpen, pool, True)
        return scalar(psel, ssum, ssq, jnp)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*as_jax(x, w, b))
    tx, tw, tb = (t.requires_grad_() for t in as_torch(x, w, b))
    ts, tpen = as_torch(s, pen)
    psel, asel, ssum, ssq = dense_pool_stats(tx, tw, tb, ts, tpen, pool)
    assert not asel.requires_grad
    scalar(psel, ssum, ssq, torch).backward()
    for name, g, r in zip(["dx", "dw", "dbias"], (tx.grad, tw.grad, tb.grad), want):
        np.testing.assert_allclose(to_np(g), np.asarray(r), err_msg=name,
                                   **GRAD_TOL)


def test_lowest_index_wins_ties_and_gets_the_gradient():
    """Rows 3 and 5 of each 8-row block are equal, and the largest: the pool
    names row 3, and the pooled cotangent flows to row 3 alone."""
    x, w, b, s, _ = case(5, R=16, C=4)
    s[:] = 1.0
    x[:, [3, 5, 11, 13]] = 10.0 * np.abs(w).sum(0).max()
    w = np.abs(w)
    tx = torch.from_numpy(x).requires_grad_()
    psel, asel, _, _ = dense_pool_stats(tx, *as_torch(w, b, s, None), 8)
    assert (asel == 3).all()
    psel.sum().backward()
    assert (tx.grad[:, [3, 11]] != 0).any() and (tx.grad[:, [5, 13]] == 0).all()


def test_bf16_z_is_rounded_once():
    """z = bf16(fp32 accumulation + bias): psel equals the single rounding of
    the fp32 value and the sums are taken over those bf16 values."""
    x, w, b, s, _ = case(9, C=8)
    xb, wb, bb = (torch.from_numpy(a).bfloat16() for a in (x, w, b))
    psel, asel, ssum, ssq = dense_pool_stats(xb, wb, bb, torch.from_numpy(s), None, 64)
    z = (xb.float() @ wb.float() + bb.float()).bfloat16().float()
    assert psel.dtype == torch.bfloat16
    want = torch.max(z * torch.from_numpy(s), dim=1, keepdim=True).values
    assert torch.equal(psel.float(), want.bfloat16().float())
    assert torch.equal(ssum, z.sum(dim=(0, 1)))
    assert torch.equal(ssq, (z * z).sum(dim=(0, 1)))


def test_cpu_tensors_take_plain_version_without_launch():
    args = as_torch(*case(3))
    before = dense_pool_stats.launches
    got = dense_pool_stats(*args, 16)
    assert dense_pool_stats.launches == before
    for a, r in zip(got, dense_pool_stats_reference(*args, 16)):
        assert torch.equal(a, r)
    with pytest.raises(ValueError, match="CUDA kernel"):
        dense_pool_stats_bwd(*args[:4], got[1], got[0], got[2], got[3], 16)


def test_rejects_bad_inputs():
    x, w, b, s, pen = as_torch(*case(4, masked=True))
    with pytest.raises(ValueError, match="pool"):
        dense_pool_stats(x, w, b, s, pen, 48)  # 64 % 48 != 0
    with pytest.raises(ValueError):
        dense_pool_stats(x, w[:5], b, s, pen, 8)
    with pytest.raises(ValueError):
        dense_pool_stats(x, w, b, s, pen[:, :10], 8)
