"""The port's Chamfer backward on the CPU against the JAX package: the plain
versions of the segment-sum (`scatter_rows`) and of the fused backward
(`chamfer_bwd`) vs the TPU kernels in interpret mode and vs the XLA
composition, and the gradients of `nearest_neighbor_dists` and
`chamfer_distance` vs jax.vjp / jax.grad, at a shape on each side of the
JAX package's 6<<20 switch (the port takes the fused backward on both).

Tolerances:
  * segment-sums 2e-5 absolute and relative: the TPU kernel sums fp32 rows
    as HIGHEST-precision one-hot MXU products in its own order; the values
    are O(1) sums of up to a few dozen O(1) rows;
  * Chamfer backward 2e-6 absolute (tests/test_pallas.py's bound for the
    fused kernel against the composition): gradients are O(1e-2) and the two
    sides differ only in the order of fp32 additions;
  * Chamfer gradients 1e-6 absolute (tests/test_pallas.py's grad parity).
The CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.ops import chamfer as jch
from pointcloud_tpu.ops.pallas_kernels import chamfer_nn_bwd_pallas, scatter_rows_pallas
from pointcloud_tpu_torch.ops import chamfer as tch
from pointcloud_tpu_torch.ops import (
    chamfer_bwd,
    chamfer_bwd_reference,
    chamfer_distance,
    scatter_rows,
    scatter_rows_reference,
)

SEG_TOL = dict(atol=2e-5, rtol=2e-5)
BWD_TOL = dict(atol=2e-6, rtol=0)
GRAD_TOL = dict(atol=1e-6, rtol=0)


def segsum_case(seed, B=2, R=96, n=40, C=5, crowd=True):
    """Rows, indices and an init; with `crowd` a third of the rows of each
    cloud go to target 3 (many rows to one target) and target n-1 gets none."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, R, C)).astype(np.float32)
    idx = rng.integers(0, n - 1, (B, R)).astype(np.int32)
    if crowd:
        idx[:, ::3] = 3
    init = rng.standard_normal((B, n, C)).astype(np.float32)
    return g, idx, init


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("C", [1, 3, 6])
def test_scatter_rows_matches_pallas_kernel(with_init, C):
    g, idx, init = segsum_case(C, C=C)
    n = init.shape[1]
    want = np.asarray(scatter_rows_pallas(
        jnp.asarray(g), jnp.asarray(idx), n,
        init=jnp.asarray(init) if with_init else None, interpret=True))
    got = scatter_rows(torch.from_numpy(g), torch.from_numpy(idx), n,
                       init=torch.from_numpy(init) if with_init else None)
    assert got.shape == (2, n, C) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), want, **SEG_TOL)
    assert not with_init or (to_np(got)[:, n - 1] == init[:, n - 1]).all()


def test_scatter_rows_bf16_rows_accumulate_in_fp32():
    """bf16 g is widened exactly and summed in fp32: equal to the fp32 sum
    of the same (bf16-representable) values."""
    g, idx, init = segsum_case(7)
    gb = torch.from_numpy(g).bfloat16()
    got = scatter_rows(gb, torch.from_numpy(idx), 40, init=torch.from_numpy(init))
    want = scatter_rows_reference(gb.float(), torch.from_numpy(idx), 40,
                                  init=torch.from_numpy(init))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def nn_case(seed, C, masked, B=2, N=64, M=48):
    """Clouds, cotangents zeroed on masked rows, and the argmins of the
    JAX package's dense forward."""
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, C), dtype=np.float32)
    y = rng.random((B, M, C), dtype=np.float32)
    gx = rng.random((B, N), dtype=np.float32) - 0.5
    gy = rng.random((B, M), dtype=np.float32) - 0.5
    xw = np.ones((B, N), np.float32)
    yw = np.ones((B, M), np.float32)
    if masked:
        xw = (rng.random((B, N)) > 0.2).astype(np.float32)
        yw = (rng.random((B, M)) > 0.2).astype(np.float32)
    gx, gy = gx * xw, gy * yw
    _, ax, _, ay = jch._nn_forward(*(jnp.asarray(a) for a in (x, y, xw, yw)))
    return x, y, gx, gy, np.array(ax), np.array(ay)


@pytest.mark.parametrize("C", range(3, 9))
@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_bwd_matches_pallas_kernel_and_composition(C, masked):
    args = nn_case(C, C, masked)
    got = chamfer_bwd(*(torch.from_numpy(a) for a in args))
    jargs = [jnp.asarray(a) for a in args]
    kernel = chamfer_nn_bwd_pallas(*jargs, interpret=True)
    x, y, gx, gy, ax, ay = jargs
    tx = 2.0 * gx[..., None] * (x - jch._flat_gather(y, ax))
    ty = 2.0 * gy[..., None] * (y - jch._flat_gather(x, ay))
    composition = jch._combine_nn_grads(tx, ty, ax, ay, impl="xla")
    for g, k, c in zip(got, kernel, composition):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g), np.asarray(k), **BWD_TOL)
        np.testing.assert_allclose(to_np(g), np.asarray(c), **BWD_TOL)


def test_chamfer_bwd_many_rows_to_one_target():
    """Every y point's nearest x point is x point 0 (it sits at the centre of
    y's cluster): one bucket holds all M rows."""
    rng = np.random.default_rng(3)
    x = rng.random((1, 32, 3), dtype=np.float32) + 5.0
    y = 0.01 * rng.random((1, 40, 3), dtype=np.float32)
    x[0, 0] = 0.005
    gx = rng.random((1, 32), dtype=np.float32)
    gy = rng.random((1, 40), dtype=np.float32)
    _, ax, _, ay = jch._nn_forward(*(jnp.asarray(a) for a in (
        x, y, np.ones((1, 32), np.float32), np.ones((1, 40), np.float32))))
    assert (np.asarray(ay) == 0).all()
    args = (x, y, gx, gy, np.array(ax), np.array(ay))
    got = chamfer_bwd(*(torch.from_numpy(a) for a in args))
    want = chamfer_nn_bwd_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **BWD_TOL)


def jax_vjp(x, y, xm, ym, gx, gy):
    xw = jnp.asarray(xm.astype(np.float32))
    yw = jnp.asarray(ym.astype(np.float32))
    _, vjp = jax.vjp(lambda a, b: jch.nearest_neighbor_dists(a, b, xw, yw),
                     jnp.asarray(x), jnp.asarray(y))
    return vjp((jnp.asarray(gx), jnp.asarray(gy)))


@pytest.mark.parametrize("shape", ["small", "above_old_switch"])
@pytest.mark.parametrize("C", [3, 6, 8])
def test_nearest_neighbor_dists_grads_match_jax(monkeypatch, shape, C):
    """Every backward takes the fused kernel: at 2 x 64 x 48 and at 1 x 2560
    x 2560, whose N*M lies above the JAX package's 6<<20 switch (there the
    JAX package takes its gathers and segment-sums)."""
    calls = []
    monkeypatch.setattr(tch, "chamfer_bwd",
                        lambda *a: calls.append("fused") or chamfer_bwd(*a))
    B, N, M = (2, 64, 48) if shape == "small" else (1, 2560, 2560)
    assert (N * M > 6 << 20) == (shape == "above_old_switch")
    rng = np.random.default_rng(C)
    x = rng.random((B, N, C), dtype=np.float32)
    y = rng.random((B, M, C), dtype=np.float32)
    xm = rng.random((B, N)) > 0.2
    ym = rng.random((B, M)) > 0.2
    gx = rng.standard_normal((B, N)).astype(np.float32)
    gy = rng.standard_normal((B, M)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    mx, my = tch.nearest_neighbor_dists(tx, ty, torch.from_numpy(xm),
                                        torch.from_numpy(ym))
    torch.autograd.backward((mx, my), (torch.from_numpy(gx), torch.from_numpy(gy)))
    assert calls == ["fused"]
    want_x, want_y = jax_vjp(x, y, xm, ym, gx, gy)
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(want_x), **GRAD_TOL)
    np.testing.assert_allclose(to_np(ty.grad), np.asarray(want_y), **GRAD_TOL)
    # a masked point is no target and its own cotangent is zeroed
    assert (tx.grad[torch.from_numpy(~xm)] == 0).all()
    assert (ty.grad[torch.from_numpy(~ym)] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_distance_backward_matches_jax_grad(masked):
    rng = np.random.default_rng(11)
    x = rng.random((2, 80, 6), dtype=np.float32)
    y = rng.random((2, 72, 6), dtype=np.float32)
    xm = ym = None
    if masked:
        xm = rng.random((2, 80)) > 0.2
        ym = rng.random((2, 72)) > 0.2
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    loss = chamfer_distance(tx, ty, t(xm), t(ym))
    loss.backward()
    want_loss, (want_x, want_y) = jax.value_and_grad(
        lambda a, b: jch.chamfer_distance(a, b, j(xm), j(ym)), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(want_x), **GRAD_TOL)
    np.testing.assert_allclose(to_np(ty.grad), np.asarray(want_y), **GRAD_TOL)
    if masked:  # the masks get no gradient and masked points get zero
        assert (tx.grad[torch.from_numpy(~xm)] == 0).all()


def test_cpu_tensors_take_plain_versions_without_launch():
    g, idx, init = segsum_case(1)
    before = scatter_rows.launches
    scatter_rows(torch.from_numpy(g), torch.from_numpy(idx), 40)
    assert scatter_rows.launches == before
    args = [torch.from_numpy(a) for a in nn_case(1, 3, False)]
    before = chamfer_bwd.launches
    got = chamfer_bwd(*args)
    assert chamfer_bwd.launches == before
    for a, b in zip(got, chamfer_bwd_reference(*args)):
        assert torch.equal(a, b)


def test_rejects_bad_shapes():
    args = [torch.from_numpy(a) for a in nn_case(2, 3, False)]
    with pytest.raises(ValueError):
        chamfer_bwd(args[0], args[1], args[2][:, :5], *args[3:])
    with pytest.raises(ValueError):
        chamfer_bwd(args[0], args[1][..., :2], *args[2:])
    g, idx, init = (torch.from_numpy(a) for a in segsum_case(2))
    with pytest.raises(ValueError):
        scatter_rows(g, idx[:, :5], 40)
    with pytest.raises(ValueError):
        scatter_rows(g, idx, 40, init=init[:, :5])
