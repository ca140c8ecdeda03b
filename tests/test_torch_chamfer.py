"""The port's Chamfer distance (pointcloud_tpu_torch.ops.chamfer) against
pointcloud_tpu.ops.chamfer on the CPU, for every batch reduction and both
methods, masked and unmasked, within bench.py's 1e-5 Chamfer guard."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.ops import chamfer as jax_chamfer
from pointcloud_tpu_torch.ops import chamfer_distance, masked_chamfer
from pointcloud_tpu_torch.ops.chamfer import nearest_neighbor_dists

TOL = 1e-5  # the BASELINE Chamfer parity guard (bench.py)


def clouds(seed, masked, B=2, N=128, M=96, C=3):
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, C), dtype=np.float32)
    y = rng.random((B, M, C), dtype=np.float32)
    xm = ym = None
    if masked:
        xm = rng.random((B, N)) > 0.1
        ym = rng.random((B, M)) > 0.1
    return x, y, xm, ym


def both(x, y, xm, ym):
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    return (t(x), t(y), t(xm), t(ym)), (j(x), j(y), j(xm), j(ym))


CASES = [(r, m, masked) for r in ("mean", "sum", None)
         for m in ("matmul", "direct") for masked in (False, True)]


@pytest.mark.parametrize("reduction,method,masked", CASES)
def test_chamfer_distance_matches_jax(reduction, method, masked):
    x, y, xm, ym = clouds(1, masked, C=6)
    (tx, ty, txm, tym), (jx, jy, jxm, jym) = both(x, y, xm, ym)
    got = to_np(chamfer_distance(tx, ty, txm, tym, batch_reduction=reduction,
                                 method=method))
    want = np.asarray(jax_chamfer.chamfer_distance(
        jx, jy, jxm, jym, batch_reduction=reduction, method=method))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("method", ["matmul", "direct"])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_chamfer_matches_jax(method, masked):
    x, y, xm, ym = clouds(2, masked)
    (tx, ty, txm, tym), (jx, jy, jxm, jym) = both(x, y, xm, ym)
    got = masked_chamfer(tx, ty, txm, tym, method=method)
    want = jax_chamfer.masked_chamfer(jx, jy, jxm, jym, method=method)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=TOL, rtol=0)


def test_wide_clouds_take_dense_path():
    """C > 8 goes to the dense path on both sides."""
    x, y, xm, ym = clouds(3, True, C=9)
    (tx, ty, txm, tym), (jx, jy, jxm, jym) = both(x, y, xm, ym)
    got = float(chamfer_distance(tx, ty, txm, tym))
    want = float(jax_chamfer.chamfer_distance(jx, jy, jxm, jym))
    assert abs(got - want) <= TOL


def test_matches_exact_oracle():
    """bench.py's guard: within 1e-5 of the exact float64 Chamfer."""
    x, y, _, _ = clouds(4, False, N=512, M=512)
    got = float(chamfer_distance(torch.from_numpy(x), torch.from_numpy(y)))
    d = ((x[:, :, None].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    want = float((d.min(2).mean(1) + d.min(1).mean(1)).mean())
    assert abs(got - want) <= TOL


def test_requires_grad_gives_gradients():
    """nearest_neighbor_dists and chamfer_distance are differentiable: the
    gradient of each point is twice its offset to its nearest neighbour,
    scaled by the means (the JAX gradients are held in
    tests/test_torch_chamfer_bwd.py)."""
    x = torch.rand(1, 16, 3, requires_grad=True)
    y = torch.rand(1, 16, 3)
    mx, _ = nearest_neighbor_dists(x, y)
    mx.sum().backward()
    d = ((x.detach()[:, :, None] - y[:, None]) ** 2).sum(-1)
    near = y[0, d[0].argmin(dim=1)]
    torch.testing.assert_close(x.grad[0], 2 * (x.detach()[0] - near))
    x.grad = None
    chamfer_distance(x, y).backward()
    assert x.grad.shape == x.shape and torch.isfinite(x.grad).all()


def test_unknown_options_raise():
    x = torch.rand(1, 8, 3)
    with pytest.raises(ValueError):
        chamfer_distance(x, x, batch_reduction="max")
    with pytest.raises(ValueError):
        chamfer_distance(x, x, method="sparse")
