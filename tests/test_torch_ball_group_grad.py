"""Gradients of the port's `ball_group` (on the CPU: the plain forward and
the `scatter_rows` backward) against `jax.grad` through the Pallas kernel
in interpret mode (`grouped_gather_ball(..., interpret=True)` and its
`custom_vjp`), for the loss sum(grouped * cw).

Tolerances: fp32 1e-6 (a point's gradient sums a few cotangent rows, in
another order). With bf16 features both packages scatter the bf16 cotangent
with fp32 sums and round the features' gradient once to bf16: one bf16 ulp
of the result; the xyz and centroid gradients stay fp32 sums of the bf16
cotangent, 1e-6. Inputs keep every squared distance more than 1e-5
(relative) away from r^2, as tests/test_torch_ball_group.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ball_group import MARGIN, case
from torch_port_utils import ball_margin as margin
from torch_port_utils import to_np

from pointcloud_tpu.ops.pallas_kernels import grouped_gather_ball
from pointcloud_tpu_torch.ops.ball_group import ball_group, ball_group_reference
from pointcloud_tpu_torch.ops.scatter_rows import scatter_rows

RADIUS = 0.35


def jax_grads(xyz, feats, cents, mask, k, cw, dtype):
    pen = jnp.where(jnp.asarray(mask)[..., None], 0.0, jnp.float32(1e9))

    def loss(xyz, feats, cents):
        g = grouped_gather_ball(xyz, feats, cents, pen, k, RADIUS, True)[0]
        return jnp.sum(g.astype(jnp.float32) * cw)

    return [np.asarray(a, np.float32) for a in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(xyz), jnp.asarray(feats).astype(dtype), jnp.asarray(cents))]


def port_grads(fn, xyz, feats, cents, mask, k, cw, dtype, need=(True, True, True)):
    leaves = [torch.from_numpy(a.copy()).to(d).requires_grad_(n) for a, d, n in zip(
        (xyz, feats, cents), (torch.float32, dtype, torch.float32), need)]
    g, idx, valid = fn(leaves[0], leaves[1], leaves[2], torch.from_numpy(mask),
                       k, RADIUS)
    assert not idx.requires_grad and not valid.requires_grad
    (g.float() * torch.from_numpy(cw)).sum().backward()
    return [None if t.grad is None else to_np(t.grad.float()) for t in leaves], leaves


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_the_tpu_kernels_vjp(dtype, masked, k):
    xyz, feats, cents, mask = case(40 + k, 2, 128, 16, 5, far=2)  # two empty balls
    if not masked:
        mask = np.ones_like(mask)
    assert margin(xyz, cents, RADIUS) > MARGIN
    cw = np.random.default_rng(k).standard_normal((2, 16, k, 8)).astype(np.float32)
    want = jax_grads(xyz, feats, cents, mask, k, cw, getattr(jnp, dtype))
    got, leaves = port_grads(ball_group, xyz, feats, cents, mask, k, cw,
                             getattr(torch, dtype))
    idx = ball_group_reference(*(torch.from_numpy(a) for a in (xyz, feats, cents,
                                                              mask)), k, RADIUS)[1]
    assert leaves[1].grad.dtype == getattr(torch, dtype)
    assert leaves[0].grad.dtype == torch.float32
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want[1]), 2.0 ** -126))) - 7)
        assert (np.abs(got[1] - want[1]) <= ulp).all()
        # the rounding point: fp32 sums of the bf16 cotangent, rounded once
        cwb = torch.from_numpy(cw).bfloat16()
        scat = scatter_rows(cwb.reshape(2, 16 * k, 8), idx.reshape(2, 16 * k), 128)
        np.testing.assert_array_equal(got[1], to_np(scat[..., 3:].bfloat16().float()))
    # points outside every ball (masked ones among them) get no gradient
    used = np.zeros((2, 128), bool)
    np.put_along_axis(used, to_np(idx).reshape(2, -1).astype(np.int64), True, axis=1)
    assert (got[1][~used] == 0).all() and (got[0][~used] == 0).all()


def test_plain_version_differentiates_through_its_gathers():
    """fp32: autograd through `ball_group_reference` gives the same
    gradients as the scatter backward."""
    xyz, feats, cents, mask = case(50, 2, 128, 16, 5, far=1)
    cw = np.random.default_rng(0).standard_normal((2, 16, 8, 8)).astype(np.float32)
    got, _ = port_grads(ball_group, xyz, feats, cents, mask, 8, cw, torch.float32)
    want, _ = port_grads(ball_group_reference, xyz, feats, cents, mask, 8, cw,
                         torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_only_the_needed_gradients_are_formed():
    """With a gradient needed for the features alone (the set-abstraction
    train path), xyz and the centroids get none; with none needed the
    output carries no graph. No kernel launches on the CPU."""
    xyz, feats, cents, mask = case(51, 2, 128, 16, 5)
    cw = np.random.default_rng(1).standard_normal((2, 16, 8, 8)).astype(np.float32)
    before = (ball_group.launches, scatter_rows.launches)
    got, _ = port_grads(ball_group, xyz, feats, cents, mask, 8, cw, torch.float32,
                        need=(False, True, False))
    full, _ = port_grads(ball_group, xyz, feats, cents, mask, 8, cw, torch.float32)
    assert got[0] is None and got[2] is None
    np.testing.assert_array_equal(got[1], full[1])
    g = ball_group(*(torch.from_numpy(a) for a in (xyz, feats, cents, mask)), 8, RADIUS)[0]
    assert not g.requires_grad
    assert (ball_group.launches, scatter_rows.launches) == before
