"""The port's fused Dense-BN-ReLU-pool chain (its plain versions, which CPU
tensors take) against pointcloud_tpu on the CPU: the XLA oracle
`mlp_pool_reference` and the Pallas kernels in interpret mode
(`mlp_pool_fused(..., interpret=True)`), on the JAX tests' own layout
[(9, 16), (16, 16), (16, 24)], B=2, R=48, pool 4
(tests/test_preextract_fused.py:192-260).

Tolerances. fp32: pooled outputs 1e-5, statistics 1e-5 relative (XLA and
PyTorch's CPU matmuls sum in other orders), gradients 2e-4 (the JAX tests'
own, :257-260). bf16: pooled 1e-2, statistics 5e-3 (the JAX tests' own,
:214-219: one flipped rounding of an 8-bit h is 4e-3 of its size). The
explicit backward `mlp_pool_bwd_reference` repeats the kernels' rounding
points, so in bf16 it is held against `jax.grad` of the interpret-mode
kernels at 3e-2 of each tensor's largest entry: both round dh and dz to
bf16, and a rounding of h that flips between the packages moves a few
entries by a bf16 step of the largest summand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.ops import preextract_fused as jpf
from pointcloud_tpu_torch.ops import preextract_fused as tpf

LAYOUT = [(9, 16), (16, 16), (16, 24)]
B, R, POOL = 2, 48, 4


def inputs(seed, layout=LAYOUT, masked=True, ties=False):
    """x, per-layer (w, scale, offset) and pen as numpy fp32. With `ties`,
    rows 2 and 3 of every group repeat row 1, so three rows tie in every
    channel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, R, layout[0][0])).astype(np.float32)
    if ties:
        x4 = x.reshape(B, R // POOL, POOL, -1)
        x4[:, :, 2] = x4[:, :, 1]
        x4[:, :, 3] = x4[:, :, 1]
    ws = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for s in layout]
    gs = [rng.uniform(0.5, 1.5, s[1]).astype(np.float32) for s in layout]
    bs = [(0.1 * rng.standard_normal(s[1])).astype(np.float32) for s in layout]
    pen = (np.where(rng.random((B, R)) < 0.3, 1e9, 0.0).astype(np.float32)
           if masked else np.zeros((B, R), np.float32))
    return x, ws, gs, bs, pen


def jax_args(x, ws, gs, bs, pen, dtype=jnp.float32):
    return (jnp.asarray(x).astype(dtype), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, gs)), tuple(map(jnp.asarray, bs)),
            jnp.asarray(pen))


def torch_args(x, ws, gs, bs, pen, dtype=torch.float32, grad=False):
    leaf = (lambda a: torch.from_numpy(a.copy()).requires_grad_(grad))
    return (torch.from_numpy(x.copy()).to(dtype).requires_grad_(grad),
            [leaf(w) for w in ws], [leaf(g) for g in gs], [leaf(b) for b in bs],
            torch.from_numpy(pen))


def jax_fn(impl, final_relu=True):
    if impl == "kernels":  # the Pallas kernels, interpret mode
        return lambda x, ws, gs, bs, pen: jpf.mlp_pool_fused(
            x, ws, gs, bs, pen, POOL, True, final_relu)
    return lambda x, ws, gs, bs, pen: jpf.mlp_pool_reference(
        x, ws, gs, bs, pen, POOL, final_relu)


def weights(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_grads(impl, args, cw, final_relu=True):
    """Gradients of sum(out * cw) over the finite outputs w.r.t. x, ws,
    scales and offsets, flattened in that order."""
    fn = jax_fn(impl, final_relu)

    def loss(x, ws, gs, bs):
        out = fn(x, ws, gs, bs, args[4])[0].astype(jnp.float32)
        return jnp.sum(jnp.where(out > -1e8, out * cw, 0.0))

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*args[:4])
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(g)]


def port_grads(targs, cw, final_relu=True):
    x, ws, gs, bs, pen = targs
    out = tpf.mlp_pool_fused(x, ws, gs, bs, pen, POOL, final_relu)[0].float()
    torch.where(out > -1e8, out * torch.from_numpy(cw), 0.0).sum().backward()
    return [to_np(t.grad.float()) for t in (x, *ws, *gs, *bs)]


@pytest.mark.parametrize("impl", ["oracle", "kernels"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, masked, impl):
    data = inputs(0, masked=masked)
    jout, jstats = jax_fn(impl)(*jax_args(*data, dtype=getattr(jnp, dtype)))
    tout, tstats = tpf.mlp_pool_fused(*torch_args(*data, dtype=getattr(torch, dtype)),
                                      POOL)
    assert tout.dtype == getattr(torch, dtype) and tout.shape == (B, R // POOL, 24)
    tol, stol = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 5e-3)
    np.testing.assert_allclose(to_np(tout.float()), np.asarray(jout, np.float32),
                               rtol=tol, atol=tol)
    assert len(tstats) == len(LAYOUT)
    for (ss, sq), (jss, jsq) in zip(tstats, jstats):
        assert ss.dtype == torch.float32
        for got, want in ((ss, jss), (sq, jsq)):
            want = np.asarray(want)
            np.testing.assert_allclose(to_np(got), want, rtol=stol,
                                       atol=stol * np.abs(want).max())


def test_fully_masked_group_gives_the_sentinel_and_no_gradient():
    x, ws, gs, bs, _ = inputs(1, masked=False)
    pen = np.zeros((B, R), np.float32)
    pen[0, 0:POOL] = 1e9  # group 0 of cloud 0
    targs = torch_args(x, ws, gs, bs, pen, grad=True)
    out, _ = tpf.mlp_pool_fused(*targs, POOL)
    jout, _ = jax_fn("kernels")(*jax_args(x, ws, gs, bs, pen))
    assert (to_np(out)[0, 0] == -1e9).all() and (np.asarray(jout)[0, 0] == -1e9).all()
    assert np.isfinite(to_np(out)[0, 1:]).all() and (to_np(out)[0, 1:] >= 0).all()
    out[0, 0].sum().backward()  # a cotangent on the masked group alone
    for t in (targs[0], *targs[1], *targs[2], *targs[3]):
        assert (t.grad == 0).all()
    dx, dws, dgs, dbs = tpf.mlp_pool_bwd_reference(
        *torch_args(x, ws, gs, bs, pen), POOL,
        torch.nn.functional.pad(torch.ones(1, 1, 24), (0, 0, 0, R // POOL - 1, 0, 1)))
    assert all((t == 0).all() for t in (dx, *dws, *dgs, *dbs))


@pytest.mark.parametrize("impl", ["oracle", "kernels"])
def test_planted_ties_go_to_the_lowest_row(impl):
    """Rows 1, 2 and 3 of every group are equal: the pool picks row 0 or
    row 1, never 2 or 3, and the pooled gradient lands on the same rows as
    in the JAX package."""
    data = inputs(2, masked=False, ties=True)
    targs = torch_args(*data, grad=True)
    x, ws, gs, bs, pen = targs
    with torch.no_grad():
        n = B * R
        h, ss, sq = tpf.mm_stats(x, ws[0])
        for u in (1, 2):
            sc = tpf.affine_scalars(ss, sq, gs[u - 1], bs[u - 1], n)
            h, ss, sq = tpf.bnact_mm_stats(h, sc, ws[u])
        sc = tpf.affine_scalars(ss, sq, gs[2], bs[2], n)
        _, _, amax, _ = tpf.bn_pool(h, sc, pen, POOL)
    assert amax.dtype == torch.int32 and int(amax.max()) <= 1
    assert (amax == 1).any() and (amax == 0).any()
    cw = weights(3, (B, R // POOL, 24))
    got = port_grads(targs, cw)
    want = jax_grads(impl, jax_args(*data), cw)
    x4 = got[0].reshape(B, R // POOL, POOL, -1)
    assert np.abs(x4[:, :, 1] - x4[:, :, 2]).max() > 1e-3  # row 1 took the pool's share
    np.testing.assert_array_equal(x4[:, :, 2], x4[:, :, 3])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["oracle", "kernels"])
@pytest.mark.parametrize("final_relu", [True, False])
def test_gradients_match_jax(final_relu, impl):
    data = inputs(4)
    cw = weights(5, (B, R // POOL, 24))
    if not final_relu:
        out, _ = tpf.mlp_pool_fused(*torch_args(*data), POOL, final_relu=False)
        jout, _ = jax_fn(impl, False)(*jax_args(*data))
        assert ((to_np(out) < 0) & (to_np(out) > -1e8)).any()  # negative pooled values
        np.testing.assert_allclose(to_np(out), np.asarray(jout), rtol=1e-5, atol=1e-5)
    got = port_grads(torch_args(*data, grad=True), cw, final_relu)
    want = jax_grads(impl, jax_args(*data), cw, final_relu)
    assert len(got) == 1 + 3 * len(LAYOUT)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("final_relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_explicit_backward_matches_the_jax_kernels(dtype, final_relu):
    data = inputs(6)
    cw = weights(7, (B, R // POOL, 24))
    jargs = jax_args(*data, dtype=getattr(jnp, dtype))
    want = jax_grads("kernels", jargs, cw, final_relu)
    targs = torch_args(*data, dtype=getattr(torch, dtype))
    out, _ = tpf.mlp_pool_fused(*targs, POOL, final_relu)
    # the cotangent autograd would send: cw on the finite outputs, in dtype
    dout = torch.where(out.float() > -1e8, torch.from_numpy(cw), 0.0).to(out.dtype)
    dx, dws, dgs, dbs = tpf.mlp_pool_bwd_reference(*targs, POOL, dout, final_relu)
    assert dx.dtype == getattr(torch, dtype) and dws[0].dtype == torch.float32
    for g, w in zip((dx, *dws, *dgs, *dbs), want):
        g = to_np(g.float())
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
        else:
            assert np.abs(g - w).max() <= 3e-2 * np.abs(w).max()
    if dtype == "float32":  # and autograd through the port's plain forward
        auto = port_grads(torch_args(*data, grad=True), cw, final_relu)
        for g, w in zip((dx, *dws, *dgs, *dbs), auto):
            np.testing.assert_allclose(to_np(g), w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layers", [1, 2])
def test_short_chains(layers):
    layout = LAYOUT[:layers]
    data = inputs(8 + layers, layout=layout)
    C = layout[-1][1]
    jout, jstats = jax_fn("kernels")(*jax_args(*data))
    tout, tstats = tpf.mlp_pool_fused(*torch_args(*data), POOL)
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), rtol=1e-5, atol=1e-5)
    assert len(tstats) == layers
    np.testing.assert_allclose(to_np(tstats[-1][1]), np.asarray(jstats[-1][1]), rtol=1e-5)
    cw = weights(10, (B, R // POOL, C))
    got = port_grads(torch_args(*data, grad=True), cw)
    want = jax_grads("kernels", jax_args(*data), cw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
    targs = torch_args(*data)
    dout = torch.where(tout > -1e8, torch.from_numpy(cw), 0.0)
    dx, dws, dgs, dbs = tpf.mlp_pool_bwd_reference(*targs, POOL, dout)
    for g, w in zip((dx, *dws, *dgs, *dbs), want):
        np.testing.assert_allclose(to_np(g), w, rtol=2e-4, atol=2e-4)


def test_wrappers_take_the_plain_versions_on_the_cpu_and_check_shapes():
    x, ws, gs, bs, pen = torch_args(*inputs(11))
    before = (tpf.mm_stats.launches, tpf.bnact_mm_stats.launches,
              tpf.bn_pool.launches, tpf.chain_bwd_pass.launches)
    out, stats = tpf.mlp_pool_fused(x, ws, gs, bs, pen, POOL)
    ref, rstats = tpf.mlp_pool_reference(x, ws, gs, bs, pen, POOL)
    assert torch.equal(out, ref) and torch.equal(stats[1][0], rstats[1][0])
    assert before == (tpf.mm_stats.launches, tpf.bnact_mm_stats.launches,
                      tpf.bn_pool.launches, tpf.chain_bwd_pass.launches)
    with pytest.raises(ValueError, match="pool must divide"):
        tpf.mlp_pool_fused(x, ws, gs, bs, pen, 5)
    with pytest.raises(ValueError, match="do not chain"):
        tpf.mlp_pool_fused(x, ws[::-1], gs, bs, pen, POOL)
    with pytest.raises(ValueError, match="pen must be"):
        tpf.mlp_pool_fused(x, ws, gs, bs, pen[:, :-1], POOL)
    with pytest.raises(ValueError, match="either dz or dosel"):
        tpf.chain_bwd_pass(x @ ws[0], torch.zeros(4, 16), ws[0], x)
