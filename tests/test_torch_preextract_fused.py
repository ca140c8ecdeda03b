"""The port's residual chain (PointMLP's PreExtraction body: its plain
versions, which CPU tensors take) against pointcloud_tpu on the CPU: the XLA
oracle `preextract_pool_reference` and the Pallas kernels in interpret mode
(`preextract_pool_fused(..., interpret=True)`), B=2, on four layouts:
  blocks1: the JAX tests' [(10, 16), (16, 8), (8, 16)] (one block,
           expansion 0.5; tests/test_preextract_fused.py:34), pool 4;
  blocks2: [(10, 16)] + 4 x (16, 16) (two blocks: RES_BNRELU and a stored
           block output r_1 in the pool), pool 4;
  elite16: [(12, 64), (64, 16), (16, 64)] (PointMLP-Elite's mid width 16),
           a pool of 24 over 2 x 72 rows (144 rows: a group straddles the
           kernels' 64-row tiles);
  blocks3: [(6, 8)] + 6 x (8, 8) (RES_DENSE inside the stack and in the
           backward), pool 4.

Tolerances as tests/test_torch_mlp_chain.py. fp32: pooled outputs 1e-5,
statistics 1e-5 relative, gradients 2e-4 (the JAX tests' own,
tests/test_preextract_fused.py:83-88). bf16: pooled 1e-2, statistics 5e-3
(:52-60). The explicit backward `preextract_pool_bwd_reference` repeats the
kernels' rounding points, so in bf16 it is held against `jax.grad` of the
interpret-mode kernels at 3e-2 of each tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.ops import preextract_fused as jpf
from pointcloud_tpu_torch.ops import preextract_fused as tpf

B = 2
LAYOUTS = {  # name: (layout, pool, rows a cloud)
    "blocks1": ([(10, 16), (16, 8), (8, 16)], 4, 48),
    "blocks2": ([(10, 16)] + [(16, 16)] * 4, 4, 48),
    "elite16": ([(12, 64), (64, 16), (16, 64)], 24, 72),
    "blocks3": ([(6, 8)] + [(8, 8)] * 6, 4, 24),
}


def inputs(seed, name, ties=False):
    """x, per-layer (w, scale, offset) as numpy fp32, pool and R. With
    `ties`, rows 2 and 3 of every group repeat row 1, so three rows tie in
    every channel of every layer and residual."""
    layout, pool, R = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, R, layout[0][0])).astype(np.float32)
    if ties:
        x4 = x.reshape(B, R // pool, pool, -1)
        x4[:, :, 2] = x4[:, :, 1]
        x4[:, :, 3] = x4[:, :, 1]
    ws = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for s in layout]
    gs = [rng.uniform(0.5, 1.5, s[1]).astype(np.float32) for s in layout]
    bs = [(0.1 * rng.standard_normal(s[1])).astype(np.float32) for s in layout]
    return (x, ws, gs, bs), pool, R


def jax_args(x, ws, gs, bs, dtype=jnp.float32):
    return (jnp.asarray(x).astype(dtype), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, gs)), tuple(map(jnp.asarray, bs)))


def torch_args(x, ws, gs, bs, dtype=torch.float32, grad=False):
    leaf = (lambda a: torch.from_numpy(a.copy()).requires_grad_(grad))
    return (torch.from_numpy(x.copy()).to(dtype).requires_grad_(grad),
            [leaf(w) for w in ws], [leaf(g) for g in gs], [leaf(b) for b in bs])


def jax_fn(impl, pool):
    if impl == "kernels":  # the Pallas kernels, interpret mode
        return lambda *a: jpf.preextract_pool_fused(*a, pool, True)
    return lambda *a: jpf.preextract_pool_reference(*a, pool)


def cotangent(seed, pool, R, C):
    return np.random.default_rng(seed).standard_normal((B, R // pool, C)).astype(
        np.float32)


def jax_grads(impl, args, pool, cw):
    """Gradients of sum(out * cw) w.r.t. x, ws, scales and offsets,
    flattened in that order."""
    fn = jax_fn(impl, pool)

    def loss(*a):
        return jnp.sum(fn(*a)[0].astype(jnp.float32) * cw)

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(g)]


def port_grads(targs, pool, cw):
    x, ws, gs, bs = targs
    out = tpf.preextract_pool_fused(x, ws, gs, bs, pool)[0].float()
    (out * torch.from_numpy(cw)).sum().backward()
    return [to_np(t.grad.float()) for t in (x, *ws, *gs, *bs)]


@pytest.mark.parametrize("impl", ["oracle", "kernels"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_forward_matches_jax(name, dtype, impl):
    data, pool, R = inputs(0, name)
    jout, jstats = jax_fn(impl, pool)(*jax_args(*data, dtype=getattr(jnp, dtype)))
    tout, tstats = tpf.preextract_pool_fused(
        *torch_args(*data, dtype=getattr(torch, dtype)), pool)
    C = LAYOUTS[name][0][-1][1]
    assert tout.dtype == getattr(torch, dtype) and tout.shape == (B, R // pool, C)
    tol, stol = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 5e-3)
    np.testing.assert_allclose(to_np(tout.float()), np.asarray(jout, np.float32),
                               rtol=tol, atol=tol)
    assert len(tstats) == len(jstats) == len(LAYOUTS[name][0])
    for (ss, sq), (jss, jsq) in zip(tstats, jstats):
        assert ss.dtype == torch.float32
        for got, want in ((ss, jss), (sq, jsq)):
            want = np.asarray(want)
            np.testing.assert_allclose(to_np(got), want, rtol=stol,
                                       atol=stol * np.abs(want).max())


@pytest.mark.parametrize("impl", ["oracle", "kernels"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_gradients_match_jax(name, impl):
    data, pool, R = inputs(1, name)
    cw = cotangent(2, pool, R, LAYOUTS[name][0][-1][1])
    got = port_grads(torch_args(*data, grad=True), pool, cw)
    want = jax_grads(impl, jax_args(*data), pool, cw)
    assert len(got) == len(want) == 1 + 3 * len(LAYOUTS[name][0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_explicit_backward_matches_the_jax_kernels(name, dtype):
    data, pool, R = inputs(3, name)
    cw = cotangent(4, pool, R, LAYOUTS[name][0][-1][1])
    want = jax_grads("kernels", jax_args(*data, dtype=getattr(jnp, dtype)), pool, cw)
    targs = torch_args(*data, dtype=getattr(torch, dtype))
    out, _ = tpf.preextract_pool_fused(*targs, pool)
    dout = torch.from_numpy(cw).to(out.dtype)  # the cotangent autograd would send
    dx, dws, dgs, dbs = tpf.preextract_pool_bwd_reference(*targs, pool, dout)
    assert dx.dtype == getattr(torch, dtype) and dws[0].dtype == torch.float32
    for g, w in zip((dx, *dws, *dgs, *dbs), want):
        g = to_np(g.float())
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
        else:
            assert np.abs(g - w).max() <= 3e-2 * np.abs(w).max()
    if dtype == "float32":  # and autograd through the port's plain forward
        auto = port_grads(torch_args(*data, grad=True), pool, cw)
        for g, w in zip((dx, *dws, *dgs, *dbs), auto):
            np.testing.assert_allclose(to_np(g), w, rtol=2e-4, atol=2e-4)


def compose_passes(x, ws, gs, bs, pool):
    """The residual chain's forward out of the pass wrappers with their
    residual arguments (blocks 2): layer 3 adds relu(BN0(h0)) and stores its
    input r_1, the pool adds r_1. Returns (out, maxv, amax, hsel)."""
    n = x.shape[0] * x.shape[1]
    h, ss, sq = tpf.mm_stats(x, ws[0])
    hs, scs = [h], [tpf.affine_scalars(ss, sq, gs[0], bs[0], n)]
    r1 = None
    for u in range(1, 5):
        if u == 3:
            h, ss, sq, r1 = tpf.bnact_mm_stats(hs[-1], scs[-1], ws[u],
                                               res=(hs[0], scs[0]), write_r=True)
        else:
            h, ss, sq = tpf.bnact_mm_stats(hs[-1], scs[-1], ws[u])
        hs.append(h)
        scs.append(tpf.affine_scalars(ss, sq, gs[u], bs[u], n))
    return tpf.bn_pool(hs[-1], scs[-1], None, pool, res=r1)


@pytest.mark.parametrize("impl", ["oracle", "kernels"])
def test_planted_ties_go_to_the_lowest_row(impl):
    """Rows 1, 2 and 3 of every group are equal, residuals included: the
    pool picks row 0 or row 1, never 2 or 3, and the pooled gradient (and
    the pooled skip share into the block's input) lands on the same rows as
    in the JAX package."""
    data, pool, R = inputs(5, "blocks2", ties=True)
    targs = torch_args(*data, grad=True)
    with torch.no_grad():
        out, _, amax, _ = compose_passes(*targs, pool)
        ref, _ = tpf.preextract_pool_reference(*targs, pool)
    assert torch.equal(out, ref)
    assert amax.dtype == torch.int32 and int(amax.max()) <= 1
    assert (amax == 1).any() and (amax == 0).any()
    cw = cotangent(6, pool, R, 16)
    got = port_grads(targs, pool, cw)
    want = jax_grads(impl, jax_args(*data), pool, cw)
    x4 = got[0].reshape(B, R // pool, pool, -1)
    assert np.abs(x4[:, :, 1] - x4[:, :, 2]).max() > 1e-3  # row 1 took the pool's share
    np.testing.assert_array_equal(x4[:, :, 2], x4[:, :, 3])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


def test_wrappers_take_the_plain_versions_on_the_cpu_and_check_shapes():
    data, pool, R = inputs(7, "blocks2")
    x, ws, gs, bs = torch_args(*data)
    counters = (tpf.mm_stats, tpf.bnact_mm_stats, tpf.bn_pool, tpf.chain_bwd_pass)
    before = [f.launches for f in counters]
    out, stats = tpf.preextract_pool_fused(x, ws, gs, bs, pool)
    ref, rstats = tpf.preextract_pool_reference(x, ws, gs, bs, pool)
    assert torch.equal(out, ref) and torch.equal(stats[3][1], rstats[3][1])
    assert before == [f.launches for f in counters]
    h, ss, sq = tpf.mm_stats(x, ws[0])
    sc = tpf.affine_scalars(ss, sq, gs[0], bs[0], B * R)
    h1, *_ = tpf.bnact_mm_stats(h, sc, ws[1])
    # write_r returns the layer's input a = relu(BN(h) + relu(BN0(h0)))
    *_, a = tpf.bnact_mm_stats(h, sc, ws[1], res=(h, sc), write_r=True)
    want = torch.relu(tpf._bn_pre(h, sc) + torch.relu(tpf._bn_pre(h, sc)))
    assert torch.equal(a, want)
    with pytest.raises(ValueError, match="1 \\+ 2 \\* blocks"):
        tpf.preextract_pool_fused(x, ws[:4], gs[:4], bs[:4], pool)
    with pytest.raises(ValueError, match="pool must divide"):
        tpf.preextract_pool_fused(x, ws, gs, bs, 5)
    with pytest.raises(ValueError, match="the residual must be"):
        tpf.bnact_mm_stats(h, sc, ws[1], res=h[:, :-1])
    with pytest.raises(ValueError, match="residual's scalars"):
        tpf.bn_pool(h, sc, None, pool, res=(h, sc[:, :-1]))
    uc = tpf.up_scalars(sc, gs[1], ss[:16], sq[:16], B * R)
    with pytest.raises(ValueError, match="dense dz below a BatchNorm"):
        tpf.chain_bwd_pass(h1, uc, ws[1], h, sc, res=h,
                           dosel=torch.zeros(B, R // pool, 16),
                           amax=torch.zeros(B, R // pool, 16, dtype=torch.int32),
                           pool=pool)
    with pytest.raises(ValueError, match="dosel and amax must be"):
        tpf.chain_bwd_pass(h1, uc, ws[1], h, sc, dz=h1, pool=pool,
                           skip_pool=(torch.zeros(B, R // pool, 8),
                                      torch.zeros(B, R // pool, 8, dtype=torch.int32)))
    with pytest.raises(ValueError, match="skip_dense must be"):
        tpf.chain_bwd_pass(h1, uc, ws[1], h, sc, dz=h1, skip_dense=h1[..., :3])
