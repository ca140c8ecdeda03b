"""The chain's forward passes layer by layer, and their launch plan, on the
CPU.

The port's `_chain_forward` with the plain passes (`mm_stats_reference`,
`bnact_mm_stats_reference`, `bn_pool_reference`: what CPU tensors take and
what the card's kernels are held to) against the tensors that the JAX
package's `_forward(..., interpret=True)` saves for its backward: every
layer's h, its statistics (ssum, ssq) and the stored block inputs r
(pointcloud_tpu/ops/preextract_fused.py:529, `saved`). The other CPU tests
compare only the pooled outputs and the gradients. Layouts: the plain chain
with a ragged input width (6, 131), a layer wider than 256 (a panel's N loop
takes several tiles on the card), an Elite-like 16-wide layer; the residual
chain with all three residual modes and write_r (three blocks), PointMLP-
Elite's mid width 16 under a ragged transfer width 131, two 264-wide blocks.

Tolerances: fp32 1e-5 (h relative to its largest entry, the statistics
relative); bf16 as tests/test_torch_mlp_chain.py: h and r 1e-2 (one
flipped rounding of a bf16 h is up to 4e-3 of its size, and a flip moves the
layers above it), statistics 5e-3.

`fwd_plan` is held at every driven path's shapes (PointNet2's SA1-3, the MSG
group-all level, PointMLP's and PointMLP-Elite's stages 1-4): its panels
and chunks cover every row once, its consumers' channel ranges every
channel once, and its shared memory stays within the card's 227 KB; and,
at small shapes, the column sums carried out panel by panel, tile by tile
and chunk by chunk in the kernel's fixed order equal the plain sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.ops import preextract_fused as jpf
from pointcloud_tpu_torch.ops import preextract_fused as tpf
from pointcloud_tpu_torch.ops.preextract_fused import fwd_plan

B = 2
# name: (layout, pool, rows a cloud, residual)
LAYOUTS = {
    "plain, input width 6": ([(6, 16), (16, 16), (16, 24)], 4, 48, False),
    "plain, input width 131, 264 wide, 16 wide":
        ([(131, 264), (264, 16), (16, 40)], 4, 48, False),
    "residual, three blocks": ([(6, 8)] + [(8, 8)] * 6, 4, 24, True),
    "residual, Elite-like": ([(131, 64), (64, 16), (16, 64)], 24, 72, True),
    "residual, 264 wide": ([(10, 264)] + [(264, 264)] * 4, 4, 24, True),
}


def inputs(seed, name):
    """x, per-layer (w, scale, offset) and pen (plain chain; ~30% of rows
    kept out of the pool) as numpy fp32."""
    layout, pool, R, residual = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, R, layout[0][0])).astype(np.float32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for s in layout]
    gs = [(np.where(rng.random(s[1]) < 0.2, -1.0, 1.0)
           * rng.uniform(0.5, 1.5, s[1])).astype(np.float32) for s in layout]
    bs = [(0.1 * rng.standard_normal(s[1])).astype(np.float32) for s in layout]
    pen = None if residual else np.where(rng.random((B, R)) < 0.3, 1e9, 0.0).astype(
        np.float32)
    return x, ws, gs, bs, pen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_each_layer_matches_the_jax_kernels(name, dtype):
    layout, pool, R, residual = LAYOUTS[name]
    x, ws, gs, bs, pen = inputs(len(name), name)
    (_, jstats), saved = jpf._forward(
        jnp.asarray(x).astype(getattr(jnp, dtype)), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, gs)), tuple(map(jnp.asarray, bs)), pool, True,
        residual=residual, pen=None if pen is None else jnp.asarray(pen))
    j_hs, j_rs = saved[4], saved[5]
    _, stats, (_, hs, _, rs, *_) = tpf._chain_forward(
        torch.from_numpy(x).to(getattr(torch, dtype)), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(g) for g in gs], [torch.from_numpy(b) for b in bs],
        None if pen is None else torch.from_numpy(pen), pool, True, tpf._PLAIN, residual)
    tol, stol = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 5e-3)
    assert len(hs) == len(j_hs) == len(stats) == len(jstats) == len(layout)
    # the stored block inputs: layers 3, 5, .. of the residual chain
    assert len(rs) == len(j_rs) == (max(0, (len(layout) - 1) // 2 - 1) if residual else 0)
    for u, (h, jh) in enumerate(zip(hs, j_hs)):
        want = np.asarray(jh.astype(jnp.float32)).reshape(B, R, -1)
        assert h.dtype == getattr(torch, dtype) and h.shape == want.shape, u
        scale = 1.0 if dtype == "bfloat16" else np.abs(want).max()
        np.testing.assert_allclose(to_np(h.float()), want, rtol=tol, atol=tol * scale,
                                   err_msg=f"h of layer {u}")
    for (ss, sq), (jss, jsq) in zip(stats, jstats):
        for got, want in ((ss, jss), (sq, jsq)):
            want = np.asarray(want)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(to_np(got), want, rtol=stol,
                                       atol=stol * np.abs(want).max())
    for r, jr in zip(rs, j_rs):
        want = np.asarray(jr.astype(jnp.float32)).reshape(B, R, -1)
        assert r.dtype == getattr(torch, dtype) and r.shape == want.shape
        assert (to_np(r.float()) >= 0).all()  # a ReLU's output
        np.testing.assert_allclose(to_np(r.float()), want, rtol=tol, atol=tol)


def test_write_r_returns_the_activated_input_the_product_reads():
    """The stored r of bnact_mm_stats (write_r) is the operand its product
    reads: bit for bit what mm_stats_reference multiplies, in each residual
    mode."""
    rng = np.random.default_rng(5)
    n, C = 96, 24

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            torch.bfloat16)

    def scalars():
        return tpf.affine_scalars(
            torch.from_numpy(rng.standard_normal(C).astype(np.float32)) * 9.6,
            torch.from_numpy(rng.uniform(0.5, 2.0, C).astype(np.float32)) * n,
            torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)),
            torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32)), n)

    h, w = t(2, 48, C), t(C, 16)
    for res in (None, (t(2, 48, C), scalars()), torch.relu(t(2, 48, C))):
        h_out, ss, sq, r = tpf.bnact_mm_stats(h, scalars(), w, res=res, write_r=True)
        want = tpf.mm_stats_reference(r, w)
        assert torch.equal(h_out, want[0]) and torch.equal(ss, want[1])
        assert r.dtype == torch.bfloat16 and bool((r >= 0).all())


# ---- the launch plan ----

# (path, rows, Cd, Cu, input layer): every forward product of every path
SA = [(4_194_304, (6, 64, 64, 128)), (2_097_152, (131, 128, 128, 256)),
      (32_768, (259, 256, 512, 1024))]
PATHS = []
for _i, (_rows, _w) in enumerate(SA):
    PATHS += [(f"PointNet2 SA{_i + 1} layer {u}", _rows, _w[u], _w[u + 1], u == 0)
              for u in range(3)]
PATHS += [(f"MSG group-all layer {u}", 4096, c, d, u == 0)
          for u, (c, d) in enumerate([(643, 256), (256, 512), (512, 1024)])]
# PointMLP's and Elite's PreExtraction inputs are a stage's grouped features
# beside their anchor's (2 C_prev wide)
for _s, (_rows, _d, _c) in enumerate([(786_432, 128, 128), (393_216, 256, 256),
                                      (196_608, 512, 512), (98_304, 1024, 1024)]):
    PATHS += [(f"PointMLP S{_s + 1} transfer", _rows, _d, _c, True),
              (f"PointMLP S{_s + 1} block", _rows, _c, _c, False)]
for _s, (_rows, _d, _c) in enumerate([(786_432, 64, 64), (393_216, 128, 128),
                                      (196_608, 256, 256), (98_304, 512, 256)]):
    _mid = _c // 4  # res_expansion 0.25: mids 16, 32, 64, 64
    PATHS += [(f"Elite S{_s + 1} transfer", _rows, _d, _c, True),
              (f"Elite S{_s + 1} expand", _rows, _c, _mid, False),
              (f"Elite S{_s + 1} project", _rows, _mid, _c, False)]


def consumer_columns(p):
    """The channels each consumer's products cover, tile by tile: a 128-row
    panel's halves both take all nt channels of a stage, a 64-row panel's
    consumers nt / 2 each. Returns [(tile, consumer, first, last + 1)]."""
    out = []
    for j in range(-(-p.cu // p.stage_cols)):
        for g in range(2):
            first = j * p.stage_cols + (0 if p.panel_rows == 128 else g * p.wn)
            out.append((j, g, first, first + p.wn))
    return out


@pytest.mark.parametrize("path", PATHS, ids=[p[0] for p in PATHS])
def test_the_plan_covers_every_row_and_channel_once(path):
    _, rows, cd, cu, input_layer = path
    p = fwd_plan(rows, cd, cu, True, input_layer)
    assert (p.rows, p.cd, p.cu, p.input_layer) == (rows, cd, cu, input_layer)
    # every driven width takes the TMA + wgmma kernel
    assert p.panel_rows in (64, 128) and p.wn in (64, 128)
    assert p.stage_cols == (p.wn if p.panel_rows == 128 else 2 * p.wn)
    assert 2 <= p.stages <= 4 and 1 <= p.slots <= 4
    assert p.stages >= 3 or p.panel_rows == 64
    # shared memory as the kernel lays it out, within the card's
    assert p.smem == tpf._fwd_smem(cd, cu, p.panel_rows, p.wn, p.stages, p.slots)
    assert p.smem <= 232_448
    panel = -(-cd // 64) * p.panel_rows * 128
    assert p.smem >= 1024 + p.slots * panel + p.stages * p.stage_cols * 128
    # rows: whole panels a chunk, the chunks cover every row once, at most
    # 4 waves of one block an SM
    assert p.chunk_rows % p.panel_rows == 0
    assert (p.chunks - 1) * p.chunk_rows < rows <= p.chunks * p.chunk_rows
    assert p.chunks == 1 or p.chunks <= 4 * 132
    # channels: each channel of cu in exactly one consumer's range of one
    # tile per row half (a 128-row panel's halves: once each)
    cover = np.zeros(-(-p.cu // p.stage_cols) * p.stage_cols, np.int32)
    for _, _, a, b in consumer_columns(p):
        cover[a:b] += 1
    assert (cover == (2 if p.panel_rows == 128 else 1)).all()
    assert (-(-p.cu // p.stage_cols) - 1) * p.stage_cols < cu <= -(-p.cu // p.stage_cols) * p.stage_cols


@pytest.mark.parametrize("cd,cu,input_layer", [(10, 130, True), (130, 40, False),
                                                (64, 130, False), (131, 128, True),
                                                (2048, 1024, True)])
def test_the_plan_leaves_other_widths_and_fp32_to_the_tile_kernel(cd, cu,
                                                                  input_layer):
    """cu (or cd below a BatchNorm) no multiple of 8 in bf16, a depth whose
    64-row panel does not fit beside the least ring, and fp32 at any width:
    the 64 x 128 tiles in chunks of whole 64-row tiles."""
    rows = 1000
    fits = tpf._fwd_smem(cd, cu, 64, 64, 2, 1) <= 232_448
    wgmma = cu % 8 == 0 and (input_layer or cd % 8 == 0) and fits
    assert bool(fwd_plan(rows, cd, cu, True, input_layer).panel_rows) == wgmma
    for bf16 in (False, True) if not wgmma else (False,):
        p = fwd_plan(rows, cd, cu, bf16, input_layer)
        assert p.panel_rows == p.wn == p.stages == p.slots == p.smem == 0
        assert p.chunk_rows % 64 == 0
        assert (p.chunks - 1) * p.chunk_rows < rows <= p.chunks * p.chunk_rows


def tiled_stats(p, h):
    """The column sums of h (rows, cu) fp32 as the launch forms them: per
    chunk, panel, N tile and consumer, each thread adds its two rows (r and
    r + 8 of its warp's 16), the warp adds its eight row pairs by a
    butterfly (lanes xor 4, 8, 16), the four warps are added in order into
    the consumer's running sums; a chunk's partial is consumer 0's sums plus
    consumer 1's, and the partials are summed as colsum_kernel does (32
    strided lanes in order, then the lanes in order)."""
    rows, cu = h.shape
    T = -(-p.cu // p.stage_cols) * p.stage_cols
    parts = torch.zeros((p.chunks, 2, cu))
    seen = torch.zeros((rows, cu), dtype=torch.int32)
    for c in range(p.chunks):
        cs = torch.zeros((2, 2, T))  # [consumer][sum, sq][channel]
        for r0 in range(c * p.chunk_rows, min(rows, (c + 1) * p.chunk_rows),
                        p.panel_rows):
            for j, g, a, b in consumer_columns(p):
                base = r0 + (64 * g if p.panel_rows == 128 else 0)
                tile = torch.zeros((64, b - a))  # rows past the end add 0
                n = max(0, min(64, rows - base))
                tile[:n, :max(0, min(b, cu) - a)] = h[base:base + n, a:min(b, cu)]
                seen[base:base + n, a:min(b, cu)] += 1
                for k, v in enumerate((tile, tile * tile)):
                    t = v.reshape(4, 2, 8, b - a)  # warp, row + 8, lane / 4
                    t = t[:, 0] + t[:, 1]
                    for m in (1, 2, 4):  # lanes xor 4, 8, 16
                        t = t + t[:, torch.arange(8) ^ m]
                    w = t[:, 0]
                    cs[g, k, a:b] += ((w[0] + w[1]) + w[2]) + w[3]
        parts[c] = (cs[0] + cs[1])[:, :cu]
    assert bool((seen == 1).all())  # every entry summed by one consumer once
    lanes = torch.stack([parts[i::32].sum(dim=0) if i < p.chunks
                         else torch.zeros((2, cu)) for i in range(32)])
    return lanes.sum(dim=0)


@pytest.mark.parametrize("shape", [(5, 448, 131, 200), (3, 1000, 6, 64),
                                   (2, 400, 300, 16), (2, 150, 1027, 264)])
def test_the_sums_as_the_plan_tiles_them_equal_the_plain_sums(shape):
    """At small shapes with a plan for a card of 3 SMs (several chunks, each
    several panels): the kernel's fixed-order column sums of the rounded h
    and h^2 against the plain version's, 1e-5 relative (fp32 order only)."""
    B, R, cd, cu = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal((B, R, cd)).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((cd, cu)) / np.sqrt(cd)).astype(
        np.float32)).to(torch.bfloat16)
    p = fwd_plan(B * R, cd, cu, True, True, sms=3)
    assert p.panel_rows and (p.chunks > 1 or p.chunk_rows > p.panel_rows)
    h, ss, sq = tpf.mm_stats_reference(x, w)
    got = tiled_stats(p, h.float().reshape(B * R, cu))
    for g, want in zip(got, (ss, sq)):
        assert float((g - want).abs().max()) <= 1e-5 * float(want.abs().max())
