"""The chain backward pass's three plain stages and its launch plan, on the
CPU.

`chain_bwd_pass_reference` is the composition of `chain_dh_reference`,
`chain_da_reference` and `chain_dw_reference` (the stages of the card's
kernels: dh formed once, da with its epilogue, which also forms dw's operand
a_up, and dw). The composition must give the bits of the one-piece plain
pass it replaced, kept here frozen (`one_piece`): sparse and dense
cotangents, below a BatchNorm and at the input layer with and without dzd,
the three residual modes, both skip shares, fp32 and bf16, pools of 24 over
row counts that are no multiple of 64. Its agreement with the JAX package's
backward is held by tests/test_torch_mlp_chain.py and
tests/test_torch_preextract_fused.py, which walk the same function.

`bwd_plan` is held at every path's shapes (PointNet2's SA1-3, the MSG
group-all level, PointMLP's stages 1-4, PointMLP-Elite's, ragged input
widths): its tiles and split-K chunks cover every row and channel once, its
padded widths are multiples of 8 and its scratch shapes are as stated; and,
at small shapes, the products carried out tile by tile and chunk by chunk as
the plan says equal the plain stages.
"""

import numpy as np
import pytest
import torch

from pointcloud_tpu_torch.ops import preextract_fused as tpf
from pointcloud_tpu_torch.ops.preextract_fused import (
    RES_BNRELU,
    RES_DENSE,
    RES_NONE,
    bwd_plan,
    chain_bwd_pass_reference,
    chain_da_reference,
    chain_dh_reference,
    chain_dw_reference,
)


def one_piece(h_up, uc, w, a_in, sc_down=None, dz=None, dosel=None, amax=None,
              pool=1, need_dzd=True, res=None, skip_pool=None, skip_dense=None):
    """The plain backward pass as one function, frozen as it stood before
    its split into stages."""
    dt = h_up.dtype
    Cd, Cu = w.shape
    dzf = tpf._dense_dz(dosel, amax, pool) if dz is None else dz.float()
    dh = ((uc[0] * dzf - uc[1]) - uc[2] * (h_up.float() - uc[3])).to(dt).float()
    wf = w.to(dt).float()
    da = torch.matmul(dh, wf.t()) if need_dzd else None
    sd = se = dzd = None
    if sc_down is not None:
        hdf = a_in.float()
        pre = tpf._with_residual(tpf._bn_pre(a_in, sc_down), res)
        if skip_pool is not None:
            da = da + tpf._dense_dz(*skip_pool, pool)
        if skip_dense is not None:
            da = da + skip_dense.float()
        a_up = tpf._relu(pre).to(dt).float()
        dzd = torch.where(pre > 0, da, 0.0).to(dt)
        dzdf = dzd.float()
        sd = dzdf.sum(dim=(0, 1))
        se = (dzdf * ((hdf - sc_down[0]) * sc_down[3])).sum(dim=(0, 1))
    else:
        a_up = a_in.float()
        if need_dzd:
            dzd = da.to(dt)
    dw = torch.matmul(a_up.reshape(-1, Cd).t(), dh.reshape(-1, Cu))
    return dzd, sd, se, dw


def scalars(rng, n, C, rows):
    """(4, C) fp32 BatchNorm scalars of random sums over `rows` rows (some
    scales negative)."""
    ssum = torch.from_numpy(rng.standard_normal(C).astype(np.float32)) * rows * 0.1
    ssq = torch.from_numpy(rng.uniform(0.5, 2.0, C).astype(np.float32)) * rows
    gamma = torch.from_numpy(np.where(rng.random(C) < 0.2, -1.0, 1.0)
                             * rng.uniform(0.5, 1.5, C)).float()
    beta = torch.from_numpy(0.1 * rng.standard_normal(C)).float()
    return tpf.affine_scalars(ssum, ssq, gamma, beta, n), gamma


# (kind, residual mode, skip share, need_dzd)
CASES = {
    "sparse below a BatchNorm": ("sparse", RES_NONE, None, True),
    "sparse input layer": ("sparse", None, None, True),
    "sparse input layer without dx": ("sparse", None, None, False),
    "dense below a BatchNorm": ("dense", RES_NONE, None, True),
    "dense input layer": ("dense", None, None, True),
    "dense input layer without dx": ("dense", None, None, False),
    "RES_BNRELU with the pooled skip": ("dense", RES_BNRELU, "pool", True),
    "RES_DENSE with the dense skip": ("dense", RES_DENSE, "dense", True),
    "RES_BNRELU with the dense skip": ("dense", RES_BNRELU, "dense", True),
    "no residual with the pooled skip": ("dense", RES_NONE, "pool", True),
}


def pass_inputs(case, dtype, seed, B=2, R=72, Cd=16, Cu=24, pool=24):
    """Arguments of one backward pass (numpy-seeded), rows = B R = 144: no
    multiple of 64, each group of 24 rows straddling a 64-row tile. At the
    input layer Cd = 6 (a ragged width)."""
    kind, res_mode, skip, need_dzd = CASES[case]
    rng = np.random.default_rng(seed)
    input_layer = res_mode is None
    if input_layer:
        Cd = 6
    n = B * R

    def act(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    h_up, a_in = act(B, R, Cu), act(B, R, Cd)
    sc_up, gamma = scalars(rng, n, Cu, n)
    sd = torch.from_numpy(rng.standard_normal(Cu).astype(np.float32))
    se = torch.from_numpy(rng.standard_normal(Cu).astype(np.float32))
    uc = tpf.up_scalars(sc_up, gamma, sd, se, n)
    w = act(Cd, Cu)
    kw = dict(pool=pool, need_dzd=need_dzd)
    if kind == "sparse":
        kw["dosel"] = torch.from_numpy(
            rng.standard_normal((B, R // pool, Cu)).astype(np.float32))
        kw["amax"] = torch.from_numpy(
            rng.integers(0, pool, (B, R // pool, Cu)).astype(np.int32))
    else:
        kw["dz"] = act(B, R, Cu)
    sc_down = None
    if not input_layer:
        sc_down = scalars(rng, n, Cd, n)[0]
        if res_mode == RES_BNRELU:
            kw["res"] = (act(B, R, Cd), scalars(rng, n, Cd, n)[0])
        elif res_mode == RES_DENSE:
            kw["res"] = torch.relu(act(B, R, Cd))
        if skip == "pool":
            G = R // pool
            kw["skip_pool"] = (
                torch.from_numpy(rng.standard_normal((B, G, Cd)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, pool, (B, G, Cd)).astype(np.int32)))
        elif skip == "dense":
            kw["skip_dense"] = act(B, R, Cd)
    return (h_up, uc, w, a_in, sc_down), kw


def same(got, want):
    return (got is None and want is None) or (
        got is not None and want is not None and got.dtype == want.dtype
        and torch.equal(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_the_stages_compose_to_the_one_piece_pass_bit_for_bit(case, dtype):
    args, kw = pass_inputs(case, dtype, seed=len(case))
    got = chain_bwd_pass_reference(*args, **kw)
    want = one_piece(*args, **kw)
    assert all(same(g, w) for g, w in zip(got, want)), case
    # the wrapper takes the composition for CPU tensors
    assert all(same(g, w) for g, w in zip(tpf.chain_bwd_pass(*args, **kw), want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_stage_rounds_where_the_kernels_store(dtype):
    """dh and a_up come back in the activation dtype (the card stores both
    once), dzd too; a_up is relu(pre) below a BatchNorm and the input
    itself at the input layer; dw reads exactly those."""
    args, kw = pass_inputs("RES_BNRELU with the pooled skip", dtype, seed=3)
    h_up, uc, w, a_in, sc_down = args
    dh = chain_dh_reference(h_up, uc, kw["dz"])
    assert dh.dtype == dtype and dh.shape == h_up.shape
    dzd, sd, se, a_up = chain_da_reference(dh, w, a_in, sc_down, True, kw["res"],
                                           kw["skip_pool"], None, kw["pool"])
    assert dzd.dtype == a_up.dtype == dtype and sd.dtype == se.dtype == torch.float32
    pre = tpf._with_residual(tpf._bn_pre(a_in, sc_down), kw["res"])
    assert torch.equal(a_up, torch.where(pre > 0, pre, 0.0).to(dtype))
    assert not bool(((dzd != 0) & (pre <= 0)).any())
    x = pass_inputs("dense input layer", dtype, seed=4)[0][3]
    assert chain_da_reference(dh, torch.zeros(6, 24, dtype=dtype), x,
                              need_dzd=False)[3] is x
    dw = chain_dw_reference(a_up, dh)
    assert dw.dtype == torch.float32 and dw.shape == w.shape


# ---- the launch plan ----

# (path, rows, Cd, Cu, input layer): every pass of every path
SA = [(4_194_304, (6, 64, 64, 128)), (2_097_152, (131, 128, 128, 256)),
      (32_768, (259, 256, 512, 1024))]
PATHS = []
for _i, (_rows, _w) in enumerate(SA):
    PATHS += [(f"PointNet2 SA{_i + 1} layer {u}", _rows, _w[u], _w[u + 1], u == 0)
              for u in range(3)]
PATHS += [(f"MSG group-all layer {u}", 4096, c, d, u == 0)
          for u, (c, d) in enumerate([(643, 256), (256, 512), (512, 1024)])]
for _s, (_rows, _d, _c) in enumerate([(786_432, 131, 128), (393_216, 259, 256),
                                      (196_608, 515, 512), (98_304, 1027, 1024)]):
    PATHS += [(f"PointMLP S{_s + 1} transfer", _rows, _d, _c, True),
              (f"PointMLP S{_s + 1} block", _rows, _c, _c, False)]
for _s, (_rows, _d, _c) in enumerate([(786_432, 67, 64), (393_216, 131, 128),
                                      (196_608, 259, 256), (98_304, 515, 256)]):
    _mid = _c // 4  # res_expansion 0.25: mids 16, 32, 64, 64
    PATHS += [(f"Elite S{_s + 1} transfer", _rows, _d, _c, True),
              (f"Elite S{_s + 1} expand", _rows, _c, _mid, False),
              (f"Elite S{_s + 1} project", _rows, _mid, _c, False)]
PATHS += [("a small ragged pass", 144, 13, 130, False),
          ("a one-row pass", 1, 9, 16, True)]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("path", PATHS, ids=[p[0] for p in PATHS])
def test_the_plan_covers_every_row_and_channel(path, bf16):
    _, rows, cd, cu, input_layer = path
    p = bwd_plan(rows, cd, cu, bf16, input_layer)
    assert (p.rows, p.cd, p.cu, p.input_layer) == (rows, cd, cu, input_layer)
    # padded widths: multiples of 8, less than 8 past the true one (a_up:
    # bf16 only, for TMA)
    assert p.ldh % 8 == 0 and 0 <= p.ldh - cu < 8
    assert p.lda == (-(-cd // 8) * 8 if bf16 else cd)
    assert p.pad_x == (bf16 and input_layer and cd % 8 != 0)
    assert p.pad_w == (bf16 and cu % 8 != 0)
    # da: whole tiles a chunk (bf16: pairs, one a consumer), the chunks cover
    # every row once
    assert p.da_tile == (128 if bf16 else 64)
    assert p.da_chunk_rows % (2 * p.da_tile if bf16 else p.da_tile) == 0
    assert (p.da_chunks - 1) * p.da_chunk_rows < rows <= p.da_chunks * p.da_chunk_rows
    # dw: whole 64-row stages a chunk, the chunks cover every row once
    assert p.dw_chunk_rows % 64 == 0
    assert (p.dw_chunks - 1) * p.dw_chunk_rows < rows <= p.dw_chunks * p.dw_chunk_rows
    assert max(p.da_chunks, p.dw_chunks) <= 65535  # gridDim.y / gridDim.z
    # dw: tiles of 128 output x dw_cols input channels cover (cu, cd)
    assert p.dw_cols == (192 if bf16 and cd >= 512 else 128)
    if bf16:  # at most 4 waves of blocks on 132 SMs, one a chunk and tile
        for chunks, tiles in ((p.da_chunks, -(-cd // 128)),
                              (p.dw_chunks, -(-cd // p.dw_cols) * -(-cu // 128))):
            assert chunks == 1 or chunks * tiles <= 4 * 132
    sc = p.scratch()
    assert sc["dh"] == (rows, p.ldh)
    assert sc["a_up"] == (None if input_layer and not p.pad_x else (rows, p.lda))
    assert sc["part"] == (None if input_layer else (p.da_chunks, 2, cd))
    assert sc["dw_part"] == (p.dw_chunks, cd, cu)


def tiled_dw(p, a_up, dh):
    """dw carried out as the plan's launch does it: per split-K chunk and
    per tile of 128 x dw_cols of (Cu, Cd) (the bf16 grid; fp32 uses the
    same chunks), partials summed over the chunks in order."""
    a2 = a_up.float().reshape(p.rows, p.cd)
    d2 = dh.float().reshape(p.rows, p.cu)
    part = torch.full((p.dw_chunks, p.cd, p.cu), float("nan"))
    for c in range(p.dw_chunks):
        r = slice(c * p.dw_chunk_rows, min(p.rows, (c + 1) * p.dw_chunk_rows))
        for m0 in range(0, p.cu, 128):
            for n0 in range(0, p.cd, p.dw_cols):
                n1 = n0 + p.dw_cols
                part[c, n0:n1, m0:m0 + 128] = a2[r, n0:n1].t() @ d2[r, m0:m0 + 128]
    assert not bool(part.isnan().any())  # every entry written by one tile
    return part.sum(dim=0)


def tiled_da(p, dh, w):
    """da carried out as the plan's launch does it: per row chunk, per tile
    of da_tile rows and per 128 input channels."""
    d2 = dh.float().reshape(p.rows, p.cu)
    da = torch.full((p.rows, p.cd), float("nan"))
    for c in range(p.da_chunks):
        for t0 in range(c * p.da_chunk_rows, min(p.rows, (c + 1) * p.da_chunk_rows),
                        p.da_tile):
            r = slice(t0, min(p.rows, t0 + p.da_tile))
            for c0 in range(0, p.cd, 128):
                da[r, c0:c0 + 128] = d2[r] @ w.float()[c0:c0 + 128].t()
    assert not bool(da.isnan().any())  # every entry written by one tile
    return da


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("shape", [(5, 448, 131, 200), (3, 1000, 6, 64),
                                   (2, 400, 300, 16), (2, 300, 520, 40)])
def test_the_products_as_the_plan_tiles_them_equal_the_plain_stages(shape, bf16):
    """At small shapes with a plan for a card of 16 SMs (several chunks and
    tiles): da and dw tile by tile and chunk by chunk against the plain
    stages, 1e-5 relative (fp32 summation order only)."""
    B, R, cd, cu = shape
    rng = np.random.default_rng(sum(shape))
    dh = torch.from_numpy(rng.standard_normal((B, R, cu)).astype(np.float32))
    a_up = torch.from_numpy(rng.standard_normal((B, R, cd)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((cd, cu)).astype(np.float32))
    p = bwd_plan(B * R, cd, cu, bf16, False, sms=16)
    assert p.dw_chunks > 1 and p.da_chunks > 1
    want_dw = chain_dw_reference(a_up, dh)
    want_da = chain_da_reference(dh, w, a_up)[0].reshape(B * R, cd)
    for got, want in ((tiled_dw(p, a_up, dh), want_dw), (tiled_da(p, dh, w), want_da)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
