"""The fused Dense -> BatchNorm -> ReLU chain with a group max-pool, forward
and backward: CUDA kernels, plain versions, wrappers.

Port of pointcloud_tpu/ops/preextract_fused.py in both of its modes: the
plain chain with a masked pool (`mlp_pool_fused`, `mlp_pool_reference`: the
set-abstraction body) and the residual chain (`preextract_pool_fused`,
`preextract_pool_reference`: PointMLP's PreExtraction), through the Pallas
kernels `_mm_stats_kernel`, `_bnact_mm_stats_kernel`, `_bn_respool_kernel`
and `_bwd_pass_kernel`. The kernels are csrc/mlp_chain.cu; its note states
the design and the bound.

Each pass has a wrapper (`mm_stats`, `bnact_mm_stats`, `bn_pool`,
`chain_bwd_pass`) that launches its kernel for CUDA tensors and takes its
plain version (`*_reference`) only for CPU tensors, and a launch counter
(`<wrapper>.launches`). `mlp_pool_fused` and `preextract_pool_fused` chain
them: on CUDA tensors a `torch.autograd.Function` whose backward runs
`chain_bwd_pass` once per layer; on CPU tensors the plain chain,
differentiated by autograd. `mlp_pool_bwd_reference` and
`preextract_pool_bwd_reference` are the explicit backwards out of the plain
passes, with the kernels' rounding points.

A forward product pass is one launch on the card (and the fixed-order
column sum of its per-chunk partials): in bf16 a resident panel of
activated rows walked over every tile of w by TMA + wgmma, each input
element read and activated once; `fwd_plan` decides its panels, tiles, ring,
slots and chunks, and sends fp32 and the widths TMA cannot read to the
64 x 128 tile kernel. A backward pass is three stages on the card, as in its
plain version: dh formed once (`chain_dh_reference`), da with its epilogue,
which also forms dw's operand a_up (`chain_da_reference`), and dw
(`chain_dw_reference`). `bwd_plan` decides their tiles, chunks, padding and
scratch.

Scalars travel as (4, C) fp32 rows. For a BatchNorm (`affine_scalars`): mean,
mul = gamma * rsig, beta, rsig. For a backward pass (`up_scalars`): c1, c4,
c3, mean.

A residual (`res=`) joins a pre-activation of the same shape: (h0, sc0) adds
relu(BN0(h0)) (RES_BNRELU), a tensor r adds r itself (RES_DENSE); the layout
of the residual chain is `layer_res_cfg`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT, SMS, sm_count, split

EPS = 1e-5
_SENT = -1e9  # the pooled value of a group without a valid row
_TILE_ROWS = 64
_MAX_CHUNKS = 2048  # row chunks of a forward or fp32 da launch (gridDim.y)
_DW_BLOCKS = 528  # blocks an fp32 dw launch aims for (4 per SM)
_WG_TILE = 128  # rows and channels of a bf16 (wgmma) da or dw tile
_WG_DEPTH = 64  # rows of one dw stage: the split-K granule
_MAX_ROWS = 2**31 - 1
RES_NONE, RES_BNRELU, RES_DENSE = 0, 1, 2


def layer_res_cfg(u: int, L: int, residual: bool = True):
    """Residual structure of layer u's input a_in(u) = relu(pre_{u-1}) (the
    port's copy of pointcloud_tpu/ops/preextract_fused.py:_layer_res_cfg).

    Returns (res_mode, aux): aux is None, 'h0' (RES_BNRELU source) or a
    1-based index into the stored residuals (RES_DENSE). Layer layout: 0 =
    embed, odd = block expand, even > 0 = block project; block j's input is
    relu(BN0(h0)) for j = 1 and r_{j-1} for j > 1, with r_j =
    relu(BN(h_proj_j) + input of block j). residual=False (the plain chain):
    every layer's input is relu(BN(h_{u-1})).
    """
    del L  # the layout does not depend on the depth
    if residual and u % 2 == 1:
        j = (u + 1) // 2
        if j == 1:
            return RES_NONE, None
        if j == 2:
            return RES_BNRELU, "h0"
        return RES_DENSE, j - 2
    return RES_NONE, None


# ---------------------------------------------------------------------------
# scalars
# ---------------------------------------------------------------------------

def affine_scalars(ssum, ssq, gamma, beta, n: int):
    """(4, C) fp32 rows mean, mul = gamma * rsig, beta, rsig of a train-mode
    BatchNorm over n rows with column sums ssum and ssq (biased variance,
    clamped at 0)."""
    mean = ssum / n
    var = torch.clamp(ssq / n - mean * mean, min=0.0)
    rsig = torch.rsqrt(var + EPS)
    return torch.stack([mean, rsig * gamma.float(), beta.float(), rsig])


def up_scalars(sc, gamma, sd, se, n: int):
    """(4, C) fp32 rows c1, c4, c3, mean of a layer's backward pass: with
    sd = sum dz and se = sum dz * zhat over the layer's n rows,
    dh = c1 dz - c4 - c3 (h - mean) is the train-mode BatchNorm backward."""
    mean, _, _, rsig = sc
    c1 = gamma.float() * rsig
    return torch.stack([c1, c1 * sd / n, c1 * rsig * se / n, mean])


def _bn_pre(h, sc):
    return (h.float() - sc[0]) * sc[1] + sc[2]


def _relu(v):
    return torch.where(v > 0, v, 0.0)  # its gradient is exactly 1[v > 0]


def _with_residual(pre, res):
    """pre + relu(BN0(h0)) for res = (h0, sc0), pre + r for a tensor r, or
    pre itself for None; fp32."""
    if res is None:
        return pre
    if isinstance(res, tuple):
        return pre + _relu(_bn_pre(*res))
    return pre + res.float()


# ---------------------------------------------------------------------------
# plain versions of the four passes
# ---------------------------------------------------------------------------

def mm_stats_reference(x, w):
    """Plain version of `mm_stats`: fp32 accumulation rounded once to
    x.dtype, fp32 column sums of the rounded values over all rows."""
    h = torch.matmul(x.float(), w.to(x.dtype).float()).to(x.dtype)
    hf = h.float()
    return h, hf.sum(dim=(0, 1)), (hf * hf).sum(dim=(0, 1))


def bnact_mm_stats_reference(h_in, sc, w, res=None, write_r=False):
    """Plain version of `bnact_mm_stats`."""
    a = _relu(_with_residual(_bn_pre(h_in, sc), res)).to(h_in.dtype)
    out = mm_stats_reference(a, w)
    return (*out, a) if write_r else out


def bn_pool_reference(h, sc, pen, pool: int, final_relu: bool = True, res=None):
    """Plain version of `bn_pool`. The pool goes through argmax (first
    occurrence) and take_along_dim, so autograd sends each pooled gradient
    to one row."""
    B, R, C = h.shape
    hf = h.float()
    v = _with_residual(_bn_pre(h, sc), res)
    if pen is not None:
        v = v - pen[..., None]
    v = v.reshape(B, R // pool, pool, C)
    am = torch.argmax(v, dim=2, keepdim=True)
    mx = torch.take_along_dim(v, am, dim=2)[:, :, 0]
    hsel = torch.take_along_dim(hf.reshape(B, R // pool, pool, C), am, dim=2)[:, :, 0]
    out = _relu(mx) if final_relu else mx
    if pen is not None:
        out = torch.where(mx < 0.5 * _SENT, _SENT, out)
    return out.to(h.dtype), mx, am[:, :, 0].int(), hsel


def _dense_dz(dosel, amax, pool: int):
    """(B, G * pool, C) fp32 holding dosel at row amax of each group."""
    B, G, C = dosel.shape
    dz = torch.zeros((B, G, pool, C), dtype=torch.float32, device=dosel.device)
    dz.scatter_(2, amax.long()[:, :, None, :], dosel[:, :, None, :])
    return dz.reshape(B, G * pool, C)


def chain_dh_reference(h_up, uc, dz=None, dosel=None, amax=None, pool: int = 1):
    """Plain version of a backward pass's first stage: dh = dtype(c1 dz - c4 -
    c3 (h_up - mean)) (B, R, Cu), the layer's cotangent dz or, at the pooled
    layer, dosel at row amax of each group of `pool` rows."""
    dzf = _dense_dz(dosel, amax, pool) if dz is None else dz.float()
    return ((uc[0] * dzf - uc[1]) - uc[2] * (h_up.float() - uc[3])).to(h_up.dtype)


def chain_da_reference(dh, w, a_in, sc_down=None, need_dzd: bool = True, res=None,
                       skip_pool=None, skip_dense=None, pool: int = 1):
    """Plain version of the second stage, da = dh @ w^T in fp32 and its
    epilogue: below a BatchNorm the skip shares join da in fp32 (pool share
    first), dzd = dtype(da 1[pre > 0]), Sd and Se summed from the rounded
    dzd, and dw's operand a_up = dtype(relu(pre)); at the input dzd =
    dtype(da) (None without need_dzd) and a_up = a_in. Returns (dzd, sd, se,
    a_up)."""
    dt = dh.dtype
    da = torch.matmul(dh.float(), w.to(dt).float().t()) if need_dzd else None
    sd = se = dzd = None
    if sc_down is not None:
        hdf = a_in.float()
        pre = _with_residual(_bn_pre(a_in, sc_down), res)
        if skip_pool is not None:
            da = da + _dense_dz(*skip_pool, pool)
        if skip_dense is not None:
            da = da + skip_dense.float()
        a_up = _relu(pre).to(dt)
        dzd = torch.where(pre > 0, da, 0.0).to(dt)
        dzdf = dzd.float()
        sd = dzdf.sum(dim=(0, 1))
        se = (dzdf * ((hdf - sc_down[0]) * sc_down[3])).sum(dim=(0, 1))
    else:
        a_up = a_in
        if need_dzd:
            dzd = da.to(dt)
    return dzd, sd, se, a_up


def chain_dw_reference(a_up, dh):
    """Plain version of the third stage: dw = a_up^T @ dh (Cd, Cu), fp32
    accumulation over all rows."""
    return torch.matmul(a_up.float().reshape(-1, a_up.shape[-1]).t(),
                        dh.float().reshape(-1, dh.shape[-1]))


def chain_bwd_pass_reference(h_up, uc, w, a_in, sc_down=None, dz=None,
                             dosel=None, amax=None, pool: int = 1,
                             need_dzd: bool = True, res=None, skip_pool=None,
                             skip_dense=None):
    """Plain version of `chain_bwd_pass`, the composition of its three
    stages with their rounding points: dh and dzd rounded to the activation
    dtype, the skip shares added to da in fp32 (pool share first), Sd and Se
    summed from the rounded dzd, every product accumulated in fp32."""
    dh = chain_dh_reference(h_up, uc, dz, dosel, amax, pool)
    dzd, sd, se, a_up = chain_da_reference(dh, w, a_in, sc_down, need_dzd, res,
                                           skip_pool, skip_dense, pool)
    return dzd, sd, se, chain_dw_reference(a_up, dh)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _launchers():
    lib = _build.load("mlp_chain")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    mm = lib.mlp_mm_stats_launch
    mm.argtypes = [vp, vp, i32] + [vp] * 7 + [i64] + [i32] * 8 + [vp]
    pool = lib.mlp_bn_pool_launch
    pool.argtypes = [vp, vp, i32] + [vp] * 7 + [i64] + [i32] * 8 + [vp]
    dh = lib.mlp_bwd_dh_launch
    dh.argtypes = [vp] * 6 + [i64] + [i32] * 4 + [vp]
    da = lib.mlp_bwd_da_launch
    da.argtypes = [vp, i32, vp, i32, vp, vp, i32] + [vp] * 7 + [i32, vp, vp, i64] \
        + [i32] * 5 + [vp]
    dw = lib.mlp_bwd_dw_launch
    dw.argtypes = [vp, i32, vp, i32, vp, vp, i64] + [i32] * 5 + [vp]
    for fn in (mm, pool, dh, da, dw):
        fn.restype = ctypes.c_int
    return mm, pool, dh, da, dw


def _ptr(t):
    return None if t is None else t.data_ptr()


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def _chunk_rows(rows: int) -> int:
    """Rows a forward block owns: whole 64-row tiles, at most _MAX_CHUNKS
    chunks."""
    return max(_TILE_ROWS, _round_up(-(-rows // _MAX_CHUNKS), _TILE_ROWS))


class BwdPlan(NamedTuple):
    """Launch geometry and scratch of one backward pass (`bwd_plan`)."""
    rows: int
    cd: int
    cu: int
    input_layer: bool  # a_in is the chain's input (no BatchNorm below)
    ldh: int  # row stride of the dh scratch (rows, ldh): cu rounded up to 8
    lda: int  # row stride of a_up (rows, lda): bf16, cd rounded up to 8
    pad_x: bool  # bf16 input layer of a ragged width: dw reads a padded copy
    pad_w: bool  # bf16 with cu no multiple of 8: da reads w padded to ldh
    da_tile: int  # rows of a da tile
    da_chunk_rows: int  # rows a da block owns: whole tiles
    da_chunks: int
    dw_chunk_rows: int  # rows of a dw block's split-K chunk
    dw_chunks: int
    dw_cols: int  # input channels of a dw tile (bf16: 128, or 192 from cd 512)

    def scratch(self) -> dict:
        """Shapes of the pass's scratch: dh in the activation dtype; a_up in
        it below a BatchNorm, the padded input at a ragged bf16 input layer
        (None: dw reads the input itself); fp32 partials of Sd and Se
        (below a BatchNorm) and of dw."""
        a_up = (None if self.input_layer and not self.pad_x
                else (self.rows, self.lda))
        return {"dh": (self.rows, self.ldh), "a_up": a_up,
                "part": None if self.input_layer else (self.da_chunks, 2, self.cd),
                "dw_part": (self.dw_chunks, self.cd, self.cu)}


@functools.lru_cache(maxsize=256)
def bwd_plan(rows: int, cd: int, cu: int, bf16: bool, input_layer: bool,
             sms: int = SMS) -> BwdPlan:
    """The launch plan of one backward pass of rows x (cd -> cu).

    bf16 (TMA + wgmma): da blocks own chunks of pairs of 128-row tiles for
    128 input channels, dw blocks 128 of cu x 128 (192 from cd = 512) of cd
    over a split-K chunk of 64-row stages, each launch in whole waves;
    TMA reads rows of 16-byte strides, so dh and a_up rows are padded to 8
    channels, the input layer's x is copied padded when cd is ragged and w
    when cu is. fp32 (CUDA cores): 64-row da tiles in at most _MAX_CHUNKS
    chunks, dw chunks for about _DW_BLOCKS blocks; nothing padded but dh."""
    ldh, lda = _round_up(cu, 8), _round_up(cd, 8)
    if bf16:
        # the two consumers of a da block take its 128-row tiles in turn
        da_chunk, da_chunks = split(rows, 2 * _WG_TILE, -(-cd // _WG_TILE), sms)
        dw_cols = 192 if cd >= 512 else _WG_TILE
        dw_chunk, dw_chunks = split(
            rows, _WG_DEPTH, -(-cu // _WG_TILE) * -(-cd // dw_cols), sms)
        return BwdPlan(rows, cd, cu, input_layer, ldh, lda,
                       input_layer and cd % 8 != 0, cu % 8 != 0, _WG_TILE, da_chunk,
                       da_chunks, dw_chunk, dw_chunks, dw_cols)
    da_chunk = _chunk_rows(rows)
    tiles = -(-cd // 128) * -(-cu // 128)
    dw_chunk = max(_TILE_ROWS, _round_up(
        -(-rows // max(1, -(-_DW_BLOCKS // tiles))), _TILE_ROWS))
    return BwdPlan(rows, cd, cu, input_layer, ldh, cd, False, False, _TILE_ROWS,
                   da_chunk, -(-rows // da_chunk), dw_chunk, -(-rows // dw_chunk), 128)


def _device_of(name, *tensors):
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs lie on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {device}")
    return device


def _check_kernel(name, acts, f32s=(), i32s=()):
    """The kernels take contiguous tensors: activations and weights all fp32
    or all bf16, scalars and cotangents fp32, indices int32."""
    acts, f32s, i32s = ([t for t in ts if t is not None] for ts in (acts, f32s, i32s))
    dt = acts[0].dtype
    if dt not in (torch.float32, torch.bfloat16) or any(t.dtype != dt for t in acts):
        raise TypeError(f"{name} kernel takes activations and weights all fp32 "
                        f"or all bf16; got {[t.dtype for t in acts]}")
    if any(t.dtype != torch.float32 for t in f32s) \
            or any(t.dtype != torch.int32 for t in i32s):
        raise TypeError(f"{name} kernel takes fp32 scalars, penalties and "
                        f"cotangents and int32 indices")
    if not all(t.is_contiguous() for t in (*acts, *f32s, *i32s)):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    rows = acts[0].shape[0] * acts[0].shape[1]
    if not 1 <= rows <= _MAX_ROWS:
        raise ValueError(f"{name} kernel bounds exceeded: rows={rows}")


def _check_product(name, x, w, sc):
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[2] \
            or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"{name} takes x (B, R, Cd) and w (Cd, Cu); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if sc is not None and (sc.dim() != 2 or sc.shape[0] < 3
                           or sc.shape[1] != x.shape[2]):
        raise ValueError(f"{name} takes scalars (4, {x.shape[2]}); got "
                         f"{tuple(sc.shape)}")


def _res_parts(res):
    """(mode, source tensor, its scalars) of a residual argument."""
    if res is None:
        return RES_NONE, None, None
    if isinstance(res, tuple):
        return RES_BNRELU, res[0], res[1]
    return RES_DENSE, res, None


def _check_residual(name, res, like):
    """A residual joins the pre-activation of `like` (B, R, C): h0 or r of
    that shape, h0's scalars (>= 3, C)."""
    _, src, sc = _res_parts(res)
    if src is not None and src.shape != like.shape:
        raise ValueError(f"{name}: the residual must be {tuple(like.shape)}; got "
                         f"{tuple(src.shape)}")
    if sc is not None and (sc.dim() != 2 or sc.shape[0] < 3
                           or sc.shape[1] != like.shape[2]):
        raise ValueError(f"{name}: the residual's scalars must be (4, "
                         f"{like.shape[2]}); got {tuple(sc.shape)}")
    return src, sc


class FwdPlan(NamedTuple):
    """Launch geometry of one forward product pass (`fwd_plan`)."""
    rows: int
    cd: int
    cu: int
    input_layer: bool  # a_in is the chain's input (no BatchNorm below)
    panel_rows: int  # rows of a resident panel (128 or 64); 0: the tile kernel
    wn: int  # channels of one consumer's product (64 or 128)
    stage_cols: int  # channels of a w ring stage: wn, or 2 wn over 64-row panels
    stages: int  # w ring stages
    slots: int  # panels staged ahead
    chunk_rows: int  # rows a block owns: whole panels (tile kernel: 64-row tiles)
    chunks: int
    smem: int  # dynamic shared memory of a block, bytes


def _fwd_smem(cd: int, cu: int, pr: int, wn: int, stages: int, slots: int) -> int:
    """Shared memory of the TMA + wgmma forward (csrc/mlp_chain.cu FwdGeom):
    1024 bytes of alignment slack, `slots` panels of ceil(cd / 64) swizzled
    atoms of pr x 128 bytes, `stages` ring stages of 64 x nt bf16, the two
    consumers' 64 x wn bf16 h tiles, fp32 column sums ([consumer][sum,
    sq][ceil(cu / nt) nt] over 128-row panels, [sum, sq][..] over 64-row
    ones), the warps' tile sums [consumer][warp][sum, sq][wn] and 20
    mbarriers."""
    nt = wn if pr == 128 else 2 * wn
    tot = -(-cu // nt) * nt
    sums = (4 if pr == 128 else 2) * tot
    return (1024 + slots * -(-cd // 64) * pr * 128 + stages * nt // 64 * 8192
            + 2 * wn * 128 + 4 * (sums + 16 * wn) + 20 * 8)


@functools.lru_cache(maxsize=256)
def fwd_plan(rows: int, cd: int, cu: int, bf16: bool, input_layer: bool,
             sms: int = SMS) -> FwdPlan:
    """The launch plan of one forward product pass of rows x (cd -> cu).

    bf16 (TMA + wgmma): a block keeps a panel of activated input rows
    resident over all of cd and walks every N tile of cu over it, so each
    input element is read and activated once. The first of these that fits
    227 KB of shared memory: panels of 128 rows (a 64-row half for each
    consumer warpgroup) with wn = 128 channels a product (64 where cu is no
    wider), then wn = 64, each beside a ring of at least 3 w stages; then
    panels of 64 rows (the consumers split each stage's 2 wn channels) with
    wn = 128 (where cu is wider than 128), then 64, beside at least 2
    stages. Of that, a second panel slot where one fits (the next panel's
    TMA load then overlaps the products), then the most ring stages (up to
    4), then the most slots (up to 4); one block resident an SM, chunks of
    whole panels in whole waves (`split`). TMA reads w and writes h in 16-byte rows and the
    activated operand is formed in 16-byte chunks of channels, so cu (and cd
    below a BatchNorm) must be a multiple of 8: no driven path has another
    width, and the others (and fp32, which reaches the passes only in the
    card-vs-CPU checks; and a depth whose 64-row panel does not fit, cd past
    about 1,300, none on a driven path) take the 64 x 128 tiles of
    tile_mma.cuh, in at most _MAX_CHUNKS chunks of 64-row tiles."""
    if bf16 and cu % 8 == 0 and (input_layer or cd % 8 == 0):
        for pr, wide, least in ((128, 64, 3), (64, 128, 2)):
            for wn in ((128, 64) if cu > wide else (64,)):
                fits = [(min(slots, 2), stages, slots)
                        for stages in range(least, 5) for slots in range(1, 5)
                        if _fwd_smem(cd, cu, pr, wn, stages, slots) <= SMEM_LIMIT]
                if fits:
                    _, stages, slots = max(fits)
                    chunk, chunks = split(rows, pr, 1, sms)
                    return FwdPlan(rows, cd, cu, input_layer, pr, wn,
                                   wn if pr == 128 else 2 * wn, stages, slots, chunk,
                                   chunks, _fwd_smem(cd, cu, pr, wn, stages, slots))
    chunk = _chunk_rows(rows)
    return FwdPlan(rows, cd, cu, input_layer, 0, 0, 0, 0, 0, chunk, -(-rows // chunk), 0)


def _mm_stats_kernel(x, sc, w, res=None, write_r=False):
    B, R, Cd = x.shape
    Cu = w.shape[1]
    rows = B * R
    plan = fwd_plan(rows, Cd, Cu, x.dtype == torch.bfloat16, sc is None,
                    sm_count(x.device.index))
    mode, src, rsc = _res_parts(res)
    if plan.panel_rows:  # 16-byte loads, TMA: aligned operands
        x, sc, w, src, rsc = map(_aligned, (x, sc, w, src, rsc))
    h = torch.empty((B, R, Cu), dtype=x.dtype, device=x.device)
    r = torch.empty_like(x) if write_r else None
    stats = torch.empty((2, Cu), dtype=torch.float32, device=x.device)
    part = torch.empty((plan.chunks, 2, Cu), dtype=torch.float32, device=x.device)
    launch = _launchers()[0]
    with torch.cuda.device(x.device):
        err = launch(_ptr(x), _ptr(sc), mode, _ptr(src), _ptr(rsc), _ptr(w),
                     _ptr(h), _ptr(r), _ptr(stats), _ptr(part), rows, Cd, Cu,
                     plan.chunk_rows, plan.panel_rows, plan.wn, plan.stages,
                     plan.slots, int(x.dtype == torch.bfloat16),
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlp_chain product kernel launch failed: CUDA error {err}")
    return (h, stats[0], stats[1]) + ((r,) if write_r else ())


def mm_stats(x, w):
    """h = x.dtype(x @ w) with fp32 accumulation, and the fp32 column sums
    ssum, ssq of the rounded h and h^2 over all B * R rows.

    x (B, R, Cd) and w (Cd, Cu) in one dtype (fp32 or bf16 on the card).
    Returns (h (B, R, Cu), ssum (Cu,), ssq (Cu,)). CPU tensors take the plain
    version; CUDA tensors launch the kernel (`mm_stats.launches` counts);
    anything the kernel does not take raises."""
    _check_product("mm_stats", x, w, None)
    if _device_of("mm_stats", x, w).type == "cpu":
        return mm_stats_reference(x, w)
    _check_kernel("mm_stats", (x, w))
    out = _mm_stats_kernel(x, None, w)
    mm_stats.launches += 1
    return out


mm_stats.launches = 0


def bnact_mm_stats(h_in, sc, w, res=None, write_r=False):
    """a = dtype(relu((h_in - mean) * mul + beta [+ res])) from the scalars
    sc (4, Cd) of `affine_scalars`, then `mm_stats(a, w)`. `res` is None,
    (h0, sc0) (adds relu(BN0(h0)), h0 of h_in's shape) or a stored r of
    h_in's shape (adds r). `a` is stored only with write_r, and returned
    last: (h, ssum, ssq[, a]).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`bnact_mm_stats.launches` counts); anything else raises."""
    _check_product("bnact_mm_stats", h_in, w, sc)
    src, rsc = _check_residual("bnact_mm_stats", res, h_in)
    if _device_of("bnact_mm_stats", h_in, sc, w, src, rsc).type == "cpu":
        return bnact_mm_stats_reference(h_in, sc, w, res, write_r)
    _check_kernel("bnact_mm_stats", (h_in, w, src), (sc, rsc))
    out = _mm_stats_kernel(h_in, sc, w, res, write_r)
    bnact_mm_stats.launches += 1
    return out


bnact_mm_stats.launches = 0


class PoolPlan(NamedTuple):
    """The launch geometry of one `bn_pool` call (csrc/mlp_chain.cu
    bn_pool_kernel)."""
    vec: int  # channels a thread: 8 (16-byte loads of bf16, two of fp32) or 1
    strips: int  # threads a block along the channels, `vec` channels each
    slices: int  # threads a group's rows are split over: rows y, y + slices, ..
    rows: int  # rows a slice (the most)
    per_block: int  # groups a block
    threads: int  # threads a block: strips x slices x per_block
    blocks: tuple  # (blocks along the groups, blocks along the channels)


_POOL_THREADS = 256  # csrc/mlp_chain.cu kPoolThreads
_POOL_FLY = 4  # csrc/mlp_chain.cu kPoolFly: rows in flight a thread
# bytes all threads' rows in flight may add up to before a group's rows are
# split over more slices: measured on the card, SA3 (256 groups of 128 rows
# of 1,024 channels) is fastest at 2 slices, the MSG group-all level (32
# groups) at 8, and every larger pass at 1
_POOL_INFLIGHT = 4 << 20


@functools.lru_cache(maxsize=256)
def bn_pool_plan(groups: int, C: int, pool: int, dtype, res_mode: int = RES_NONE,
                 aligned: bool = True) -> PoolPlan:
    """The launch of `bn_pool` over `groups` groups of `pool` rows of C
    channels in `dtype` with residual mode `res_mode`; `aligned`: every
    tensor's base lies on a 16-byte boundary.

    A thread owns 8 channels (vec) where C is a multiple of 8 and the bases
    are aligned, else 1 (the narrow route). `strips` threads of a block lie
    along the channels (at most 32); a group's rows are split over `slices`
    threads, doubled from 1 while a slice keeps a row, the block 256
    threads or fewer, and all threads' rows in flight (4 a thread, h and the
    residual) stay under 4 MiB; the rest of the block's 256 threads take
    further groups (`per_block`). Raises ValueError for shapes no launch
    takes and TypeError for other dtypes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bn_pool kernel takes fp32 or bf16; got {dtype}")
    if not (groups >= 1 and C >= 1 and pool >= 1 and res_mode in (0, 1, 2)):
        raise ValueError(f"bn_pool kernel bounds exceeded: groups={groups} C={C} "
                         f"pool={pool} res_mode={res_mode}")
    vec = 8 if C % 8 == 0 and aligned else 1
    lanes = C // vec
    strips = min(lanes, 32)
    chunks = -(-lanes // strips)
    row_bytes = vec * (2 if dtype == torch.bfloat16 else 4) * (2 if res_mode else 1)
    slices = 1
    while (2 * slices <= pool and 2 * slices * strips <= _POOL_THREADS
           and groups * chunks * strips * slices * _POOL_FLY * row_bytes
           < _POOL_INFLIGHT):
        slices *= 2
    per_block = max(1, min(groups, _POOL_THREADS // (strips * slices)))
    return PoolPlan(vec, strips, slices, -(-pool // slices), per_block,
                    strips * slices * per_block, (-(-groups // per_block), chunks))


def bn_pool(h, sc, pen, pool: int, final_relu: bool = True, res=None):
    """The pool pass: v = (h - mean) * mul + beta [+ res] [- pen] in fp32,
    and per group of `pool` consecutive rows its max with the lowest row
    winning ties.

    h (B, R, C), sc (4, C) from `affine_scalars`, res as `bnact_mm_stats`'s
    (of h's shape), pen (B, R) fp32 (+1e9 on rows kept out of the pool) or
    None (no mask: the residual chain). Returns out (B, R/pool, C) in h.dtype
    (relu(max), or the max itself without final_relu; with pen, -1e9 for a
    group without a valid row), maxv fp32, amax int32 (row within the group)
    and hsel fp32 (h at that row). CPU tensors take the plain version; CUDA
    tensors launch the kernel (`bn_pool.launches` counts); anything else
    raises."""
    if h.dim() != 3 or sc.dim() != 2 or sc.shape[0] < 3 or sc.shape[1] != h.shape[2] \
            or (pen is not None and pen.shape != h.shape[:2]):
        raise ValueError(f"bn_pool takes h (B, R, C), sc (4, C) and pen (B, R) or "
                         f"None; got {tuple(h.shape)}, {tuple(sc.shape)}, "
                         f"{None if pen is None else tuple(pen.shape)}")
    B, R, C = h.shape
    if pool < 1 or R % pool:
        raise ValueError(f"pool must divide R = {R}; got {pool}")
    src, rsc = _check_residual("bn_pool", res, h)
    device = _device_of("bn_pool", h, sc, pen, src, rsc)
    if device.type == "cpu":
        return bn_pool_reference(h, sc, pen, pool, final_relu, res)
    _check_kernel("bn_pool", (h, src), (sc, pen, rsc))
    G = R // pool
    out = torch.empty((B, G, C), dtype=h.dtype, device=device)
    maxv = torch.empty((B, G, C), dtype=torch.float32, device=device)
    amax = torch.empty((B, G, C), dtype=torch.int32, device=device)
    hsel = torch.empty((B, G, C), dtype=torch.float32, device=device)
    mode = _res_parts(res)[0]
    plan = bn_pool_plan(B * G, C, pool, h.dtype, mode,
                        all(t.data_ptr() % 16 == 0 for t in (h, src) if t is not None))
    launch = _launchers()[1]
    with torch.cuda.device(device):
        err = launch(_ptr(h), _ptr(sc), mode, _ptr(src), _ptr(rsc), _ptr(pen),
                     _ptr(out), _ptr(maxv), _ptr(amax), _ptr(hsel), B * G, C,
                     pool, int(final_relu), int(h.dtype == torch.bfloat16), plan.vec,
                     plan.strips, plan.slices, plan.per_block,
                     torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_pool kernel launch failed: CUDA error {err}")
    bn_pool.launches += 1
    return out, maxv, amax, hsel


bn_pool.launches = 0


def _aligned(t):
    """t, or a copy of it where its data does not start on a 32-byte
    boundary (the backward's vector accesses and TMA maps need one)."""
    return t if t is None or t.data_ptr() % 32 == 0 else t.clone()


def _launch_bwd(stage, what, device, *args):
    with torch.cuda.device(device):
        err = _launchers()[stage](*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain_bwd_pass {what} kernel launch failed: CUDA "
                           f"error {err}")


def _bwd_dh(plan, h_up, uc, dz=None, dosel=None, amax=None, pool: int = 1):
    """The pass's dh stage on the card: dh (rows, plan.ldh) in h_up.dtype
    (`chain_dh_reference` in its first Cu channels, 0 in the pad)."""
    h_up, uc, dz, dosel, amax = map(_aligned, (h_up, uc, dz, dosel, amax))
    dh = torch.empty((plan.rows, plan.ldh), dtype=h_up.dtype, device=h_up.device)
    _launch_bwd(2, "dh", h_up.device, _ptr(h_up), _ptr(dz), _ptr(dosel), _ptr(amax),
                _ptr(uc), _ptr(dh), plan.rows, plan.cu, plan.ldh, pool,
                int(h_up.dtype == torch.bfloat16))
    return dh


def _bwd_da(plan, dh, w, a_in, sc_down=None, need_dzd: bool = True, res=None,
            skip_pool=None, skip_dense=None, pool: int = 1):
    """The pass's da stage on the card, from `_bwd_dh`'s dh: (dzd or None,
    sdse (2, Cd) fp32 or None, a_up) as `chain_da_reference`, a_up (rows,
    >= Cd) being dw's operand (its first Cd channels). At the input layer
    a_up is a_in itself or its padded copy, and without need_dzd nothing is
    launched."""
    device = a_in.device
    mode, src, rsc = _res_parts(res)
    skip_dosel, skip_amax = skip_pool if skip_pool is not None else (None, None)
    w, a_in, sc_down, src, rsc, skip_dosel, skip_amax, skip_dense = map(
        _aligned, (w, a_in, sc_down, src, rsc, skip_dosel, skip_amax, skip_dense))
    a_up = None
    if sc_down is None:
        a_up = a_in.reshape(plan.rows, plan.cd)
        if plan.pad_x:
            a_up = torch.zeros((plan.rows, plan.lda), dtype=a_in.dtype, device=device)
            a_up[:, :plan.cd] = a_in.reshape(plan.rows, plan.cd)
        if not need_dzd:
            return None, None, a_up
    if plan.pad_w:
        wp = torch.zeros((plan.cd, plan.ldh), dtype=w.dtype, device=device)
        wp[:, :plan.cu] = w
        w = wp
    dzd = torch.empty_like(a_in)
    sdse = part = None
    if sc_down is not None:
        a_up = torch.empty((plan.rows, plan.lda), dtype=a_in.dtype, device=device)
        sdse = torch.empty((2, plan.cd), dtype=torch.float32, device=device)
        part = torch.empty(plan.scratch()["part"], dtype=torch.float32, device=device)
    _launch_bwd(3, "da", device, _ptr(dh), dh.shape[1], _ptr(w), w.shape[1],
                _ptr(a_in), _ptr(sc_down), mode, _ptr(src), _ptr(rsc),
                _ptr(skip_dosel), _ptr(skip_amax), _ptr(skip_dense), _ptr(dzd),
                _ptr(a_up) if sc_down is not None else None, plan.lda, _ptr(sdse),
                _ptr(part), plan.rows, plan.cd, plan.cu, pool, plan.da_chunk_rows,
                int(a_in.dtype == torch.bfloat16))
    return dzd, sdse, a_up


def _bwd_dw(plan, dh, a_up):
    """The pass's dw stage on the card: dw (Cd, Cu) fp32 from `_bwd_dh`'s dh
    and `_bwd_da`'s a_up."""
    a_up = _aligned(a_up)
    device = dh.device
    dw = torch.empty((plan.cd, plan.cu), dtype=torch.float32, device=device)
    dw_part = torch.empty(plan.scratch()["dw_part"], dtype=torch.float32,
                          device=device)
    _launch_bwd(4, "dw", device, _ptr(dh), dh.shape[1], _ptr(a_up), a_up.shape[1],
                _ptr(dw), _ptr(dw_part), plan.rows, plan.cd, plan.cu,
                plan.dw_chunk_rows, plan.dw_cols, int(dh.dtype == torch.bfloat16))
    return dw


def chain_bwd_pass(h_up, uc, w, a_in, sc_down=None, dz=None, dosel=None,
                   amax=None, pool: int = 1, need_dzd: bool = True, res=None,
                   skip_pool=None, skip_dense=None):
    """One backward pass of the chain, for the layer h_up = a @ w.

    h_up (B, R, Cu): the layer's stored output; uc (4, Cu): `up_scalars`;
    w (Cd, Cu); a_in (B, R, Cd): the stored tensor below, h_{u-1} with its
    BatchNorm scalars sc_down (4, Cd), or the chain's input with sc_down
    None. The layer's cotangent is dz (B, R, Cu) or, at the pooled layer,
    dosel (B, R/pool, Cu) fp32 at row amax (int32) of each group of `pool`
    rows. With dh = dtype(c1 dz - c4 - c3 (h_up - mean)) and da = dh @ w^T:
      below a BatchNorm: pre = BN(h_{u-1}) [+ res] (res as
        `bnact_mm_stats`', of a_in's shape); da += the skip shares of a
        block's input, skip_pool = (dosel', amax') (B, R/pool, Cd) at those
        rows of each group, then skip_dense (B, R, Cd); dzd = dtype(da *
        1[pre > 0]) and the fp32 column sums sd = sum dzd, se = sum dzd *
        zhat of the layer below, and dw = dtype(relu(pre))^T @ dh. The
        residual and the skip shares come with a dense dz only;
      at the input: dzd = dtype(da), the gradient of a_in (None when
        need_dzd is False), sd = se = None, dw = a_in^T @ dh.
    Returns (dzd, sd, se, dw (Cd, Cu) fp32). CPU tensors take the plain
    version; CUDA tensors launch the three stage kernels (`_bwd_dh`,
    `_bwd_da`, `_bwd_dw`; `chain_bwd_pass.launches` counts one per pass);
    anything else raises."""
    _check_product("chain_bwd_pass", a_in, w, sc_down)
    B, R, Cd = a_in.shape
    Cu = w.shape[1]
    if h_up.shape != (B, R, Cu) or uc.shape != (4, Cu):
        raise ValueError(f"chain_bwd_pass takes h_up {(B, R, Cu)} and uc "
                         f"{(4, Cu)}; got {tuple(h_up.shape)}, {tuple(uc.shape)}")
    if (dz is None) == (dosel is None) or (dosel is None) != (amax is None):
        raise ValueError("chain_bwd_pass takes either dz or dosel with amax")
    if dz is not None and dz.shape != (B, R, Cu):
        raise ValueError(f"dz must be {(B, R, Cu)}; got {tuple(dz.shape)}")
    pooled = [(t, Cu) for t in (dosel, amax) if t is not None]
    if skip_pool is not None:
        pooled += [(t, Cd) for t in skip_pool]
    if pooled and (pool < 1 or R % pool or any(
            t.shape != (B, R // pool, c) for t, c in pooled)):
        raise ValueError(f"dosel and amax must be (B, R / pool, C) with pool "
                         f"dividing R = {R}; got pool {pool} and "
                         f"{[tuple(t.shape) for t, _ in pooled]}")
    if sc_down is not None and (sc_down.shape[0] != 4 or not need_dzd):
        raise ValueError("below a BatchNorm the pass takes sc_down (4, Cd) and "
                         "always forms dzd")
    joins = res is not None or skip_pool is not None or skip_dense is not None
    if joins and (sc_down is None or dz is None):
        raise ValueError("the residual and the skip shares join a pass with a "
                         "dense dz below a BatchNorm")
    if skip_dense is not None and skip_dense.shape != a_in.shape:
        raise ValueError(f"skip_dense must be {tuple(a_in.shape)}; got "
                         f"{tuple(skip_dense.shape)}")
    src, rsc = _check_residual("chain_bwd_pass", res, a_in)
    skip_dosel, skip_amax = skip_pool if skip_pool is not None else (None, None)
    device = _device_of("chain_bwd_pass", h_up, uc, w, a_in, sc_down, dz, dosel,
                        amax, src, rsc, skip_dosel, skip_amax, skip_dense)
    if device.type == "cpu":
        return chain_bwd_pass_reference(h_up, uc, w, a_in, sc_down, dz, dosel,
                                        amax, pool, need_dzd, res, skip_pool,
                                        skip_dense)
    _check_kernel("chain_bwd_pass", (a_in, h_up, w, dz, src, skip_dense),
                  (uc, sc_down, dosel, rsc, skip_dosel), (amax, skip_amax))
    plan = bwd_plan(B * R, Cd, Cu, a_in.dtype == torch.bfloat16, sc_down is None,
                    sm_count(device.index))
    dh = _bwd_dh(plan, h_up, uc, dz, dosel, amax, pool)
    dzd, sdse, a_up = _bwd_da(plan, dh, w, a_in, sc_down, need_dzd, res, skip_pool,
                              skip_dense, pool)
    dw = _bwd_dw(plan, dh, a_up)
    chain_bwd_pass.launches += 1
    if sdse is None:
        return dzd, None, None, dw
    return dzd, sdse[0], sdse[1], dw


chain_bwd_pass.launches = 0


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def _layer_residual(u, L, residual, hs, scs, rs):
    """The residual of layer u's input (None, (h0, sc0) or a stored r)."""
    mode, aux = layer_res_cfg(u, L, residual)
    if mode == RES_BNRELU:
        return hs[0], scs[0]
    if mode == RES_DENSE:
        return rs[aux - 1]
    return None


def _chain_forward(x, ws, gammas, betas, pen, pool, final_relu, passes,
                   residual=False):
    """The forward passes, each through `passes` = (mm_stats,
    bnact_mm_stats, bn_pool) or their plain versions. Returns the pooled
    output, the per-layer (ssum, ssq) and what the backward reads: the
    weights in x.dtype, every h and its scalars, the stored residuals r_j
    and the pool's maxv, amax and hsel."""
    mm, bnact, pool_pass = passes
    n = x.shape[0] * x.shape[1]
    L = len(ws)
    blocks = (L - 1) // 2
    ws_c = [w.to(x.dtype).contiguous() for w in ws]
    hs, stats, scs, rs = [], [], [], []
    for u in range(L):
        if u:
            # a block's input past the first is stored: a later residual
            write_r = residual and u % 2 == 1 and (u + 1) // 2 >= 2
            h, ss, sq, *r = bnact(hs[-1], scs[-1], ws_c[u], write_r=write_r,
                                  res=_layer_residual(u, L, residual, hs, scs, rs))
            rs += r
        else:
            h, ss, sq = mm(x, ws_c[0])
        hs.append(h)
        stats.append((ss, sq))
        scs.append(affine_scalars(ss, sq, gammas[u], betas[u], n))
    pool_res = None
    if residual:  # the last block's input joins its output before the max
        pool_res = (hs[0], scs[0]) if blocks == 1 else rs[blocks - 2]
    out, maxv, amax, hsel = pool_pass(hs[-1], scs[-1], pen, pool, final_relu,
                                      res=pool_res)
    return out, tuple(stats), (ws_c, hs, scs, rs, maxv, amax, hsel)


_KERNELS = (mm_stats, bnact_mm_stats, bn_pool)
_PLAIN = (mm_stats_reference, bnact_mm_stats_reference, bn_pool_reference)


def _chain_backward(x, gammas, saved, dout, pool, final_relu, need_dx, bwd_pass,
                    residual=False):
    """The backward passes, top layer first, each through `bwd_pass`
    (`chain_bwd_pass` or its plain version). `saved` as `_chain_forward`
    returns it (the residual chain's backward reads only rs[:-1]). Returns
    (dx or None, dws, dgammas, dbetas), fp32 but dx.

    Residual chain: the input of block j (layer 2j - 1's input) feeds the
    block's output too, so its cotangent takes a skip share: the pooled
    cotangent for the last block, the project layer 2j's dz for the others.
    Every dz is dropped right after its last pass reads it."""
    ws_c, hs, scs, rs, maxv, amax, hsel = saved
    L = len(ws_c)
    blocks = (L - 1) // 2
    n = x.shape[0] * x.shape[1]
    gate = 0.0 if final_relu else 0.5 * _SENT
    dosel = (dout.float() * (maxv > gate)).contiguous()
    sd = dosel.sum(dim=(0, 1))
    se = (dosel * ((hsel - scs[-1][0]) * scs[-1][3])).sum(dim=(0, 1))
    dws, dgs, dbs = [None] * L, [None] * L, [None] * L
    dzs = {}  # the dense cotangents still to be read, by layer
    dx = None
    for u in range(L - 1, -1, -1):
        dgs[u], dbs[u] = se, sd
        uc = up_scalars(scs[u], gammas[u], sd, se, n)
        if u == L - 1:
            kw = dict(dosel=dosel, amax=amax, pool=pool)
        else:
            # a project layer's dz below the top is read again as a skip share
            keep = residual and u % 2 == 0 and u > 0
            kw = dict(dz=dzs[u] if keep else dzs.pop(u), pool=pool)
        if u:
            kw["res"] = _layer_residual(u, L, residual, hs, scs, rs)
            if residual and u % 2 == 1:
                j = (u + 1) // 2
                if j == blocks:
                    kw["skip_pool"] = (dosel, amax)
                else:
                    kw["skip_dense"] = dzs.pop(2 * j)
            dzs[u - 1], sd, se, dws[u] = bwd_pass(hs[u], uc, ws_c[u], hs[u - 1],
                                                  scs[u - 1], **kw)
        else:
            dx, _, _, dws[0] = bwd_pass(hs[0], uc, ws_c[0], x, None,
                                        need_dzd=need_dx, **kw)
    return dx, dws, dgs, dbs


class _ChainFused(torch.autograd.Function):
    """Inputs (pool, final_relu, residual, L, x, pen, *ws, *gammas, *betas);
    outputs (pooled, ssum_0, ssq_0, ..): the statistics are marked
    non-differentiable."""

    @staticmethod
    def forward(ctx, pool, final_relu, residual, L, x, pen, *params):
        ws, gammas, betas = params[:L], params[L:2 * L], params[2 * L:]
        out, stats, (ws_c, hs, scs, rs, maxv, amax, hsel) = _chain_forward(
            x, ws, gammas, betas, pen, pool, final_relu, _KERNELS, residual)
        # the last stored residual feeds the pool pass alone
        ctx.save_for_backward(x, maxv, amax, hsel, *gammas, *ws_c, *hs, *scs,
                              *rs[:-1])
        ctx.pool, ctx.final_relu, ctx.residual, ctx.L = pool, final_relu, residual, L
        flat = [t for pair in stats for t in pair]
        ctx.mark_non_differentiable(*flat)
        return (out, *flat)

    @staticmethod
    def backward(ctx, dout, *dstats):
        del dstats  # non-differentiable outputs
        L = ctx.L
        x, maxv, amax, hsel, *rest = ctx.saved_tensors
        gammas, ws_c, hs, scs = (rest[i * L:(i + 1) * L] for i in range(4))
        rs = rest[4 * L:]
        dx, dws, dgs, dbs = _chain_backward(
            x, gammas, (ws_c, hs, scs, rs, maxv, amax, hsel), dout.contiguous(),
            ctx.pool, ctx.final_relu, ctx.needs_input_grad[4], chain_bwd_pass,
            ctx.residual)
        # autograd casts each gradient to its input's dtype
        return (None, None, None, None, dx, None, *dws, *dgs, *dbs)


def _check_chain(x, ws, gammas, betas, pen, pool, residual=False):
    name = "preextract_pool" if residual else "mlp_pool"
    if x.dim() != 3 or not (len(ws) == len(gammas) == len(betas) >= 1):
        raise ValueError(f"{name} takes x (B, R, Cin) and L >= 1 weights, "
                         f"scales and offsets")
    B, R, cin = x.shape
    for w, g, b in zip(ws, gammas, betas):
        if w.dim() != 2 or w.shape[0] != cin or g.shape != (w.shape[1],) \
                or b.shape != g.shape:
            raise ValueError(f"{name} layer shapes do not chain: w "
                             f"{tuple(w.shape)} after width {cin}, scale "
                             f"{tuple(g.shape)}, offset {tuple(b.shape)}")
        cin = w.shape[1]
    if residual:
        if len(ws) < 3 or len(ws) % 2 != 1 or any(
                ws[u].shape[1] != ws[0].shape[1] for u in range(2, len(ws), 2)):
            raise ValueError("preextract_pool takes 1 + 2 * blocks layers (blocks "
                             ">= 1), every block's output as wide as layer 0's")
    elif pen is None or pen.shape != (B, R):
        raise ValueError(f"pen must be {(B, R)}; got "
                         f"{None if pen is None else tuple(pen.shape)}")
    if pool < 1 or R % pool:
        raise ValueError(f"pool must divide R = {R}; got {pool}")


def _reference(x, ws, gammas, betas, pen, pool, final_relu, residual):
    _check_chain(x, ws, gammas, betas, pen, pool, residual)
    return _chain_forward(x, ws, gammas, betas, pen, pool, final_relu, _PLAIN,
                          residual)[:2]


def _bwd_reference(x, ws, gammas, betas, pen, pool, dout, final_relu, residual):
    _check_chain(x, ws, gammas, betas, pen, pool, residual)
    with torch.no_grad():
        saved = _chain_forward(x, ws, gammas, betas, pen, pool, final_relu,
                               _PLAIN, residual)[2]
        return _chain_backward(x, gammas, saved, dout, pool, final_relu, True,
                               chain_bwd_pass_reference, residual)


def _fused(x, ws, gammas, betas, pen, pool, final_relu, residual):
    _check_chain(x, ws, gammas, betas, pen, pool, residual)
    device = _device_of("preextract_pool_fused" if residual else "mlp_pool_fused",
                        x, pen, *ws, *gammas, *betas)
    if device.type == "cpu":
        return _reference(x, ws, gammas, betas, pen, pool, final_relu, residual)
    out, *flat = _ChainFused.apply(
        pool, final_relu, residual, len(ws), x.contiguous(),
        None if pen is None else pen.contiguous(), *ws, *gammas, *betas)
    return out, tuple(zip(flat[0::2], flat[1::2]))


def mlp_pool_reference(x, ws, gammas, betas, pen, pool: int,
                       final_relu: bool = True):
    """Plain PyTorch version of `mlp_pool_fused` (a port of
    pointcloud_tpu/ops/preextract_fused.py:mlp_pool_reference), out of the
    plain passes and differentiable by autograd: the pool routes its gradient
    to the first maximal row, ReLU's gradient is 1[pre > 0], and the batch
    statistics are differentiated through."""
    return _reference(x, ws, gammas, betas, pen, pool, final_relu, False)


def mlp_pool_bwd_reference(x, ws, gammas, betas, pen, pool: int, dout,
                           final_relu: bool = True):
    """The chain's explicit backward out of the plain passes: the kernels'
    arithmetic with their rounding points (dh and dz rounded to x.dtype, the
    sums taken from the rounded values), where autograd through
    `mlp_pool_reference` rounds elsewhere in bf16. Returns (dx, dws, dgammas,
    dbetas) for the cotangent dout of the pooled output; cotangents of the
    statistics are not taken."""
    return _bwd_reference(x, ws, gammas, betas, pen, pool, dout, final_relu, False)


def mlp_pool_fused(x, ws, gammas, betas, pen, pool: int, final_relu: bool = True):
    """The set-abstraction body as the fused chain: L Dense + train-mode
    BatchNorm + ReLU layers over the grouped rows, then a masked max-pool
    over each group of `pool` rows.

    x (B, R, Cin) with R = S * pool, fp32 or bf16; ws[u] (C_{u-1}, C_u),
    gammas[u], betas[u] (C_u,) fp32; pen (B, R) fp32, +1e9 on rows kept out
    of the pool (they still feed the BatchNorm statistics). A group without
    a valid row gives -1e9 and gets no gradient; final_relu=False returns
    the pooled post-BatchNorm value without its ReLU.
    Returns (pooled (B, R / pool, C_last) in x.dtype, ((ssum, ssq), ...) per
    layer, fp32 sums of the rounded Dense outputs over all B * R rows).

    Gradients flow from `pooled` to x, ws, gammas and betas. The statistics
    are outputs for the running averages only: on CUDA tensors they are
    marked non-differentiable (the JAX function folds their cotangents into
    its passes; no caller sends one), while the plain version, being plain
    autograd, differentiates them too.

    CPU tensors take `mlp_pool_reference`; CUDA tensors run the kernels of
    csrc/mlp_chain.cu through `mm_stats`, `bnact_mm_stats`, `bn_pool` and, in
    the backward, `chain_bwd_pass`; anything they do not take raises.
    """
    return _fused(x, ws, gammas, betas, pen, pool, final_relu, False)


def preextract_pool_reference(x, ws, gammas, betas, pool: int):
    """Plain PyTorch version of `preextract_pool_fused` (a port of
    pointcloud_tpu/ops/preextract_fused.py:preextract_pool_reference), out
    of the plain passes and differentiable by autograd, as
    `mlp_pool_reference`."""
    return _reference(x, ws, gammas, betas, None, pool, True, True)


def preextract_pool_bwd_reference(x, ws, gammas, betas, pool: int, dout):
    """The residual chain's explicit backward out of the plain passes, with
    the kernels' rounding points (as `mlp_pool_bwd_reference`). Returns (dx,
    dws, dgammas, dbetas) for the cotangent dout of the pooled output."""
    return _bwd_reference(x, ws, gammas, betas, None, pool, dout, True, True)


def preextract_pool_fused(x, ws, gammas, betas, pool: int):
    """PointMLP's PreExtraction body as the fused residual chain: layer 0
    (Cin -> C) and `blocks` residual blocks (C -> mid -> C), each a Dense +
    train-mode BatchNorm (+ ReLU) over the grouped rows, the block's input
    added before the block's last ReLU (`layer_res_cfg`), then the max-pool
    over each group of `pool` rows and a ReLU. No mask.

    x (B, R, Cin) with R = G * pool, fp32 or bf16; ws (1 + 2 blocks
    weights), gammas, betas as `mlp_pool_fused`'s. Returns (pooled (B,
    R / pool, C) in x.dtype, ((ssum, ssq), ...) per layer). Gradients and
    statistics as `mlp_pool_fused`: on CUDA tensors the statistics are
    non-differentiable.

    CPU tensors take `preextract_pool_reference`; CUDA tensors run the
    kernels of csrc/mlp_chain.cu in their residual mode; anything they do not
    take raises.
    """
    return _fused(x, ws, gammas, betas, None, pool, True, True)
