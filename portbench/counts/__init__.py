"""The yardstick that rooflines and utilisations read: the published peaks of
one H100 and the operations and bytes of each kernel and model, counted from
shapes, whatever implements them.

The kernel bounds are copies of the program's measurement script's own
(`bound`, `chain_bounds`, `bwd_stage_bounds`, `sinkhorn_bound`,
`nn_sweep_bound`, `chamfer_bwd_bound`, `fps_bound`, `pool_fwd_bound`,
`pool_bwd_bound`): each counts every input byte read once and every output
byte written once. They live here so that a change to the program cannot
move them. Nothing here imports torch or the program.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# fp32 on the CUDA cores, bf16 on the tensor cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 instructions a second: 128 lanes an SM issue one each a clock, and the
# data sheet's fp32 rate counts an FMA as two operations
PEAK_FP32_ISSUE = PEAK_FP32_FLOPS / 2
# ex2 on the special-function units: 16 a clock an SM against 128 fp32 lanes
PEAK_SFU_OPS = PEAK_FP32_FLOPS / 2 / 8


def bound(ops, nbytes, peak_ops):
    """(bound ms, 'operations' or 'bytes') for work of `ops` operations at
    `peak_ops` per second and `nbytes` at the HBM rate."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def chain_bounds(rows, groups, cd, cu, es, sparse, down_bn, need_dzd=True,
                 res=False, write_r=False, pen=True, skip=None):
    """(forward product, pool pass over cu channels, backward pass) bounds of
    one layer of the fused Dense-BN-ReLU-pool chain: bytes with every tensor
    read or written once, operations at the dense bf16 tensor-core rate (2
    rows cd cu a product; the pool's ~6 fp32 operations an element on the
    CUDA cores)."""
    w_bytes = cd * cu * es
    fwd = bound(2 * rows * cd * cu,
                rows * (cd + cu) * es + w_bytes + 2 * cu * 4 + 3 * cd * 4
                + rows * cd * es * (int(res) + int(write_r)), PEAK_BF16_FLOPS)
    pool = bound(6 * rows * cu, rows * cu * es * (1 + int(res)) + rows * 4 * int(pen)
                 + groups * cu * (es + 12) + 3 * cu * 4, PEAK_FP32_FLOPS)
    dz_bytes = groups * cu * 8 if sparse else rows * cu * es
    skip_bytes = {None: 0, "pool": groups * cd * 8, "dense": rows * cd * es}[skip]
    bwd = bound((4 if need_dzd else 2) * rows * cd * cu,
                rows * cu * es + dz_bytes + w_bytes + rows * cd * es
                + (rows * cd * es if need_dzd else 0) + cd * cu * 4
                + (2 * cd * 4 if down_bn else 0) + 4 * cu * 4
                + rows * cd * es * int(res) + skip_bytes, PEAK_BF16_FLOPS)
    return fwd, pool, bwd


def bwd_stage_bounds(rows, groups, cd, cu, es, sparse, down_bn, need_dzd):
    """Bounds of one backward pass's three stages (dh, da, dw), each reading
    its inputs and writing its outputs once."""
    dz = groups * cu * 8 if sparse else rows * cu * es
    dh = bound(5 * rows * cu, 2 * rows * cu * es + dz + 16 * cu, PEAK_FP32_FLOPS)
    if down_bn:
        da = bound(2 * rows * cd * cu, rows * (cu + 3 * cd) * es + cd * cu * es,
                   PEAK_BF16_FLOPS)
    elif need_dzd:
        da = bound(2 * rows * cd * cu, rows * (cu + cd) * es + cd * cu * es,
                   PEAK_BF16_FLOPS)
    else:
        da = (0.0, "bytes")
    dw = bound(2 * rows * cd * cu, rows * (cd + cu) * es + cd * cu * 4, PEAK_BF16_FLOPS)
    return dh, da, dw


def chain_step_bound_ms(rows, groups, layout, es, need_dx):
    """The least time of one train step's whole chain at one level: every
    layer's forward product, the pool pass and every backward pass, as the
    chain walks them (layer 0's pass writes dx only where the level's input
    needs a gradient)."""
    L = len(layout)
    total = 0.0
    for u, (cd, cu) in enumerate(layout):
        total += chain_bounds(rows, groups, cd, cu, es, False, u > 0)[0][0]
        total += chain_bounds(rows, groups, cd, cu, es, u == L - 1, u > 0,
                              u > 0 or need_dx)[2][0]
    total += chain_bounds(rows, groups, 1, layout[-1][1], es, False, True)[1][0]
    return total


def sinkhorn_bound(B, N, M, iters):
    """The larger of one ex2 a pair in each of the 2 iters sweeps on the
    special-function units, the exponent's least fp32 work (7 operations a
    pair a sweep, ~10 a pair of the last pass) on the CUDA cores, and the
    bytes (both clouds' xyz read once, dists and assignment written once)."""
    pairs = B * N * M
    t_sfu = 2 * iters * pairs / PEAK_SFU_OPS * 1e3
    t_rest, by = bound((7 * 2 * iters + 10) * pairs,
                       B * (N + M) * 12 + B * N * 8, PEAK_FP32_FLOPS)
    return (t_sfu, "operations") if t_sfu >= t_rest else (t_rest, by)


def nn_depth(C: int) -> int:
    """K of the Chamfer sweep's cost product: six split cross products a
    dimension and the two norms' three parts each, padded to 16."""
    return -(-(6 * C + 6) // 16) * 16


def nn_sweep_bound(B, N, M, C):
    """The larger of the cost products (2 directions x B N M pairs x K deep
    at the bf16 tensor-core rate), the epilogue's compare and two selects a
    pair-direction at the fp32 rate, and the bytes (both clouds read once,
    8 bytes written a point)."""
    pairs = 2 * B * N * M
    t_mma = bound(pairs * 2 * nn_depth(C), 0, PEAK_BF16_FLOPS)[0]
    t_epi = bound(pairs * 3, 0, PEAK_FP32_FLOPS)[0]
    t_bytes = bound(0, B * (N + M) * (C * 4 + 8), PEAK_FP32_FLOPS)[0]
    worst = max(t_mma, t_epi, t_bytes)
    return worst, ("bytes" if worst == t_bytes else "operations")


def chamfer_bwd_bound(B, N, M, C):
    """Both clouds, cotangents and argmins read once, dx and dy written
    once; ~6C fp32 operations a point."""
    return bound((B * N + B * M) * 6 * C, (B * N + B * M) * (2 * C * 4 + 4 + 4),
                 PEAK_FP32_FLOPS)


def fps_bound(B, N, K):
    """~9 fp32 operations per (step, point); xyz read once, indices written
    once."""
    return bound(B * (K - 1) * N * 9, B * N * 3 * 4 + B * K * 4, PEAK_FP32_FLOPS)


def pool_fwd_bound(B, R, Cin, C, pool, pen):
    """The dense-pool forward: one product at the dense bf16 rate; x, w and
    the bias read (bf16), pen read, psel (bf16) and asel (int32) written,
    the sums written (fp32)."""
    return bound(2 * B * R * Cin * C,
                 (B * R * Cin + Cin * C + C) * 2 + (B * R * 4 if pen else 0)
                 + B * (R // pool) * C * 6 + 2 * C * 4, PEAK_BF16_FLOPS)


def pool_bwd_bound(B, R, Cin, C, pool):
    """The dense-pool backward: three products at the dense bf16 rate; x
    read and dx written (bf16), w and the bias read, asel and dpsel read,
    dw and db written (fp32)."""
    return bound(3 * 2 * B * R * Cin * C,
                 (2 * B * R * Cin + Cin * C + C) * 2 + B * (R // pool) * C * (4 + 4)
                 + Cin * C * 4 + 3 * C * 4, PEAK_BF16_FLOPS)


########################## model FLOPs from widths ##########################


def _mlp_flops(rows, cin, widths):
    total = 0
    for w in widths:
        total += 2 * rows * cin * w
        cin = w
    return total


def decoder_flops(cfg) -> int:
    """The bottleneck Dense and the PCDecoder's Dense stack, a cloud."""
    enc = 2 * 1024 * cfg["bottleneck"]
    dec = _mlp_flops(1, cfg["bottleneck"],
                     [*cfg["decoder_hidden"], cfg["points"] * cfg["point_dims"]])
    return enc + dec


def pointnet2_level_flops(cfg) -> list[int]:
    """The forward products of each SA level's shared MLP, a cloud: rows
    npoint x nsample (the whole cloud at the group-all level), input 3 +
    the features' width."""
    feats, n, out = cfg["point_dims"] - 3, cfg["points"], []
    for lv in cfg["sa"]:
        rows = n if lv.get("group_all") else lv["npoint"] * lv["nsample"]
        out.append(_mlp_flops(rows, 3 + feats, lv["mlp"]))
        feats = lv["mlp"][-1]
        n = 1 if lv.get("group_all") else lv["npoint"]
    return out


def pointnet_flops(cfg) -> int:
    """PointNet with both STNs, a cloud: every Dense product (the per-point
    layers over N rows, the STN heads over one row) and the two transforms'
    batched products."""
    n, d = cfg["points"], cfg["point_dims"]
    stn_w = cfg["stn"]  # (point widths, pooled width, head widths)

    def stn(cin, k):
        pts = _mlp_flops(n, cin, [*stn_w["point"], stn_w["pooled"]])
        head = _mlp_flops(1, stn_w["pooled"], [*stn_w["head"], k * k])
        return pts + head

    total = stn(d, 3) + 2 * n * 3 * 3
    total += _mlp_flops(n, d, cfg["mlp0"])
    k = cfg["mlp0"][-1]
    total += stn(k, k) + 2 * n * k * k
    total += _mlp_flops(n, k, [*cfg["mlp1"], cfg["encoding"]])
    return total


def forward_flops(cfg) -> int:
    """Model FLOPs of one cloud's forward pass: the products alone."""
    if cfg["backbone"] == "PointNet2":
        enc = sum(pointnet2_level_flops(cfg))
    elif cfg["backbone"] == "PointNet":
        enc = pointnet_flops(cfg)
    else:
        raise ValueError(f"no FLOP count for backbone {cfg['backbone']!r}")
    return enc + decoder_flops(cfg)


def chain_train_bound_ms(cfg, B, es=2) -> float:
    """The least time of a PointNet++ train step's fused chains, all levels,
    bf16 (es = 2 bytes)."""
    feats, n, total = cfg["point_dims"] - 3, cfg["points"], 0.0
    for i, lv in enumerate(cfg["sa"]):
        if lv.get("group_all"):
            groups, pool = 1, n
        else:
            groups, pool = lv["npoint"], lv["nsample"]
        layout = list(zip((3 + feats, *lv["mlp"][:-1]), lv["mlp"]))
        total += chain_step_bound_ms(B * groups * pool, B * groups, layout, es,
                                     need_dx=i > 0)
        feats = lv["mlp"][-1]
        n = 1 if lv.get("group_all") else lv["npoint"]
    return total
