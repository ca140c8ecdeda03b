#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (pointcloud_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases; any failure raises and the script exits non-zero without its result
lines:
  1. build every kernel in pointcloud_tpu_torch/csrc/ (one nvcc each, in
     parallel) into build/, or reuse the build;
  2. hold each kernel against its plain PyTorch version on the card (masks,
     fully masked rows, exact ties, bf16 and fp32) and run each new kernel
     twice on the same inputs: the results must be bit-equal;
  3. the eval path at full width: create_model("Autoencoder", "PointNet",
     "Cube", loss_override="chamfer") and its eval step at B=512 x 2048
     points x 6 dims (bf16 activations), plus `encode` on one cloud;
  4. the train path at full width: make_optimizer + make_train_step at
     bench.py's B=256 x 2048 x 6, bf16, one fixed batch, 1 warm-up step and
     10 chained steps;
  5. the segment-sum route of the Chamfer backward: chamfer_distance(x, y)
     .backward() at B=4, N=M=4096, C=6 (above the 6<<20 switch);
  6. check the outputs: finite values of the right shapes, the kernel-path
     loss vs the plain version's, and the fp32 model's eval step and train
     step, and the STN heads in train mode on distinct clouds, on the card
     vs on the CPU;
  7. hold each kernel against its plain version again at its path's shapes
     and inputs, then time it there beside its plain version, a library
     yardstick and its bound; both Chamfer backward routes at the train
     step's shapes; the eval step's and the train step's parts.
For each path (3, 4, 5) every kernel's launch count is set to 0 just before
and read just after. The last three lines of standard output are
nvidia-smi's name and power limit, the `kernels` JSON object and the `ok`
JSON object. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, dense
# bf16 on the tensor cores, and HBM3 bandwidth. Bounds are stated against
# these, beside the power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

B_MAIN = 512  # bench.py's eval batch
ITERS = 20  # chained eval steps after the first
B_TRAIN = 256  # bench.py's train batch
TRAIN_ITERS = 10  # chained train steps after the warm-up step
B_ROUTE, P_ROUTE = 4, 4096  # 16.8M cost elements per cloud: the segment-sum route


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops, nbytes, peak_ops):
    """(bound ms, 'operations' or 'bytes') for work of `ops` operations at
    `peak_ops` per second and `nbytes` at the HBM rate."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def counters():
    from pointcloud_tpu_torch.ops import (
        chamfer_bwd,
        dense_pool_stats,
        dense_pool_stats_bwd,
        nn_sweep,
        scatter_rows,
    )
    return {"nn_sweep": nn_sweep, "scatter_rows": scatter_rows,
            "chamfer_bwd": chamfer_bwd, "dense_pool_stats": dense_pool_stats,
            "dense_pool_stats_bwd": dense_pool_stats_bwd}


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def expect_counts(path, got, want):
    if got != want:
        raise AssertionError(f"{path}: kernel launches {got}, expected {want}")


def rel_err(got, want):
    """max |got - want| over max |want|, in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def check_nn_sweep(gen, B, N, M, C):
    """nn_sweep's kernel vs its plain version with ~10% of points masked, a
    batch element whose x points are all masked (element 1), one whose y
    points are all masked (element 2), and exact ties. Returns the largest
    value error over valid points."""
    from pointcloud_tpu_torch.ops import nn_sweep, nn_sweep_reference
    from pointcloud_tpu_torch.ops.geometry import pairwise_sqdist

    dev = torch.device("cuda")
    x = torch.rand((B, N, C), generator=gen, device=dev)
    y = torch.rand((B, M, C), generator=gen, device=dev)
    y[:, M - 1] = y[:, 7]  # duplicate target: x point 11 sits on both
    x[:, 11] = y[:, 7]
    x[:, N - 1] = x[:, 3]  # duplicate x point: y point 5 sits on both
    y[:, 5] = x[:, 3]
    xm = torch.rand((B, N), generator=gen, device=dev) > 0.1
    ym = torch.rand((B, M), generator=gen, device=dev) > 0.1
    xm[:, [3, 11, N - 1]] = True
    ym[:, [5, 7, M - 1]] = True
    xm[1] = False
    ym[2] = False

    got = nn_sweep(x, y, xm, ym)
    torch.cuda.synchronize()
    want = nn_sweep_reference(x, y, xm, ym)
    d = pairwise_sqdist(x, y)
    err = 0.0
    for v, i, qm, tm, dd in ((0, 1, xm, ym, d), (2, 3, ym, xm, d.transpose(1, 2))):
        has_target = tm.any(dim=1, keepdim=True)
        valid = qm & has_target
        e = float((got[v] - want[v]).abs()[valid].max())
        err = max(err, e)
        if e > 1e-5:
            raise AssertionError(f"nn_sweep values differ by {e} (C={C})")
        if not bool((got[v][~valid] >= 1e10).all()):
            raise AssertionError("masked or target-less queries need >= 1e10")
        # indices equal wherever the plain version's runner-up gap > 1e-5
        two = torch.topk(dd.masked_fill(~tm[:, None, :], 1e10), 2, dim=2,
                         largest=False).values
        clear = (two[..., 1] - two[..., 0] > 1e-5) & has_target
        if not bool((got[i] == want[i])[clear].all()):
            raise AssertionError(f"nn_sweep argmins differ off ties (C={C})")
    tie_x = ym.any(dim=1)  # elements where x point 11 has valid targets
    tie_y = xm.any(dim=1)
    if not (bool((got[1][tie_x, 11] == 7).all())
            and bool((got[3][tie_y, 5] == 3).all())):
        raise AssertionError("an exact tie must go to the first index")
    log(f"  nn_sweep C={C} B={B} N={N} M={M}: max |value err| {err:.3e}; "
        f"argmins equal off ties; masked rows >= 1e10; ties to first index")
    return err


def twice_equal(name, fn):
    """Run fn twice on the same inputs; the results must be bit-equal."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    return a


def check_scatter_rows(gen, B, R, n, C):
    """scatter_rows vs index_add_ (the plain version) in fp32 with init and
    in bf16 without; a third of the rows go to target 3 (ties), and the
    kernel runs twice. fp32: 1e-4 relative to the largest output (the two
    sum in other orders). Returns the largest absolute error."""
    from pointcloud_tpu_torch.ops import scatter_rows, scatter_rows_reference

    dev = torch.device("cuda")
    err = 0.0
    for dtype, with_init in ((torch.float32, True), (torch.bfloat16, False)):
        g = torch.randn((B, R, C), generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, n, (B, R), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[:, ::3] = 3
        init = (torch.randn((B, n, C), generator=gen, device=dev)
                if with_init else None)
        got = twice_equal("scatter_rows",
                          lambda: (scatter_rows(g, idx, n, init=init),))[0]
        want = scatter_rows_reference(g, idx, n, init)
        e = rel_err(got, want)
        err = max(err, float((got - want).abs().max()))
        if e > 1e-4:
            raise AssertionError(f"scatter_rows {dtype} differs by {e:.2e} rel")
        log(f"  scatter_rows {dtype} B={B} R={R} n={n} C={C} "
            f"init={with_init}: rel err {e:.2e}; two runs bit-equal")
    return err


def nn_inputs(gen, B, N, M, C, masked):
    """Clouds, nn_sweep argmins and cotangents zeroed on masked rows."""
    from pointcloud_tpu_torch.ops import nn_sweep

    dev = torch.device("cuda")
    x = torch.rand((B, N, C), generator=gen, device=dev)
    y = torch.rand((B, M, C), generator=gen, device=dev)
    xm = ym = None
    if masked:
        xm = torch.rand((B, N), generator=gen, device=dev) > 0.1
        ym = torch.rand((B, M), generator=gen, device=dev) > 0.1
    _, ax, _, ay = nn_sweep(x, y, xm, ym)
    gx = torch.randn((B, N), generator=gen, device=dev) / N
    gy = torch.randn((B, M), generator=gen, device=dev) / M
    if masked:
        gx, gy = gx * xm, gy * ym
    return x, y, gx, gy, ax, ay


def check_chamfer_bwd(gen, B, N, M, C):
    """chamfer_bwd vs its plain version on clouds with masks."""
    return compare_chamfer_bwd(nn_inputs(gen, B, N, M, C, masked=True), "masked")


def compare_chamfer_bwd(args, label):
    """chamfer_bwd(*args) vs its plain version (gathers + index_add_), the
    kernel twice. 1e-4 relative to the largest gradient (summation order
    only). Returns the largest absolute error."""
    from pointcloud_tpu_torch.ops import chamfer_bwd, chamfer_bwd_reference

    got = twice_equal("chamfer_bwd", lambda: chamfer_bwd(*args))
    want = chamfer_bwd_reference(*args)
    err = 0.0
    for g, w in zip(got, want):
        e = rel_err(g, w)
        err = max(err, float((g - w).abs().max()))
        if e > 1e-4:
            raise AssertionError(f"chamfer_bwd differs by {e:.2e} rel")
    B, N, C = args[0].shape
    log(f"  chamfer_bwd C={C} B={B} N={N} M={args[1].shape[1]} {label}: max "
        f"|err| {err:.2e}; two runs bit-equal")
    return err


def dense_inputs(gen, B, R, Cin, C, dtype, masked):
    dev = torch.device("cuda")
    x = torch.randn((B, R, Cin), generator=gen, device=dev).to(dtype)
    w = (torch.randn((Cin, C), generator=gen, device=dev) / Cin ** 0.5).to(dtype)
    b = (0.1 * torch.randn((C,), generator=gen, device=dev)).to(dtype)
    s = torch.where(torch.rand((C,), generator=gen, device=dev) > 0.3, 1.0, -1.0)
    pen = None
    if masked:  # ~10% of rows masked, never a whole pool block
        keep = torch.rand((B, R), generator=gen, device=dev) > 0.1
        keep[:, 0] = True
        pen = torch.where(keep, 0.0, 1e9)
    return x, w, b, s, pen


def bf16_ulp(v):
    """One bf16 ulp of |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


def check_dense_pool(gen, B, R, Cin, C, pool, dtype, masked):
    """dense_pool_stats on random inputs; see compare_dense_pool."""
    return compare_dense_pool(gen, *dense_inputs(gen, B, R, Cin, C, dtype, masked),
                              pool)[:2]


def compare_dense_pool(gen, x, w, b, s, pen, pool):
    """dense_pool_stats' forward and backward kernels vs the plain version
    and its autograd, each kernel twice. fp32: 1e-4 relative (summation
    order only). bf16, where accumulation order can flip one rounding of z:
    psel within 1 bf16 ulp of |z|, asel equal wherever the runner-up is more
    than 1 ulp below, ssum, ssq, dw, db within 1e-3 relative and dx within
    2e-2 relative (bf16 values), relative to the largest entry; bf16 db
    against the fp32 sum of the plain version's dz, before its cast.
    Returns the largest absolute errors of the forward (psel) and of the
    backward (dw), and the kernel's forward outputs."""
    from pointcloud_tpu_torch.ops import (
        dense_pool_stats,
        dense_pool_stats_bwd,
        dense_pool_stats_reference,
    )

    (B, R, Cin), C, dtype, masked = x.shape, w.shape[1], x.dtype, pen is not None
    got = twice_equal("dense_pool_stats",
                      lambda: dense_pool_stats(x, w, b, s, pen, pool))
    want = dense_pool_stats_reference(x, w, b, s, pen, pool)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    # psel and asel against the plain version's pool of the same z
    z = (torch.matmul(x.float(), w.float()) + b.float()).to(dtype).float()
    zs = (z * s - (0.0 if pen is None else pen[..., None]))
    top2 = torch.topk(zs.reshape(B, R // pool, pool, C), 2, dim=2).values
    if dtype == torch.float32:
        ps_ok = (got[0] - want[0]).abs() <= 1e-4 * want[0].abs().max()
        gap = top2[:, :, 0] - top2[:, :, 1] > 1e-5 * top2[:, :, 0].abs()
    else:
        ps_ok = (got[0].float() - want[0].float()).abs() <= bf16_ulp(want[0])
        gap = top2[:, :, 0] - top2[:, :, 1] > bf16_ulp(top2[:, :, 0])
    if not bool(ps_ok.all()):
        raise AssertionError(f"dense_pool_stats psel {dtype} off by more than "
                             f"its tolerance at {int((~ps_ok).sum())} entries")
    if not bool((got[1] == want[1])[gap].all()):
        raise AssertionError(f"dense_pool_stats asel {dtype} differs off ties")
    e_stats = max(rel_err(got[2], want[2]), rel_err(got[3], want[3]))
    if e_stats > tol:
        raise AssertionError(f"dense_pool_stats ssum/ssq {dtype}: {e_stats:.2e}")
    err = float((got[0].float() - want[0].float()).abs().max())

    # backward: the kernel vs autograd through the plain version, on the same
    # cotangents; w and bias enter the plain version as fp32 leaves holding
    # the same values, so its dw and db stay fp32 as the kernel's
    # pools whose two selections differ (a near tie, see above) get no
    # cotangent, so both sides route each pooled gradient to the same row
    dpsel = torch.randn(got[0].shape, generator=gen, device=x.device)
    dpsel = (dpsel * (got[1] == want[1])).to(dtype).float()
    dssum = torch.randn((C,), generator=gen, device=x.device) / (B * R)
    dssq = torch.randn((C,), generator=gen, device=x.device) / (B * R)
    kx, kw, kb = twice_equal("dense_pool_stats_bwd", lambda: dense_pool_stats_bwd(
        x, w, b, s, got[1], dpsel, dssum, dssq, pool))
    xl = x.detach().clone().requires_grad_()
    wl = w.float().requires_grad_()
    bl = b.float().requires_grad_()
    out = dense_pool_stats_reference(xl, wl, bl, s, pen, pool)
    rx, rw, rb = torch.autograd.grad(
        (out[0], out[2], out[3]), (xl, wl, bl),
        (dpsel.to(out[0].dtype), dssum, dssq))
    if dtype == torch.bfloat16:
        # the kernel sums dz before its bf16 cast (as the TPU kernel does);
        # autograd sums the cast values, 2^-9 apart on each pooled row
        nb = R // pool
        sparse = torch.zeros((B, nb, pool, C), device=x.device)
        sparse.scatter_(2, got[1].long()[:, :, None, :], (dpsel * s)[:, :, None, :])
        rb = (dssum + 2 * dssq * z + sparse.reshape(B, R, C)).sum(dim=(0, 1))
    e_dx = rel_err(kx, rx)
    e_dw = max(rel_err(kw, rw), rel_err(kb, rb))
    if e_dw > tol or e_dx > (tol if dtype == torch.float32 else 2e-2):
        raise AssertionError(f"dense_pool_stats_bwd {dtype}: dx {e_dx:.2e}, "
                             f"dw/db {e_dw:.2e} rel")
    err_bwd = float((kw - rw).abs().max())
    log(f"  dense_pool_stats {str(dtype)[6:]} B={B} R={R} Cin={Cin} C={C} "
        f"pool={pool} pen={masked}: psel ok, asel equal off ties, ssum/ssq "
        f"rel {e_stats:.1e}; bwd dx rel {e_dx:.1e}, dw/db rel {e_dw:.1e}; "
        f"fwd and bwd two runs bit-equal")
    return err, err_bwd, got


def raw_batch(gen, sc, B, P, dev):
    bbox = torch.tensor(sc.bbox, dtype=torch.float32, device=dev)
    return torch.cat([
        bbox[:, 0] + torch.rand((B, P, 3), generator=gen, device=dev)
        * (bbox[:, 1] - bbox[:, 0]),
        torch.rand((B, P, 3), generator=gen, device=dev),
    ], dim=-1)


def randomize_(module, gen):
    """Redraw every parameter and running statistic of `module` from the CPU
    generator `gen`: weights ~ N(0, 1/fan_in), biases and offsets ~ N(0,
    0.1), BatchNorm scales of random sign with |scale| in [0.5, 1.5] (a
    negative one sends the pool through its min branch), running means ~
    N(0, 0.1) and variances in [0.5, 2]."""
    with torch.no_grad():
        for name, t in module.state_dict().items():
            leaf, shape = name.rsplit(".", 1)[-1], t.shape
            if leaf == "weight":
                v = torch.randn(shape, generator=gen) / shape[1] ** 0.5
            elif leaf == "scale":
                v = torch.where(torch.rand(shape, generator=gen) < 0.2, -1.0, 1.0)
                v = v * (0.5 + torch.rand(shape, generator=gen))
            elif leaf == "var":
                v = 0.5 + 1.5 * torch.rand(shape, generator=gen)
            else:
                v = 0.1 * torch.randn(shape, generator=gen)
            t.copy_(v)


def card_vs_cpu_heads(seed, B=8, N=2048):
    """The encoder's two STN heads in train mode, fp32, on the card and on
    the CPU with the same random weights and inputs (drawn on the CPU), at B
    distinct clouds of N points, where the heads' BatchNorms normalise B
    distinct values per channel: the output, the gradients of sum(out * r)
    to every parameter and to the input, and the running statistics.
    Tolerances as tests/test_torch_pointnet_train.py holds these modules
    against the JAX package (each head BatchNorm scales round-off by scale /
    std over B values): outputs and running statistics 1e-3 absolute and
    relative; gradients 1e-3 relative plus 1e-3 of the tensor's largest
    entry plus 1e-5 of the module's largest gradient; zero-gradient biases
    round-off below 1e-4 of the largest gradient."""
    import copy

    from pointcloud_tpu_torch.models.pointnet import STN
    from pointcloud_tpu_torch.train import zero_gradient_bias

    gen = torch.Generator().manual_seed(seed)
    used = {}  # the largest share of its tolerance each tensor used
    for head, k, cin in (("stn", 3, 6), ("fstn", 64, 64)):
        cpu = STN(k, cin)
        randomize_(cpu, gen)
        card = copy.deepcopy(cpu).cuda()
        x = torch.rand((B, N, cin), generator=gen)
        r = torch.randn((B, k, k), generator=gen)
        res = []
        for m, dev in ((card, "cuda"), (cpu, "cpu")):
            xl = x.to(dev).requires_grad_()
            out = m(xl, train=True)
            (out * r.to(dev)).sum().backward()
            res.append((out.detach().cpu(),
                        {n: p.grad.cpu() for n, p in m.named_parameters()},
                        xl.grad.cpu(),
                        {n: t.cpu() for n, t in m.named_buffers()}))
        (out_g, grads_g, dx_g, stats_g), (out_c, grads_c, dx_c, stats_c) = res
        checks = [(n, got, stats_c[n] if n in stats_c else out_c, 1e-3)
                  for n, got in [("output", out_g), *stats_g.items()]]
        top = max(float(g.abs().max()) for g in grads_c.values())
        for name, want in [*grads_c.items(), ("input", dx_c)]:
            got = dx_g if name == "input" else grads_g[name]
            if zero_gradient_bias(f"encoder.backbone.{head}.{name}"):
                if float(got.abs().max()) > 1e-4 * top:
                    raise AssertionError(f"{head} {name}: gradient is not round-off")
                continue
            checks.append((name, got, want,
                           1e-3 * float(want.abs().max()) + 1e-5 * top))
        for name, got, want, floor in checks:
            share = float(((got - want).abs() / (1e-3 * want.abs() + floor)).max())
            used[f"{head}.{name}"] = share
            if share > 1:
                raise AssertionError(f"{head} {name}: card vs CPU differ")
    name = max(used, key=used.get)
    log(f"  STN heads in train mode, fp32, card vs CPU, B={B} distinct clouds "
        f"x {N}: outputs, gradients and running statistics within tolerance; "
        f"largest share of a tolerance used {used[name]:.2e} ({name})")


def card_vs_cpu_train(seed, x_raw):
    """The fp32 model's train step on the card and on the CPU, from the same
    weights, on one cloud repeated (B=2: the STN heads' batch variance is
    then exactly 0 on both sides, see tests/test_torch_train_slice.py, so
    their weights get no gradient here; card_vs_cpu_heads covers them).
    First-step loss 1e-5 relative and gradients 1e-3 relative plus 3e-3 of
    each tensor's largest entry (zero-gradient biases: round-off below 1e-4
    of the largest gradient); losses of 3 steps 1e-3 relative."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.train import (
        create_model,
        make_optimizer,
        make_train_step,
        zero_gradient_bias,
    )

    cfg.precision = "fp32"
    try:
        specs = [create_model("Autoencoder", "PointNet", "Cube",
                              loss_override="chamfer", device=d, seed=seed)
                 for d in ("cuda", "cpu")]
    finally:
        cfg.precision = "bf16-mixed"
    xs = x_raw[:1].repeat(2, 1, 1)
    losses, grads = [], []
    for spec in specs:
        step = make_train_step(spec, make_optimizer(spec))
        xd = xs.to(next(spec.model.parameters()).device)
        ls = []
        for i in range(3):
            ls.append(float(step(xd, xd)[0]))
            if i == 0:
                grads.append({k: p.grad.detach().float().cpu()
                              for k, p in spec.model.named_parameters()})
        losses.append(ls)
    top = max(float(g.abs().max()) for g in grads[1].values())
    worst = 0.0
    for k, want in grads[1].items():
        got = grads[0][k]
        if zero_gradient_bias(k):
            if float(got.abs().max()) > 1e-4 * top:
                raise AssertionError(f"{k}: gradient on the card is not round-off")
            continue
        excess = ((got - want).abs() - 1e-3 * want.abs()
                  - 3e-3 * float(want.abs().max())).max()
        worst = max(worst, rel_err(got, want))
        if float(excess) > 0:
            raise AssertionError(f"{k}: card vs CPU first-step gradient differs")
    l_gpu, l_cpu = losses
    if abs(l_gpu[0] - l_cpu[0]) > 1e-5 * l_cpu[0] or any(
            abs(a - b) > 1e-3 * b for a, b in zip(l_gpu, l_cpu)):
        raise AssertionError(f"card vs CPU train losses {l_gpu} vs {l_cpu}")
    log(f"  fp32 train step, card vs CPU, B=2: losses {l_gpu} vs {l_cpu}; "
        f"first-step gradients max rel err {worst:.2e}")
    return l_gpu[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and clouds")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1

    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import (
        _build,
        chamfer_bwd,
        chamfer_bwd_reference,
        chamfer_distance,
        dense_pool_stats,
        dense_pool_stats_bwd,
        dense_pool_stats_reference,
        nn_sweep,
        nn_sweep_reference,
        scatter_rows,
        scatter_rows_reference,
    )
    from pointcloud_tpu_torch.ops.chamfer import nn_grads_segment_sum
    from pointcloud_tpu_torch.ops.chamfer_bwd import gather_rows
    from pointcloud_tpu_torch.train import (
        create_model,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvidia-smi: {smi}")

    # ---- 1. build ----
    secs = _build.build()
    log(f"[build] {_build.sources()} -> {_build.BUILD_DIR}: {secs:.1f} s "
        f"({'built' if secs else 'reused'})")

    # ---- 2. kernels vs plain versions ----
    log("[kernels vs plain versions]")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    err = {
        "nn_sweep": max(check_nn_sweep(gen, 8, 2048, 2048, 3),
                        check_nn_sweep(gen, 8, 2048, 2048, 6),
                        check_nn_sweep(gen, 3, 1000, 2500, 8)),
        "scatter_rows": max(check_scatter_rows(gen, B_ROUTE, P_ROUTE, P_ROUTE, 6),
                            check_scatter_rows(gen, 3, 1000, 77, 8)),
        "chamfer_bwd": max(check_chamfer_bwd(gen, 8, 2048, 2048, 6),
                           check_chamfer_bwd(gen, 3, 1000, 2500, 3)),
    }
    dense = [
        check_dense_pool(gen, 4, 2048, 128, 1024, 2048, torch.bfloat16, True),
        check_dense_pool(gen, 4, 2048, 64, 1024, 256, torch.bfloat16, False),
        check_dense_pool(gen, 4, 2048, 128, 1024, 2048, torch.float32, True),
        check_dense_pool(gen, 4, 2048, 64, 1024, 32, torch.float32, False),
        check_dense_pool(gen, 3, 150, 72, 200, 30, torch.bfloat16, True),
        check_dense_pool(gen, 3, 150, 72, 200, 150, torch.float32, True),
    ]
    err["dense_pool_stats"] = max(e[0] for e in dense)
    err["dense_pool_stats_bwd"] = max(e[1] for e in dense)

    # ---- 3. eval path at full width ----
    log("[eval path] Autoencoder / PointNet / Chamfer, scene Cube")
    spec = create_model("Autoencoder", "PointNet", "Cube",
                        loss_override="chamfer", device=dev, seed=args.seed)
    step = make_eval_step(spec)
    sc = spec.scene
    P = sc.sample_points
    x_raw = raw_batch(gen, sc, B_MAIN, P, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t_first = time.perf_counter()
    loss, _, out = step(x_raw, x_raw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t_first
    events = [torch.cuda.Event(enable_timing=True) for _ in range(ITERS + 1)]
    x = x_raw
    t0 = time.perf_counter()
    events[0].record()
    for k in range(ITERS):
        # chained on the previous loss, as bench.py: no call can be elided
        x = x + loss * 1e-9
        loss, _, out = step(x, x)
        events[k + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.inference_mode():
        enc = spec.model.encode(spec.in_transform(x_raw[:1])[0])
    torch.cuda.synchronize()
    eval_counts = read_counts()
    expect_counts("eval path", eval_counts, {
        "nn_sweep": ITERS + 1, "scatter_rows": 0, "chamfer_bwd": 0,
        "dense_pool_stats": 0, "dense_pool_stats_bwd": 0})

    per_iter = sorted(events[k].elapsed_time(events[k + 1]) for k in range(ITERS))
    ms_iter = wall / ITERS * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  eval step B={B_MAIN}: first call {first_s:.3f} s; {ITERS} chained "
        f"steps {ms_iter:.3f} ms/step on the host clock -> "
        f"{B_MAIN / (ms_iter / 1e3):.1f} clouds/s; event-to-event median "
        f"{per_iter[ITERS // 2]:.3f} ms (min {per_iter[0]:.3f}, max "
        f"{per_iter[-1]:.3f}); peak memory {peak_gib:.2f} GiB | {smi}")
    log(f"  encode(1 cloud) -> {tuple(enc.shape)} {enc.dtype}; launches "
        f"{eval_counts}")
    if not bool(torch.isfinite(loss)) or not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"non-finite loss {loss} or encoding")
    if out.shape != (B_MAIN, P, 6) or enc.shape != (1, sum(sc.class_latent_dim)):
        raise AssertionError(f"shapes {tuple(out.shape)}, {tuple(enc.shape)}")
    y = spec.out_transform(x)[0]  # the last step's target
    with torch.inference_mode():
        kern8 = float(chamfer_distance(out[:8], y[:8]))
        plain8 = float(chamfer_distance(out[:8].cpu(), y[:8].cpu()))
    log(f"  loss {float(loss):.6f}; first 8 clouds: kernel path {kern8:.7f}, "
        f"plain version (CPU) {plain8:.7f}, |diff| {abs(kern8 - plain8):.2e}")
    if abs(kern8 - plain8) > 1e-4:
        raise AssertionError("kernel-path loss disagrees with the plain version")

    # yardsticks of the eval path
    a, b = out, y
    got = nn_sweep(a, b)
    want = nn_sweep_reference(a, b)
    err_main = max(float((got[0] - want[0]).abs().max()),
                   float((got[2] - want[2]).abs().max()))
    err["nn_sweep"] = max(err["nn_sweep"], err_main)
    if err_main > 1e-5:
        raise AssertionError(f"nn_sweep at eval shapes differs by {err_main}")
    del got, want
    torch.cuda.empty_cache()
    nn_ms = cuda_ms(lambda: nn_sweep(a, b), iters=10)
    nn_plain = cuda_ms(lambda: nn_sweep_reference(a, b), iters=3, warmup=1)

    def cdist_min():  # materialises B*N*M; timed here, never called by the port
        d = torch.cdist(a, b).square()
        return d.min(dim=2), d.min(dim=1)

    nn_lib = cuda_ms(cdist_min, iters=3, warmup=1)
    C = a.shape[-1]
    nn_bound = bound(2 * B_MAIN * P * P * 3 * C,  # C sub, C mul, C-1 add, 1 cmp
                     2 * B_MAIN * P * C * 4 + 2 * B_MAIN * P * (4 + 4),
                     PEAK_FP32_FLOPS)
    log(f"  nn_sweep kernel {nn_ms:.3f} ms | plain version {nn_plain:.3f} ms | "
        f"library cdist().square() + min both ways {nn_lib:.3f} ms | bound "
        f"{nn_bound[0]:.3f} ms ({nn_bound[1]})")
    with torch.inference_mode():
        xn = spec.in_transform(x)[0]
        h = spec.model.encoder(xn)
        enc_ms = cuda_ms(lambda: spec.model.encoder(xn), iters=5)
        dec_ms = cuda_ms(lambda: spec.model.decoder(h), iters=5)
        one = spec.in_transform(x_raw[:1])[0]
        lat = []
        for _ in range(25):
            t1 = time.perf_counter()
            spec.model.encode(one)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
    lat = sorted(lat[5:])
    log(f"  eval step parts at B={B_MAIN}: encoder {enc_ms:.3f} ms, decoder "
        f"{dec_ms:.3f} ms, Chamfer kernel {nn_ms:.3f} ms; whole step "
        f"{ms_iter:.3f} ms")
    log(f"  encode(1 cloud) latency, host clock, {len(lat)} calls: median "
        f"{lat[len(lat) // 2]:.3f} ms, max {lat[-1]:.3f} ms")
    del spec, step, out, y, a, b, x, h, xn
    torch.cuda.empty_cache()

    # ---- 4. train path at full width ----
    log(f"[train path] make_train_step, B={B_TRAIN} x {P} x 6, bf16, Adam "
        f"lr {cfg.vision_lr}")
    spec = create_model("Autoencoder", "PointNet", "Cube",
                        loss_override="chamfer", device=dev, seed=args.seed)
    opt = make_optimizer(spec)
    tstep = make_train_step(spec, opt)
    xt = x_raw[:B_TRAIN].contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_first = time.perf_counter()
    first_loss, _ = tstep(xt, xt)
    torch.cuda.synchronize()
    train_first_s = time.perf_counter() - t_first
    zero_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_ITERS + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for k in range(TRAIN_ITERS):
        loss, _ = tstep(xt, xt)  # chained: each step reads the last's weights
        losses.append(loss)
        events[k + 1].record()
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_counts = read_counts()
    expect_counts("train path", train_counts, {
        "nn_sweep": TRAIN_ITERS, "scatter_rows": 0, "chamfer_bwd": TRAIN_ITERS,
        "dense_pool_stats": 3 * TRAIN_ITERS,
        "dense_pool_stats_bwd": 3 * TRAIN_ITERS})
    losses = [float(v) for v in losses]
    per_iter = sorted(events[k].elapsed_time(events[k + 1])
                      for k in range(TRAIN_ITERS))
    ms_train = train_wall / TRAIN_ITERS * 1e3
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  train step B={B_TRAIN}: warm-up step {train_first_s:.3f} s; "
        f"{TRAIN_ITERS} chained steps {ms_train:.3f} ms/step on the host clock "
        f"-> {B_TRAIN / (ms_train / 1e3):.1f} clouds/s; event-to-event median "
        f"{per_iter[TRAIN_ITERS // 2]:.3f} ms (min {per_iter[0]:.3f}, max "
        f"{per_iter[-1]:.3f}); peak memory {train_peak:.2f} GiB | {smi}")
    log(f"  losses: warm-up {float(first_loss):.6f}, then "
        f"{', '.join(f'{v:.6f}' for v in losses)}; launches {train_counts}")
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite train loss {losses}")
    if not losses[-1] < float(first_loss):
        raise AssertionError("the train loss did not fall over the steps")

    # the step's parts, with CUDA events around the same calls as the step
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = []
    for _ in range(3):
        ev[0].record()
        xn, _ = spec.in_transform(xt)
        yn, _ = spec.out_transform(xt)
        tl = spec.loss(spec.model(xn, train=True), yn)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        tl.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd_ms, bwd_ms, opt_ms = (sorted(p[i] for p in parts)[1] for i in range(3))
    log(f"  train step parts (median of 3, CUDA events): forward + loss "
        f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, Adam {opt_ms:.3f} ms")

    # yardsticks at the train step's shapes: the trunk's dbnpool2 input
    feats = {}
    hook = spec.model.encoder.backbone.dbnpool2.register_forward_pre_hook(
        lambda m, inp: feats.__setitem__("x", inp[0].detach()))
    with torch.no_grad():
        spec.model(spec.in_transform(xt)[0], train=True)
    hook.remove()
    layer = spec.model.encoder.backbone.dbnpool2
    dx_in = feats["x"].to(torch.bfloat16).contiguous()  # (B, 2048, 128)
    dw_in = layer.weight.detach().t().to(torch.bfloat16).contiguous()
    db_in = layer.bias.detach().to(torch.bfloat16)
    ds_in = torch.where(layer.scale >= 0, 1.0, -1.0).float().detach()
    Bt, Rt, Cin = dx_in.shape
    Cd = dw_in.shape[1]
    e_fwd, e_bwd, fwd_out = compare_dense_pool(gen, dx_in, dw_in, db_in, ds_in,
                                               None, Rt)
    err["dense_pool_stats"] = max(err["dense_pool_stats"], e_fwd)
    err["dense_pool_stats_bwd"] = max(err["dense_pool_stats_bwd"], e_bwd)
    torch.cuda.empty_cache()
    d_ms = cuda_ms(lambda: dense_pool_stats(dx_in, dw_in, db_in, ds_in, None, Rt),
                   iters=10)
    d_plain = cuda_ms(lambda: dense_pool_stats_reference(
        dx_in, dw_in, db_in, ds_in, None, Rt), iters=3, warmup=1)

    def dense_library():  # stores z; timed here, never called by the port
        z = torch.matmul(dx_in, dw_in) + db_in
        zmin, zmax = torch.aminmax(z, dim=1)
        zf = z.float()
        return zmin, zmax, zf.sum(dim=(0, 1)), (zf * zf).sum(dim=(0, 1))

    d_lib = cuda_ms(dense_library, iters=3, warmup=1)
    flops = 2 * Bt * Rt * Cin * Cd
    d_bound = bound(flops, (Bt * Rt * Cin + Cin * Cd + Cd) * 2
                    + Bt * Cd * (2 + 4) + 2 * Cd * 4, PEAK_BF16_FLOPS)
    g_ps = torch.randn(fwd_out[0].shape, generator=gen, device=dev)
    g_s = torch.randn((Cd,), generator=gen, device=dev) / (Bt * Rt)
    b_ms = cuda_ms(lambda: dense_pool_stats_bwd(
        dx_in, dw_in, db_in, ds_in, fwd_out[1], g_ps, g_s, g_s, Rt), iters=5)
    xl = dx_in.detach().clone().requires_grad_()
    wl = dw_in.detach().clone().requires_grad_()
    bl = db_in.detach().clone().requires_grad_()

    def dense_plain_bwd():
        o = dense_pool_stats_reference(xl, wl, bl, ds_in, None, Rt)
        return torch.autograd.grad((o[0], o[2], o[3]), (xl, wl, bl),
                                   (g_ps.to(o[0].dtype), g_s, g_s))

    def dense_library_bwd():  # autograd through the composition that stores z
        z = torch.matmul(xl, wl) + bl
        zmax = torch.amax(z, dim=1)
        zf = z.float()
        return torch.autograd.grad(
            (zmax, zf.sum(dim=(0, 1)), (zf * zf).sum(dim=(0, 1))), (xl, wl, bl),
            (g_ps[:, 0].to(zmax.dtype), g_s, g_s))

    b_plain = cuda_ms(dense_plain_bwd, iters=2, warmup=1)
    b_lib = cuda_ms(dense_library_bwd, iters=2, warmup=1)
    b_bound = bound(3 * flops, (2 * Bt * Rt * Cin + Cin * Cd + Cd) * 2
                    + Bt * Cd * (4 + 4) + Cin * Cd * 4 + 3 * Cd * 4,
                    PEAK_BF16_FLOPS)
    log(f"  dense_pool_stats fwd B={Bt} R={Rt} Cin={Cin} C={Cd} bf16: kernel "
        f"{d_ms:.3f} ms | plain {d_plain:.3f} ms | library matmul + aminmax + "
        f"sums {d_lib:.3f} ms | bound {d_bound[0]:.3f} ms ({d_bound[1]})")
    log(f"  dense_pool_stats bwd: kernel {b_ms:.3f} ms | plain (autograd) "
        f"{b_plain:.3f} ms | library (autograd through matmul + amax + sums) "
        f"{b_lib:.3f} ms | bound {b_bound[0]:.3f} ms ({b_bound[1]})")
    del xl, wl, bl, feats
    torch.cuda.empty_cache()

    # chamfer_bwd and both backward routes at the train step's shapes
    cargs = nn_inputs(gen, B_TRAIN, P, P, 6, masked=False)
    err["chamfer_bwd"] = max(err["chamfer_bwd"],
                             compare_chamfer_bwd(cargs, "train shape"))
    c_ms = cuda_ms(lambda: chamfer_bwd(*cargs), iters=10)
    c_plain = cuda_ms(lambda: chamfer_bwd_reference(*cargs), iters=5)
    cx, cy, cgx, cgy, cax, cay = cargs

    def chamfer_library():  # gathers + index_add_ (atomics on the card)
        tx = 2.0 * cgx[..., None] * (cx - gather_rows(cy, cax))
        ty = 2.0 * cgy[..., None] * (cy - gather_rows(cx, cay))
        off = torch.arange(B_TRAIN, device=dev)[:, None] * P
        dx = tx.reshape(-1, 6).index_add_(0, (cay + off).reshape(-1),
                                          -ty.reshape(-1, 6))
        dy = ty.reshape(-1, 6).index_add_(0, (cax + off).reshape(-1),
                                          -tx.reshape(-1, 6))
        return dx, dy

    c_lib = cuda_ms(chamfer_library, iters=5)
    seg_route = cuda_ms(lambda: nn_grads_segment_sum(*cargs), iters=5)
    c_bound = bound(2 * B_TRAIN * P * 6 * 6,
                    2 * B_TRAIN * P * (6 * 4 + 4 + 4) + 2 * B_TRAIN * P * 6 * 4,
                    PEAK_FP32_FLOPS)
    log(f"  chamfer_bwd B={B_TRAIN} N=M={P} C=6: kernel {c_ms:.3f} ms | plain "
        f"{c_plain:.3f} ms | library gathers + index_add_ {c_lib:.3f} ms | "
        f"bound {c_bound[0]:.4f} ms ({c_bound[1]})")
    log(f"  Chamfer backward routes at B={B_TRAIN}, {P}x{P} ({P * P} cost "
        f"elements per cloud, switch at {6 << 20}): fused chamfer_bwd "
        f"{c_ms:.3f} ms vs gathers + 2 scatter_rows {seg_route:.3f} ms")
    del cargs, cx, cy, cgx, cgy, cax, cay, spec, opt, tstep
    torch.cuda.empty_cache()

    # ---- 5. the segment-sum route ----
    log(f"[segment-sum route] chamfer_distance(x, y).backward() at B={B_ROUTE}, "
        f"N=M={P_ROUTE}, C=6")
    rx = torch.rand((B_ROUTE, P_ROUTE, 6), generator=gen, device=dev)
    ry = torch.rand((B_ROUTE, P_ROUTE, 6), generator=gen, device=dev)
    xg = rx.clone().requires_grad_()
    yg = ry.clone().requires_grad_()
    zero_counts()
    chamfer_distance(xg, yg).backward()
    torch.cuda.synchronize()
    route_counts = read_counts()
    expect_counts("segment-sum route", route_counts, {
        "nn_sweep": 1, "scatter_rows": 2, "chamfer_bwd": 0,
        "dense_pool_stats": 0, "dense_pool_stats_bwd": 0})
    xc = rx.cpu().requires_grad_()
    yc = ry.cpu().requires_grad_()
    chamfer_distance(xc, yc).backward()
    e_route = max(rel_err(xg.grad.cpu(), xc.grad), rel_err(yg.grad.cpu(), yc.grad))
    log(f"  launches {route_counts}; gradients vs the CPU's plain route: rel "
        f"err {e_route:.2e}")
    if e_route > 1e-4:
        raise AssertionError("segment-sum route gradients differ from the CPU")
    sargs = nn_inputs(gen, B_ROUTE, P_ROUTE, P_ROUTE, 6, masked=False)
    tx_r = 2.0 * sargs[2][..., None] * (sargs[0] - gather_rows(sargs[1], sargs[4]))
    ty_r = 2.0 * sargs[3][..., None] * (sargs[1] - gather_rows(sargs[0], sargs[5]))
    s_ms = cuda_ms(lambda: scatter_rows(-ty_r, sargs[5], P_ROUTE, init=tx_r),
                   iters=10)
    s_plain = cuda_ms(lambda: scatter_rows_reference(-ty_r, sargs[5], P_ROUTE,
                                                     init=tx_r), iters=10)
    s_off = (sargs[5].long() + torch.arange(B_ROUTE, device=dev)[:, None]
             * P_ROUTE).reshape(-1)
    s_src = (-ty_r).reshape(-1, 6)
    s_init = tx_r.reshape(-1, 6)
    s_lib = cuda_ms(lambda: s_init.clone().index_add_(0, s_off, s_src), iters=10)
    s_bound = bound(B_ROUTE * P_ROUTE * 6,
                    B_ROUTE * P_ROUTE * (6 * 4 + 4) + 2 * B_ROUTE * P_ROUTE * 6 * 4,
                    PEAK_FP32_FLOPS)
    log(f"  scatter_rows B={B_ROUTE} R=n={P_ROUTE} C=6 with init: kernel "
        f"{s_ms:.3f} ms | plain {s_plain:.3f} ms | library index_add_ "
        f"{s_lib:.3f} ms | bound {s_bound[0]:.4f} ms ({s_bound[1]})")
    fused_big = cuda_ms(lambda: chamfer_bwd(*sargs), iters=10)
    seg_big = cuda_ms(lambda: nn_grads_segment_sum(*sargs), iters=10)
    log(f"  Chamfer backward routes at B={B_ROUTE}, {P_ROUTE}x{P_ROUTE} "
        f"({P_ROUTE * P_ROUTE} cost elements per cloud): fused chamfer_bwd "
        f"{fused_big:.3f} ms vs gathers + 2 scatter_rows {seg_big:.3f} ms")

    # ---- 6. fp32 model on the card vs the CPU ----
    log("[card vs CPU]")
    cfg.precision = "fp32"
    try:
        ref_gpu = create_model("Autoencoder", "PointNet", "Cube",
                               loss_override="chamfer", device=dev,
                               seed=args.seed)
        ref_cpu = create_model("Autoencoder", "PointNet", "Cube",
                               loss_override="chamfer", device="cpu",
                               seed=args.seed)
    finally:
        cfg.precision = "bf16-mixed"
    bf = create_model("Autoencoder", "PointNet", "Cube",
                      loss_override="chamfer", device=dev, seed=args.seed)
    xs = x_raw[:2]
    l_gpu, _, o_gpu = make_eval_step(ref_gpu)(xs, xs)
    l_cpu, _, o_cpu = make_eval_step(ref_cpu)(xs.cpu(), xs.cpu())
    l_bf, _, o_bf = make_eval_step(bf)(xs, xs)
    e_out = float((o_gpu.cpu() - o_cpu).abs().max())
    e_loss = abs(float(l_gpu) - float(l_cpu))
    bf_out = float((o_bf - o_gpu).abs().max())
    bf_loss = abs(float(l_bf) - float(l_gpu)) / float(l_gpu)
    log(f"  fp32 eval step, card vs CPU, B=2: max |out err| {e_out:.2e}, "
        f"|loss err| {e_loss:.2e}; bf16 model vs fp32 on the card: max "
        f"|out diff| {bf_out:.2e}, loss rel diff {bf_loss:.2e}")
    if e_out > 1e-4 or e_loss > 1e-5:
        raise AssertionError("fp32 model on the card disagrees with the CPU")
    if bf_loss > 0.05:
        raise AssertionError("bf16 model's loss is > 5% off the fp32 model's")
    del ref_gpu, ref_cpu
    fp32_first = card_vs_cpu_train(args.seed, x_raw)
    card_vs_cpu_heads(args.seed)
    bf_spec = create_model("Autoencoder", "PointNet", "Cube",
                           loss_override="chamfer", device=dev, seed=args.seed)
    xs1 = x_raw[:1].repeat(2, 1, 1)
    bf_first = float(make_train_step(bf_spec, make_optimizer(bf_spec))(xs1, xs1)[0])
    bf_train = abs(bf_first - fp32_first) / fp32_first
    log(f"  bf16 first train-step loss {bf_first:.6f} vs fp32 {fp32_first:.6f}: "
        f"rel diff {bf_train:.2e}")
    if bf_train > 0.05:
        raise AssertionError("bf16 first train-step loss > 5% off the fp32 one")

    def entry(name, source, replaces, launches, ms, plain_ms, bnd, library_ms):
        return {"name": name, "route": "cuda",
                "source": f"pointcloud_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}

    kernels = [
        entry("nn_sweep", "nn_sweep.cu", "pointcloud_tpu/ops/pallas_kernels.py:236",
              eval_counts["nn_sweep"], nn_ms, nn_plain, nn_bound, nn_lib),
        entry("chamfer_bwd", "chamfer_bwd.cu",
              "pointcloud_tpu/ops/pallas_kernels.py:430",
              train_counts["chamfer_bwd"], c_ms, c_plain, c_bound, c_lib),
        entry("scatter_rows", "scatter_rows.cu",
              "pointcloud_tpu/ops/pallas_kernels.py:767",
              route_counts["scatter_rows"], s_ms, s_plain, s_bound, s_lib),
        entry("dense_pool_stats", "dense_bn_pool.cu",
              "pointcloud_tpu/ops/dense_bn_pool.py:87",
              train_counts["dense_pool_stats"], d_ms, d_plain, d_bound, d_lib),
        entry("dense_pool_stats_bwd", "dense_bn_pool.cu",
              "pointcloud_tpu/ops/dense_bn_pool.py:162",
              train_counts["dense_pool_stats_bwd"], b_ms, b_plain, b_bound, b_lib),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
