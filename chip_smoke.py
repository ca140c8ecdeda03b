#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (pointcloud_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases; any failure raises and the script exits non-zero without its result
lines:
  1. build every kernel in pointcloud_tpu_torch/csrc/ (one nvcc each, in
     parallel) into build/, or reuse the build;
  2. hold each kernel against its plain PyTorch version on the card, with
     masks, fully masked rows and exact ties;
  3. drive the main path at full width: create_model("Autoencoder",
     "PointNet", "Cube", loss_override="chamfer") and its eval step at
     B=512 x 2048 points x 6 dims (bf16 activations), plus `encode` on one
     cloud as the RL observation encoder calls it; the kernels' launch counts
     are zeroed just before and read just after;
  4. check the outputs: finite values of the right shapes, the kernel-path
     loss vs the plain version's, and the fp32 model on the card vs the same
     model on the CPU on a small input;
  5. time each kernel at the main path's shapes and inputs beside its plain
     version, a library yardstick and its bound; time the eval step's parts.
The last three lines of standard output are nvidia-smi's name and power
limit, the `kernels` JSON object and the `ok` JSON object. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores and
# HBM3 bandwidth. Bounds are stated against these, beside the power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

B_MAIN = 512  # bench.py's eval batch
ITERS = 20  # chained eval steps after the first


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
        chamfer_distance,
        nn_sweep,
        nn_sweep_reference,
    )
    from pointcloud_tpu_torch.train import create_model, make_eval_step

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
    max_err = max(check_nn_sweep(gen, 8, 2048, 2048, 3),
                  check_nn_sweep(gen, 8, 2048, 2048, 6),
                  check_nn_sweep(gen, 3, 1000, 2500, 8))

    # ---- 3. main path at full width ----
    log("[main path] Autoencoder / PointNet / Chamfer, scene Cube")
    spec = create_model("Autoencoder", "PointNet", "Cube",
                        loss_override="chamfer", device=dev, seed=args.seed)
    step = make_eval_step(spec)
    sc = spec.scene
    P = sc.sample_points
    bbox = torch.tensor(sc.bbox, dtype=torch.float32, device=dev)
    x_raw = torch.cat([
        bbox[:, 0] + torch.rand((B_MAIN, P, 3), generator=gen, device=dev)
        * (bbox[:, 1] - bbox[:, 0]),
        torch.rand((B_MAIN, P, 3), generator=gen, device=dev),
    ], dim=-1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    nn_sweep.launches = 0  # counted from here to the end of the main path
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
    launches = {"nn_sweep": nn_sweep.launches}

    per_iter = sorted(events[k].elapsed_time(events[k + 1]) for k in range(ITERS))
    ms_iter = wall / ITERS * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  eval step B={B_MAIN}: first call {first_s:.3f} s; {ITERS} chained "
        f"steps {ms_iter:.3f} ms/step on the host clock -> "
        f"{B_MAIN / (ms_iter / 1e3):.1f} clouds/s; event-to-event median "
        f"{per_iter[ITERS // 2]:.3f} ms (min {per_iter[0]:.3f}, max "
        f"{per_iter[-1]:.3f}); peak memory {peak_gib:.2f} GiB | {smi}")
    log(f"  encode(1 cloud) -> {tuple(enc.shape)} {enc.dtype}; launches "
        f"{launches}")

    # ---- 4. the outputs are right ----
    if not bool(torch.isfinite(loss)) or not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"non-finite loss {loss} or encoding")
    if out.shape != (B_MAIN, P, 6) or enc.shape != (1, sum(sc.class_latent_dim)):
        raise AssertionError(f"shapes {tuple(out.shape)}, {tuple(enc.shape)}")
    if launches["nn_sweep"] != ITERS + 1:
        raise AssertionError(
            f"nn_sweep launched {launches['nn_sweep']} times on the main path;"
            f" expected one per eval step ({ITERS + 1})")
    y = spec.out_transform(x)[0]  # the last step's target
    with torch.inference_mode():
        kern8 = float(chamfer_distance(out[:8], y[:8]))
        plain8 = float(chamfer_distance(out[:8].cpu(), y[:8].cpu()))
    log(f"  loss {float(loss):.6f}; first 8 clouds: kernel path {kern8:.7f}, "
        f"plain version (CPU) {plain8:.7f}, |diff| {abs(kern8 - plain8):.2e}")
    if abs(kern8 - plain8) > 1e-4:
        raise AssertionError("kernel-path loss disagrees with the plain version")

    # the same fp32 model on the card and on the CPU, on a small input; and
    # how far the bf16 production model sits from it
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
    xs = x_raw[:2]
    l_gpu, _, o_gpu = make_eval_step(ref_gpu)(xs, xs)
    l_cpu, _, o_cpu = make_eval_step(ref_cpu)(xs.cpu(), xs.cpu())
    l_bf, _, o_bf = step(xs, xs)
    e_out = float((o_gpu.cpu() - o_cpu).abs().max())
    e_loss = abs(float(l_gpu) - float(l_cpu))
    bf_out = float((o_bf - o_gpu).abs().max())
    bf_loss = abs(float(l_bf) - float(l_gpu)) / float(l_gpu)
    log(f"  fp32 model, card vs CPU, B=2: max |out err| {e_out:.2e}, "
        f"|loss err| {e_loss:.2e}; bf16 model vs fp32 on the card: max "
        f"|out diff| {bf_out:.2e}, loss rel diff {bf_loss:.2e}")
    if e_out > 1e-4 or e_loss > 1e-5:
        raise AssertionError("fp32 model on the card disagrees with the CPU")
    if bf_loss > 0.05:
        raise AssertionError("bf16 model's loss is > 5% off the fp32 model's")
    del ref_gpu, ref_cpu

    # ---- 5. yardsticks at the main path's shapes and inputs ----
    log(f"[yardsticks] B={B_MAIN}, N=M={P}, C=6: the last eval step's output "
        f"and target | {smi}")
    a, b = out, y
    got = nn_sweep(a, b)
    want = nn_sweep_reference(a, b)
    err_main = max(float((got[0] - want[0]).abs().max()),
                   float((got[2] - want[2]).abs().max()))
    max_err = max(max_err, err_main)
    if err_main > 1e-5:
        raise AssertionError(f"nn_sweep at eval shapes differs by {err_main}")
    del got, want
    torch.cuda.empty_cache()
    k_ms = cuda_ms(lambda: nn_sweep(a, b), iters=10)
    p_ms = cuda_ms(lambda: nn_sweep_reference(a, b), iters=3, warmup=1)

    def library():  # materialises B*N*M; timed here, never called by the port
        d = torch.cdist(a, b).square()
        return d.min(dim=2), d.min(dim=1)

    l_ms = cuda_ms(library, iters=3, warmup=1)
    C = a.shape[-1]
    ops = 2 * B_MAIN * P * P * 3 * C  # per pair: C sub, C mul, C-1 add, 1 cmp
    nbytes = 2 * B_MAIN * P * C * 4 + 2 * B_MAIN * P * (4 + 4)
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"  nn_sweep kernel {k_ms:.3f} ms | plain version {p_ms:.3f} ms | "
        f"library cdist().square() + min both ways (materialises B*N*M) "
        f"{l_ms:.3f} ms | bound {bound_ms:.3f} ms ({ops:.3e} fp32 ops, "
        f"{nbytes / 1e6:.1f} MB) = {bound_ms / k_ms:.1%} of the kernel's time")

    with torch.inference_mode():
        xn = spec.in_transform(x)[0]
        h = spec.model.encoder(xn)
        enc_ms = cuda_ms(lambda: spec.model.encoder(xn), iters=5)
        dec_ms = cuda_ms(lambda: spec.model.decoder(h), iters=5)
        # the RL observation encoder's call: one cloud, synchronised
        one = spec.in_transform(x_raw[:1])[0]
        lat = []
        for _ in range(25):
            t1 = time.perf_counter()
            spec.model.encode(one)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
    lat = sorted(lat[5:])
    log(f"  eval step parts at B={B_MAIN}: encoder {enc_ms:.3f} ms, decoder "
        f"{dec_ms:.3f} ms, Chamfer kernel {k_ms:.3f} ms; whole step "
        f"{ms_iter:.3f} ms")
    log(f"  encode(1 cloud) latency, host clock, {len(lat)} calls: median "
        f"{lat[len(lat) // 2]:.3f} ms, max {lat[-1]:.3f} ms")

    kernels = [{
        "name": "nn_sweep",
        "route": "cuda",
        "source": "pointcloud_tpu_torch/csrc/nn_sweep.cu",
        "replaces": "pointcloud_tpu/ops/pallas_kernels.py:236",
        "launches": launches["nn_sweep"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": l_ms,
    }]
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
