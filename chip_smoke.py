#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (pointcloud_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --kernel-times --step-times  # kernels and steps alone
    python3 chip_smoke.py --train-loop  # the training loop (phase 15) alone
    python3 chip_smoke.py --heads  # the MultiSegmenter and StatePredictor (16) alone
    python3 chip_smoke.py --bridge  # the Vision GoalEnvs (17) alone

Phases; any failure raises and the script exits non-zero without its result
lines:
  1. build every kernel in pointcloud_tpu_torch/csrc/ (one nvcc each, in
     parallel) into build/, or reuse the build; print the registers and
     spills of the chain's forward and backward kernels, fps's block and
     cluster kernels, nn_sweep's wgmma kernel (and its wgmma serialization
     warnings), the dense-pool forward's and backward's TMA + wgmma kernels
     and the Sinkhorn sweep (ptxas -v), the instructions the sweep's main
     loop issues a pair and those of a step of fps's block kernel
     (cuobjdump -sass), and the registers and spills of every knn_group and
     group_gather kernel;
  2. hold each kernel against its plain PyTorch version on the card (masks,
     fully masked rows, exact ties, bf16 and fp32; scatter_rows at the
     route's shape and at SA2's odd width with one target holding a third
     of the rows (long buckets summed in pieces); for fps and ball_group
     equal indices, empty balls, k not a multiple of 8, the shared-memory
     and global paths (ball_group at 15,000 points), and fps's cluster route at the sensor's shape with
     ties between blocks and at a ragged N; nn_sweep at C = 1, 3, 6, 7, 8,
     with several target chunks and a ragged 2049 x 31 pair; for the four passes of the
     Dense-BN-ReLU-pool chain depths 6 / 131 / 259, ragged widths (bf16
     widths that are no multiple of 8 take the tile kernel, the rest TMA +
     wgmma), pools of 4 / 32 / 128, a fully
     masked group, planted ties, final_relu both ways, and each stage of
     the backward pass (dh, da, dw) against its plain stage; ball_group's
     gradient; for the Sinkhorn matching N != M, N not a multiple of 64,
     6-dim inputs, identical clouds, constant and annealed eps, one
     iteration; knn_group and group_gather at both sides of every route
     boundary of their plans: the list capacity k = 32 / 33 / 64 / 65, the
     largest cloud each plan stages in shared memory and one point more,
     feature rows of 2, 6, 66 and 640 bytes, a feature base 2 bytes past a
     16-byte boundary, S not a multiple of a block's centroids, exact ties,
     masks, a fully masked cloud, an empty ball, with_xyz both ways; the
     ball groupings past their shared slots, the slots in the idx output:
     ball_group at k = 781 and 1,024, group_gather at k = 1,807 and 2,048,
     a k above N and the global route each; chamfer_bwd on a collapsed y
     cloud (one bucket of every row, summed in pieces) and at B=4 x 4096,
     one launch, bit-equal to its order of sums on the CPU; bn_pool alone at
     every driven level and stage, the residual modes and widths that are no
     multiple of 8, planted ties) and run each kernel twice on the same
     inputs: the results must be bit-equal;
  3. the eval path at full width: create_model("Autoencoder", "PointNet",
     "Cube", loss_override="chamfer") and its eval step at B=512 x 2048
     points x 6 dims (bf16 activations), plus `encode` on one cloud;
     nn_sweep at the step's output and target, timed, its expansion costs
     against direct differences over every pair (the largest error and the
     indices that differ from the direct argmin);
  4. the train path at full width: make_optimizer + make_train_step at
     bench.py's B=256 x 2048 x 6, bf16, one fixed batch, 1 warm-up step and
     10 chained steps; a second instance from the same seed and batch takes
     40 chained steps, the last one's loss below the warm-up step's;
  5. the Chamfer backward past the JAX package's 6<<20 switch:
     chamfer_distance(x, y).backward() at B=4, N=M=4096, C=6, one
     chamfer_bwd launch, gradients against the CPU, the kernel timed;
  6. the PointNet2 path at full width: create_model("Autoencoder",
     "PointNet2", "Cube", loss_override="chamfer") and its eval step at
     B=256 x 2048 x 6 (bf16), `encode` on one cloud, and the sensor's
     FilterBBox -> SampleFurthestPoints(2048) on one cloud of 3 cameras x
     256 x 256 points (its FPS indices card vs CPU equal; the route, the
     cluster and the time a step beside the bound); fps timed at every shape
     a driven path launches it at (PointNet2's levels at B=256, the MSG
     levels and PointMLP's stages at B=32, `encode` at B=1), a step's time
     beside the bound;
  7. check the outputs: finite values of the right shapes, the kernel-path
     loss vs the plain version's, and the fp32 models' eval steps (PointNet
     and PointNet2) and train steps (PointNet and PointNet2; the first
     step's nn_sweep indices against direct differences logged), and the
     STN heads in train mode on distinct clouds, on the card vs on the CPU;
  8. the PointNet2 train path at full width: make_optimizer +
     make_train_step for the PointNet2 autoencoder at B=256 x 2048 x 6,
     bf16, one fixed batch, 1 warm-up step and 10 chained steps, with the
     launch counts of a step asserted exactly; SA2's grouping gradient
     (scatter_rows) at one more step's own inputs, held and timed;
  9. the Earth Mover's Distance paths at full width: create_model(
     "Autoencoder", "PointNet", "Cube") with its default EMD loss, eval and
     train steps at B=128 x 2048 x 6 (bf16); create_model("Segmenter",
     "PointNet", "Cube"), an eval step and train steps at B=64 (target xyz + a
     class label); the PointNet2 autoencoder and segmenter with EMD, one eval
     and one train step each at B=64; the Sinkhorn kernel at the B=128 path's own inputs at the
     training and the eval operating point, and dense_pool_stats at the
     B=128 train path's own input; the fp32 EMD train step card vs CPU;
     launch counts of a step asserted exactly;
 10. the PointMLP eval paths at full width: knn_group against its plain
     version (k of 1, 5, 24, 32, ragged N, masked and under-full clouds, no
     features, fp32 and bf16, with and without xyz, every stage's shape of
     the B=32 path; two runs bit-equal) and its gradient; make_eval_step at
     B=32 x 2048 x 6 (bench.py's PointMLP batch, bf16) for PointMLP with
     Chamfer and PointMLP-Elite with its default EMD loss, 20 chained steps
     with exact launch counts, the stage-by-stage encoder time and `encode`
     on one cloud; knn_group at all four stages of both configurations' own
     inputs, held and timed (CUDA events over launches through the C
     entry); one eval step of the
     Segmenter on PointMLP-Elite at B=8;
     the fp32 models card vs CPU at B=2 (equal FPS and kNN indices at every
     stage);
 11. the PointMLP train paths at full width: the residual mode of the four
     chain passes against their plain versions (mid width 16, a pool of 24
     over rows that are not a multiple of 64, one to three blocks, width
     1024, fp32 and bf16, planted ties; two runs bit-equal); make_optimizer
     + make_train_step at B=32 x 2048 x 6, bf16, for PointMLP with Chamfer
     and PointMLP-Elite with its default EMD loss, a warm-up step and 5
     chained steps with exact launch counts, the step's parts and a trace,
     every stage's residual chain held against its plain versions at that
     batch's own inputs and both configurations' stages timed (the
     products' bf16 route asserted TMA + wgmma on every driven path);
     PointMLP's four grouping gradients (scatter_rows) at one more step's
     own inputs, held and timed; one train step of the
     Segmenter on PointMLP-Elite at B=8; the fp32 PointMLP train step card
     vs CPU at B=2 (equal FPS and kNN indices, first loss and update);
 12. the multi-scale-grouping PointNet2 kernel: group_gather (the legacy
     grouping's ball mode) against its plain version (fp32 and bf16, masks
     and a fully masked cloud, no features, k above the in-ball count and
     above N, an empty ball, the global-memory path, with and without xyz;
     two runs bit-equal) and its gradient;
 13. the MSG autoencoder (PointNet2MSGEncoder, Chamfer, B=32 x 2048 x 6,
     bf16): make_eval_step, 20 chained steps with exact launch counts, a
     trace, the level-by-level time, `encode`; fps at both levels, nn_sweep
     on the step's output and group_gather at its six branches of that
     batch against their plain versions, group_gather timed (CUDA events
     over launches through the C entry); then
     make_optimizer + make_train_step, a warm-up step and 10 chained steps
     with exact launch counts, the step's parts, a trace, and, at one more
     step's own inputs, against their plain versions: dense_pool_stats at
     the six branches' last layers (pools 16 to 128; the backward's dx and
     dw kernels' device times from a trace, beside the library and the
     bound), the
     four chain passes
     of the group-all level (643 -> 256 -> 512 -> 1024, pool 128), level 2's
     three scatter_rows and chamfer_bwd, each timed;
 14. the fp32 MSG autoencoder card vs CPU at B=2 x 1024 points: FPS and
     every branch's idx and valid equal, the eval step, the first train
     step's loss, gradients and update;
 15. the training loop: npz frames written with numpy (100 train, 30 val,
     2048 points in the Cube bbox, rgb and a class label) into a temporary
     directory under build/; the native loader's batches/s alone; train(
     "Autoencoder", "PointNet2", "Cube") at B=25 (EMD, the CLI's default)
     for 2 epochs, resumed from step_1 for a third, and 1 epoch with
     loss_override="chamfer" and profile=True: every optimizer step's
     launches equal one make_train_step call's alone and every epoch's
     validation (batches of 25 and a ragged 5) the eval steps' alone,
     finite losses, the version directories and checkpoints (Adam's step
     carried over), the writer and the trace; create_model(load_dir=...,
     encoder_only=True) + `encode` on one cloud; the loop's clouds/s beside
     the same step chained on one batch, and a checkpoint written alone;
 16. the MultiSegmenter and the StatePredictor: create_model(
     "MultiSegmenter" | "StatePredictor", "PointNet", "Cube") at B=64 x 2048
     x 6 (benchmarks/config_step_bench.py's batch), bf16: the eval step and
     the train step, a warm-up and 10 chained steps each, exact launch counts
     (the MultiSegmenter's segmenting Chamfer one nn_sweep forward and one
     chamfer_bwd backward over its (3 x 64, 820, 3) stack; the
     StatePredictor no Chamfer kernel), falling losses, a trace; nn_sweep and
     chamfer_bwd at that step's own inputs and on a batch where one cloud
     lacks the cube and one the gripper (~1e10 in the loss, held against
     the plain version relative to its size), held and timed; one eval and
     one train step of the PointNet2 MultiSegmenter with exact counts;
     MLPChainPool's four chain passes with one group of N rows a cloud
     (pool = 2048 and a ragged 2000, a fully masked cloud, final_relu both
     ways, bf16 and fp32) against their plain versions, twice bit-equal, and
     the module's train step at B=64 x 2048 with exact counts; the fp32
     models card vs CPU at B=2 (eval outputs, first loss, gradients, first
     update); train() of each model type (PointNet2) for one epoch over
     phase 15's frames (which carry `ground_truth` pairs), launches checked
     step by step, then an encoder_only load and `encode`;
 17. the sensor -> encoder -> GoalEnv bridge on the synthetic backend:
     random PointNet2 checkpoints in the port's format (Autoencoder on
     Table; Segmenter, MultiSegmenter, StatePredictor on Cube; StatePredictor
     on PegInHole) in a temporary output root under build/; VisionReach,
     VisionPushSeg, VisionPush, VisionPushGT and VisionPegInHole built from
     the env classes on the card (no gymnasium there: the stand-ins of
     envs/spaces.py), reset and 20 steps each at full width (the sensor's
     FilterBBox + fps from 16,384 raw points to 2,048, the encoder's SA1 and
     SA2), bf16: exact fps / ball_group launches at reset and every step,
     every sensed cloud bit-equal to the plain chain on the card, the step's
     host time split into sensor, encode and the rest, the encoders rebuilt
     at fp32 card vs CPU (1e-4 of the largest entry); the sensor chain and
     fps alone at that shape, timed beside the plain version and the bound;
     generate_dataset (20 frames, frames/s) and generate_pc (3 frames) equal
     to the CPU's; one short latent_distributions run of VisionReach's
     encoder and its threshold read back by a new env.
Within phases 3-6 and 8-13 each kernel is held against its plain version again
at its path's shapes and inputs, then timed there beside its plain version,
a library yardstick and its bound (the dense-pool backward at phase 4's
shape also as its dx and dw kernels' device times from a trace), with
both Chamfer backward
routes at the train step's shapes, the parts of each step and a
torch.profiler trace of
each train step and of the EMD eval step (device time by kernel, busy and
idle share, beside the host's enqueue time; the dense-pool forward's and
`sinkhorn`'s device time a step read from it). For each path
(3, 4, 5, 6, 8, the four of 9, the three of 10, the three of 11, the two of
13, encode, the sensor chain, each train() run of 15 and 16, step by step,
the paths of 16, and each env reset and step of 17)
every kernel's launch count is set
to 0 just before and read just after. The last three lines of standard output are
nvidia-smi's name and power limit, the `kernels` JSON object and the `ok`
JSON object. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
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
# phase 4's chained steps: Adam's first updates raise the loss to 2.2-4.2x
# the warm-up loss, and at the tenth step it lies on either side of the
# warm-up loss across seeds and equally exact orders of the dense-pool
# backward's dw sums; by the fortieth it lies 12-22% below it in every case
# tried (`--loss-spread 40 --seeds 0 1 2 3`, three orders each)
PN_TRAIN_ITERS = 40
B_ROUTE, P_ROUTE = 4, 4096  # 16.8M cost elements a cloud: past the JAX package's switch
B_PN2 = 256  # bench.py's PointNet2 batch
B_EMD = 128  # the AE + EMD train batch of benchmarks/config_step_bench.py
B_SEG = 64  # its Segmenter batch; also the PointNet2 + EMD batch here
# fp32 instructions a second: 128 lanes an SM issue one each a clock, and
# the data sheet's fp32 rate counts an FMA as two operations
PEAK_FP32_ISSUE = PEAK_FP32_FLOPS / 2
# ex2 on the special-function units: 16 a clock an SM against 128 fp32 lanes
# that do 2 operations each, so an eighth of half the fp32 rate
PEAK_SFU_OPS = PEAK_FP32_FLOPS / 2 / 8


_T0 = time.perf_counter()


def log(*a):
    """Print a line; a phase's header line ("[...") carries the seconds since
    the script started."""
    if a and str(a[0]).startswith("["):
        a = (f"{a[0]} (t={time.perf_counter() - _T0:.1f} s)", *a[1:])
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


# the redesigned kernels whose device time per step each trace reports:
# name -> substrings of their profiler keys
WATCH = {"dense_pool_stats fwd": ("pool_fwd_wgmma_kernel",),
         "sinkhorn": ("::sweep_kernel", "::assign_kernel")}


def trace_steps(step, x, y, untraced_ms, label, enqueue_ms=None):
    """torch.profiler trace of 3 more train steps: the 12 largest device
    kernels' times per step summed by name, and the device's
    busy time per step beside the traced step's and the untraced step's
    (`untraced_ms`) host-clock time and, where given, the host's own time
    to enqueue a step (`drive_train`): a step that runs at the host's pace
    still shows the device time it needs. The profiler slows the host, so
    the idle share is stated against both clocks. Also the device time per
    step of each WATCH kernel present, with its share of the busy time.
    Returns the busy ms and those times ({name: (ms, launches) per step})."""
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(x, y)
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = sorted(((e.device_time_total / 1e3 / steps, e.count / steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and not e.is_user_annotation),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        raise AssertionError(f"{label}: the trace holds no device time")
    log(f"  trace of {steps} steps ({label}): device busy {busy:.3f} ms/step in "
        f"{len(rows)} kernels; host clock {traced_ms:.3f} ms/step traced (idle "
        f"{100 * (1 - busy / traced_ms):.1f}%), {untraced_ms:.3f} ms/step "
        f"untraced (idle {100 * (1 - busy / untraced_ms):.1f}%)")
    if enqueue_ms is not None:
        log(f"  {label}: device busy {busy:.3f} ms/step | host enqueue "
            f"{enqueue_ms:.3f} ms/step | step {untraced_ms:.3f} ms/step")
    for ms, calls, key in rows[:12]:
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% {calls:6.1f} calls/step  "
            f"{key[:100]}")
    watched = {}
    for name, keys in WATCH.items():
        hit = [(ms, calls) for ms, calls, key in rows if any(k in key for k in keys)]
        if hit:
            watched[name] = (sum(h[0] for h in hit), sum(h[1] for h in hit))
            log(f"  {label}: {name} {watched[name][0]:.3f} ms/step device time "
                f"({100 * watched[name][0] / busy:.1f}% of busy, "
                f"{watched[name][1]:.1f} CUDA launches/step; traced)")
    return busy, watched


def bound(ops, nbytes, peak_ops):
    """(bound ms, 'operations' or 'bytes') for work of `ops` operations at
    `peak_ops` per second and `nbytes` at the HBM rate."""
    t_ops = ops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def counters():
    from pointcloud_tpu_torch.ops import (
        ball_group,
        bn_pool,
        bnact_mm_stats,
        chain_bwd_pass,
        chamfer_bwd,
        dense_pool_stats,
        dense_pool_stats_bwd,
        farthest_point_sample,
        group_gather,
        knn_group,
        mm_stats,
        nn_sweep,
        scatter_rows,
        sinkhorn,
    )
    return {"nn_sweep": nn_sweep, "scatter_rows": scatter_rows, "sinkhorn": sinkhorn,
            "chamfer_bwd": chamfer_bwd, "dense_pool_stats": dense_pool_stats,
            "dense_pool_stats_bwd": dense_pool_stats_bwd,
            "fps": farthest_point_sample, "ball_group": ball_group,
            "mm_stats": mm_stats, "bnact_mm_stats": bnact_mm_stats,
            "bn_pool": bn_pool, "chain_bwd_pass": chain_bwd_pass,
            "knn_group": knn_group, "group_gather": group_gather}


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def expect_counts(path, got, **want):
    """Fail unless each kernel launched as often as `want` says (0 for the
    kernels it leaves out)."""
    want = {name: want.get(name, 0) for name in counters()}
    if got != want:
        raise AssertionError(f"{path}: kernel launches {got}, expected {want}")


def rel_err(got, want):
    """max |got - want| over max |want|, in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def check_nn_sweep(gen, B, N, M, C, far_masked=False):
    """nn_sweep's kernel vs its plain version with ~10% of points masked, a
    batch element whose x points are all masked (element 1), one whose y
    points are all masked (element 2), and exact ties. far_masked: x point 0
    is masked and lies 1e3 out in every dimension (y point 9, valid, at 1.5,
    is its clear nearest), so the kernel's centre must not be a masked
    point. Returns the largest value error over valid points."""
    dev = torch.device("cuda")
    far = ", x[:, 0] masked 1e3 out" if far_masked else ""
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
    if far_masked:
        x[:, 0] = 1e3
        xm[:, 0] = False
        y[:, 9] = 1.5
        ym[:, 9] = True
    xm[1] = False
    ym[2] = False

    err, got = compare_nn_sweep(x, y, xm, ym, f"random clouds{far}")
    tie_x = ym.any(dim=1)  # elements where x point 11 has valid targets
    tie_y = xm.any(dim=1)
    if not (bool((got[1][tie_x, 11] == 7).all())
            and bool((got[3][tie_y, 5] == 3).all())):
        raise AssertionError("an exact tie must go to the first index")
    log(f"  nn_sweep C={C}{far}: exact ties to the first index")
    return err


def compare_nn_sweep(x, y, xm, ym, label):
    """nn_sweep against its plain version, the kernel twice and bit-equal:
    values within 1e-5 on the valid queries that have a valid target,
    >= 1e10 on the others (a query whose targets are all masked gets 1e10
    and index 0, as the plain version); indices equal wherever the plain
    version's runner-up is more than 1e-5 farther. Returns the largest value
    error and the kernel's outputs."""
    from pointcloud_tpu_torch.ops import nn_sweep, nn_sweep_reference
    from pointcloud_tpu_torch.ops.geometry import pairwise_sqdist

    got = twice_equal("nn_sweep", lambda: nn_sweep(x, y, xm, ym))
    want = nn_sweep_reference(x, y, xm, ym)
    d = pairwise_sqdist(x, y)
    err, lonely = 0.0, 0
    for v, i, qm, tm, dd in ((0, 1, xm, ym, d), (2, 3, ym, xm, d.transpose(1, 2))):
        has_target = tm.any(dim=1, keepdim=True)
        valid = qm & has_target
        lonely += int((qm & ~has_target).sum())
        if bool(valid.any()):
            err = max(err, float((got[v] - want[v]).abs()[valid].max()))
        if not bool((got[v][~valid] >= 1e10).all()):
            raise AssertionError(f"nn_sweep {label}: masked or target-less queries "
                                 f"need >= 1e10")
        if not bool((got[i][qm & ~has_target] == 0).all()):
            raise AssertionError(f"nn_sweep {label}: a target-less query must name "
                                 f"target 0")
        two = torch.topk(dd.masked_fill(~tm[:, None, :], 1e10), 2, dim=2,
                         largest=False).values
        clear = (two[..., 1] - two[..., 0] > 1e-5) & has_target
        if not bool((got[i] == want[i])[clear].all()):
            raise AssertionError(f"nn_sweep {label}: argmins differ off ties")
    if err > 1e-5:
        raise AssertionError(f"nn_sweep {label}: values differ by {err}")
    log(f"  nn_sweep at {label}, B={x.shape[0]} N={x.shape[1]} M={y.shape[1]} "
        f"C={x.shape[2]}: max |value err| {err:.3e}; {lonely} valid queries without a "
        f"valid target (1e10, index 0); masked rows >= 1e10; argmins equal off ties; "
        f"twice bit-equal")
    return err, got


def time_nn_sweep(x, y, xm, ym, label):
    """nn_sweep at these inputs: kernel, plain version, the library's masked
    cdist().square() + min both ways (timed here, never called by the
    port), and the bound. Returns (ms, plain ms, library ms, (bound ms, by))."""
    from pointcloud_tpu_torch.ops import nn_sweep, nn_sweep_reference

    def library():
        d = torch.cdist(x, y).square()
        return (d.masked_fill(~ym[:, None, :], 1e10).min(dim=2),
                d.masked_fill(~xm[:, :, None], 1e10).min(dim=1))

    ms = cuda_ms(lambda: nn_sweep(x, y, xm, ym), iters=20, warmup=3)
    plain = cuda_ms(lambda: nn_sweep_reference(x, y, xm, ym), iters=3, warmup=1)
    lib = cuda_ms(library, iters=5)
    (B, N, C), M = x.shape, y.shape[1]
    bnd = nn_sweep_bound(B, N, M, C)
    log(f"  nn_sweep at {label}, B={B} N={N} M={M} C={C} ({B * N * M:.3g} pairs): "
        f"kernel {ms:.4f} ms | plain {plain:.3f} ms | library cdist().square() + "
        f"masked min both ways {lib:.3f} ms | bound {bnd[0]:.4f} ms ({bnd[1]})")
    return ms, plain, lib, bnd


def nn_sweep_bound(B, N, M, C):
    """The larger of the cost products (2 directions x B N M pairs x K deep,
    2 flops each, at the bf16 tensor-core rate; K = 6C + 6 padded to 16) and
    the epilogue's compare and two selects a pair-direction at the fp32
    rate; bytes: both clouds read once, 8 bytes written a point."""
    from pointcloud_tpu_torch.ops.nn_sweep import nn_depth

    pairs = 2 * B * N * M
    t_mma = bound(pairs * 2 * nn_depth(C), 0, PEAK_BF16_FLOPS)[0]
    t_epi = bound(pairs * 3, 0, PEAK_FP32_FLOPS)[0]
    t_bytes = bound(0, B * (N + M) * (C * 4 + 8), PEAK_FP32_FLOPS)[0]
    worst = max(t_mma, t_epi, t_bytes)
    return worst, ("bytes" if worst == t_bytes else "operations")


def nn_direct_bound(B, N, M, C):
    """The first version's bound, for comparison: C subtractions, C
    multiplications, C-1 additions and a comparison a pair-direction on
    the CUDA cores at the fp32 rate."""
    return bound(2 * B * N * M * 3 * C, 0, PEAK_FP32_FLOPS)[0]


def twice_equal(name, fn):
    """Run fn twice on the same inputs; the results must be bit-equal."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not all((u is None and v is None) or torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    return a


@contextlib.contextmanager
def recording(module, name):
    """While open, `module.name` appends each call's (args, kwargs) to the
    list it yields, then calls through: it sees what a path hands a kernel
    that the path's callers look up in `module`. The stand-in carries the
    function's attributes (a wrapper that counts its launches through its
    module's name counts on the stand-in) and hands them back."""
    fn, calls = getattr(module, name), []

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    rec.__dict__.update(fn.__dict__)
    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)
        fn.__dict__.update(rec.__dict__)


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


def chamfer_mirror(args):
    """The kernel's order of sums on the CPU (scatter_rows_mirror of each
    direction's terms: buckets of up to 32 rows in row order, longer ones
    in pieces of 32 added in piece order)."""
    from pointcloud_tpu_torch.ops import scatter_rows_mirror
    from pointcloud_tpu_torch.ops.chamfer_bwd import PIECE, nn_terms

    x, y, gx, gy, ax, ay = (t.cpu() for t in args)
    tx, ty = nn_terms(x, y, gx, gy, ax, ay)
    return (scatter_rows_mirror(-ty, ay, x.shape[1], init=tx, piece=PIECE),
            scatter_rows_mirror(-tx, ax, y.shape[1], init=ty, piece=PIECE))


def check_chamfer_bwd_order(gen, B, N, C, collapsed):
    """chamfer_bwd on unmasked clouds, or on a collapsed y cloud (every y
    point within 1e-3 of x point 5: one bucket of N rows, summed in pieces),
    against its plain version (compare_chamfer_bwd) and bit-equal to the
    kernel's order computed on the CPU (chamfer_mirror)."""
    from pointcloud_tpu_torch.ops import chamfer_bwd, nn_sweep

    dev = torch.device("cuda")
    x = torch.rand((B, N, C), generator=gen, device=dev)
    y = torch.rand((B, N, C), generator=gen, device=dev)
    if collapsed:
        y = x[:, 5:6] + 1e-3 * y
    _, ax, _, ay = nn_sweep(x, y)
    if collapsed and not bool((ay == 5).all()):
        raise AssertionError("the collapsed cloud's rows must all pick x point 5")
    gx = torch.randn((B, N), generator=gen, device=dev) / N
    gy = torch.randn((B, N), generator=gen, device=dev) / N
    args = (x, y, gx, gy, ax, ay)
    label = f"{'collapsed' if collapsed else 'unmasked'}, one launch"
    before = chamfer_bwd.launches
    e = compare_chamfer_bwd(args, label)
    if chamfer_bwd.launches - before != 2:
        raise AssertionError("chamfer_bwd must be one launch a call")
    got = chamfer_bwd(*args)
    if not all(torch.equal(g.cpu(), m) for g, m in zip(got, chamfer_mirror(args))):
        raise AssertionError(f"chamfer_bwd ({label}) is not the kernel's order")
    log(f"  chamfer_bwd B={B} N=M={N} C={C} {label}: bit-equal to the kernel's "
        f"order on the CPU (scatter_rows_mirror)")
    return e


def chamfer_direct(args):
    """A callable that launches chamfer_bwd's kernel through its C entry on
    these inputs, outputs and scratch allocated once (CUDA events over such
    launches time the card, not the wrapper); a port without
    `chamfer_bwd_plan` (a parent commit) through the first version's entry
    and its sort scratch."""
    mod = sys.modules["pointcloud_tpu_torch.ops.chamfer_bwd"]
    x, y = args[:2]
    (B, N, C), M = x.shape, y.shape[1]
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    ptrs = [t.data_ptr() for t in (*args, dx, dy)]
    fn = mod._launcher()
    stream = torch.cuda.current_stream().cuda_stream
    if not hasattr(mod, "chamfer_bwd_plan"):
        sort = [torch.empty((B, n), dtype=torch.int32, device=x.device)
                for n in (N, M, M, N)]  # end_x, perm_y, end_y, perm_x
        return lambda: fn(*ptrs, *(t.data_ptr() for t in sort), B, N, M, C, stream)
    p = mod.chamfer_bwd_plan(B, N, M, C)
    scratch = (torch.empty(2 * B * p.scratch, dtype=torch.uint8, device=x.device)
               if p.scratch else None)
    return lambda: fn(*ptrs, None if scratch is None else scratch.data_ptr(), B, N, M, C,
                      p.ranges, int(p.route == "shared"), p.smem, p.scratch, stream)


def chamfer_bwd_bound(B, N, M, C):
    """Both clouds, cotangents and argmins read once, dx and dy written
    once; ~6C fp32 operations a point."""
    return bound((B * N + B * M) * 6 * C, (B * N + B * M) * (2 * C * 4 + 4 + 4),
                 PEAK_FP32_FLOPS)


def time_chamfer_bwd(args, label):
    """chamfer_bwd at these inputs: the kernel through its C entry (20
    launches, CUDA events) beside its plain version, the library's gathers +
    index_add_ (atomics on the card; timed here, never called by the port)
    and the bound. Returns (ms, plain ms, library ms, (bound ms, by))."""
    from pointcloud_tpu_torch.ops import chamfer_bwd_reference
    from pointcloud_tpu_torch.ops.chamfer_bwd import gather_rows

    x, y, gx, gy, ax, ay = args
    (B, N, C), M = x.shape, y.shape[1]

    def library():
        tx = 2.0 * gx[..., None] * (x - gather_rows(y, ax))
        ty = 2.0 * gy[..., None] * (y - gather_rows(x, ay))
        dx = tx.reshape(-1, C).index_add_(0, (ay.long() + torch.arange(
            B, device=x.device)[:, None] * N).reshape(-1), -ty.reshape(-1, C))
        dy = ty.reshape(-1, C).index_add_(0, (ax.long() + torch.arange(
            B, device=x.device)[:, None] * M).reshape(-1), -tx.reshape(-1, C))
        return dx, dy

    ms = cuda_ms(chamfer_direct(args), iters=20, warmup=3)
    plain = cuda_ms(lambda: chamfer_bwd_reference(*args), iters=3, warmup=1)
    lib = cuda_ms(library, iters=5)
    bnd = chamfer_bwd_bound(B, N, M, C)
    plan = sys.modules["pointcloud_tpu_torch.ops.chamfer_bwd"].__dict__.get(
        "chamfer_bwd_plan")
    how = f" ({tuple(plan(B, N, M, C))})" if plan else ""
    log(f"  chamfer_bwd at {label}, B={B} N={N} M={M} C={C}{how}: kernel {ms:.4f} ms "
        f"(C entry, events) | plain {plain:.3f} ms | library gathers + index_add_ "
        f"{lib:.3f} ms | bound {bnd[0]:.4f} ms ({bnd[1]})")
    return ms, plain, lib, bnd


def large_k_checks(gen, err):
    """The ball groupings past the slots their shared memory holds, the
    slots in the idx output: ball_group at k = 781 and 1,024 (past 780) and
    group_gather at k = 1,807 and 2,048 (past 1,806), masked clouds, balls
    fuller than those k, one k above N each, the global route once each:
    equal to the plain versions, two runs bit-equal."""
    from pointcloud_tpu_torch.ops import ball_group_plan

    bf, f32 = torch.bfloat16, torch.float32
    for B, N, S, k, F, dtype, masked, radius in (
            (2, 4096, 37, 781, 3, bf, True, 0.8), (2, 2048, 64, 1024, 128, bf, False, 0.8),
            (2, 700, 20, 1024, 3, f32, True, 0.6), (2, 15000, 8, 1024, 0, f32, True, 0.3)):
        want = "global-idx" if N == 15000 else "shared-idx"
        got = ball_group_plan(B, N, S, k, F, dtype if F else f32).route
        if got != want:
            raise AssertionError(f"ball_group k={k} N={N}: route {got}, expected {want}")
        err["ball_group"] = max(err["ball_group"], check_ball_group(
            gen, B, N, S, k, F, dtype, masked, radius))
    err["group_gather"] = max(
        err.get("group_gather", 0.0),
        check_group_gather(gen, 2, 4096, 37, 1807, 3, bf, True, 0.9, True,
                           route="shared-idx"),
        check_group_gather(gen, 2, 2048, 20, 2048, 320, bf, False, 0.9, False,
                           route="shared-idx"),
        check_group_gather(gen, 2, 1500, 10, 2048, 6, f32, True, 0.9, True,
                           route="shared-idx"),
        check_group_gather(gen, 2, 16000, 6, 1807, 3, bf, True, 0.5, True,
                           route="global-idx"))


# bn_pool at every driven level and stage: (label, groups, C, pool, residual
# mode, masked), PointNet2 at bench.py's B=256, PointMLP, Elite and MSG at
# B=32, and ragged widths (one channel a thread)
BN_POOL_CASES = (
    ("PointNet2 SA1", 256 * 512, 128, 32, 0, True),
    ("PointNet2 SA2", 256 * 128, 256, 64, 0, True),
    ("PointNet2 SA3", 256, 1024, 128, 0, True),
    ("PointMLP stage 1", 32 * 1024, 128, 24, 2, False),
    ("PointMLP stage 2", 32 * 512, 256, 24, 2, False),
    ("PointMLP stage 3", 32 * 256, 512, 24, 2, False),
    ("PointMLP stage 4", 32 * 128, 1024, 24, 2, False),
    ("Elite stage 1", 32 * 1024, 64, 24, 1, False),
    ("Elite stage 2", 32 * 512, 128, 24, 1, False),
    ("Elite stage 3", 32 * 256, 256, 24, 2, False),
    ("Elite stage 4", 32 * 128, 256, 24, 1, False),
    ("MSG group-all", 32, 1024, 128, 0, True),
    ("ragged 130 wide", 300, 130, 12, 1, False),
    ("ragged 36 wide, masked", 500, 36, 32, 0, True),
)


def bn_pool_inputs(gen, G, C, pool, mode, masked):
    """h (1, G * pool, C) bf16 with planted ties (group 0's rows 3, 5 and
    pool - 1 equal to row pool + 1; group 1 all equal, its residual too),
    BatchNorm scalars, pen (~10% masked, group 2 all masked) where `masked`,
    and the residual of `mode` (1: (h0, scalars), 2: a tensor)."""
    dev = torch.device("cuda")
    R = G * pool
    h = torch.randn((1, R, C), generator=gen, device=dev).to(torch.bfloat16)
    if G > 2:
        h[0, [3, 5, pool - 1]] = h[0, pool + 1].clone()
        h[0, pool:2 * pool] = h[0, pool].clone()
    sc = torch.stack([0.1 * torch.randn(C, generator=gen, device=dev),
                      0.5 + torch.rand(C, generator=gen, device=dev),
                      0.1 * torch.randn(C, generator=gen, device=dev),
                      torch.ones(C, device=dev)])
    pen = None
    if masked:
        pen = torch.where(torch.rand((1, R), generator=gen, device=dev) > 0.1, 0.0, 1e9)
        if G > 2:
            pen[0, pool:2 * pool] = 0.0
            pen[0, 2 * pool:3 * pool] = 1e9
    res = None
    if mode:
        src = torch.randn((1, R, C), generator=gen, device=dev).to(torch.bfloat16)
        if G > 2:
            src[0, pool:2 * pool] = src[0, pool].clone()
        res = (src, sc) if mode == 1 else src
    return h, sc, pen, res


def check_bn_pool_shapes(gen, err):
    """bn_pool alone at every BN_POOL_CASES shape: out, maxv, amax and hsel
    exactly equal to the plain version's, two runs bit-equal; a tie goes to
    the lowest row, a group of equal rows to its first, a group with no
    valid row to -1e9."""
    from pointcloud_tpu_torch.ops import bn_pool, bn_pool_plan, bn_pool_reference

    for label, G, C, pool, mode, masked in BN_POOL_CASES:
        h, sc, pen, res = bn_pool_inputs(gen, G, C, pool, mode, masked)
        got = twice_equal("bn_pool", lambda: bn_pool(h, sc, pen, pool, res=res))
        want = bn_pool_reference(h, sc, pen, pool, res=res)
        for what, g, w in zip(("out", "maxv", "amax", "hsel"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"bn_pool {label}: {what} differs from the plain "
                                     f"version")
        if not bool((got[2][0, 1] == 0).all()):
            raise AssertionError(f"bn_pool {label}: equal rows must give the first")
        if pen is not None and not bool((got[0][0, 2] == -1e9).all()):
            raise AssertionError(f"bn_pool {label}: a group without a valid row "
                                 f"must give -1e9")
        p = bn_pool_plan(G, C, pool, h.dtype, mode)
        log(f"  bn_pool {label}: groups={G} C={C} pool={pool} residual mode {mode} "
            f"(plan: {p.vec} channels a thread, {p.slices} slices of {p.rows} rows, "
            f"{p.per_block} groups a block): out, maxv, amax, hsel equal to the "
            f"plain version's; two runs bit-equal")
        del h, sc, pen, res, got, want
    err["bn_pool"] = max(err.get("bn_pool", 0.0), 0.0)
    torch.cuda.empty_cache()


def bn_pool_direct(h, sc, pen, pool, res):
    """A callable that launches bn_pool's kernel through its C entry on
    these inputs, outputs allocated once; a port without `bn_pool_plan` (a
    parent commit) through the first version's entry (no plan)."""
    tpf = sys.modules["pointcloud_tpu_torch.ops.preextract_fused"]
    B, R, C = h.shape
    G = R // pool
    mode, src, rsc = tpf._res_parts(res)
    dev = h.device
    outs = (torch.empty((B, G, C), dtype=h.dtype, device=dev),
            torch.empty((B, G, C), dtype=torch.float32, device=dev),
            torch.empty((B, G, C), dtype=torch.int32, device=dev),
            torch.empty((B, G, C), dtype=torch.float32, device=dev))
    ptr = [None if t is None else t.data_ptr() for t in (h, sc, src, rsc, pen, *outs)]
    launch = tpf._launchers()[1]
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = int(h.dtype == torch.bfloat16)
    if not hasattr(tpf, "bn_pool_plan"):
        return lambda: launch(ptr[0], ptr[1], mode, *ptr[2:], B * G, C, pool, 1, bf16,
                              stream)
    p = tpf.bn_pool_plan(B * G, C, pool, h.dtype, mode,
                         all(t.data_ptr() % 16 == 0 for t in (h, src) if t is not None))
    return lambda: launch(ptr[0], ptr[1], mode, *ptr[2:], B * G, C, pool, 1, bf16, p.vec,
                          p.strips, p.slices, p.per_block, stream)


def bn_pool_times():
    """bn_pool at every BN_POOL_CASES shape (random inputs): the kernel
    through its C entry (20 launches, CUDA events) beside the library's
    composition (BatchNorm's affine, the residual, the penalty, amax and
    relu; timed here, never called by the port) and the bound (chain_bounds'
    pool pass). Returns {label: (ms, library ms, (bound ms, by))}."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for label, G, C, pool, mode, masked in BN_POOL_CASES:
        h, sc, pen, res = bn_pool_inputs(gen, G, C, pool, mode, masked)
        ms = cuda_ms(bn_pool_direct(h, sc, pen, pool, res), iters=20, warmup=3)
        r = (0.0 if res is None else res.float() if mode == 2 else
             torch.relu((res[0].float() - sc[0]) * sc[1] + sc[2]))
        p4 = 0.0 if pen is None else pen.reshape(1, G, pool, 1)
        lib = cuda_ms(lambda: torch.relu(torch.amax(
            ((h.float() - sc[0]) * sc[1] + sc[2] + r).reshape(1, G, pool, C) - p4,
            dim=2)), iters=3, warmup=1)
        bnd = chain_bounds(G * pool, G, 1, C, 2, False, True, res=mode != 0,
                           pen=masked)[1]
        out[label] = (ms, lib, bnd)
        log(f"  bn_pool {label}: groups={G} C={C} pool={pool} residual mode {mode}: "
            f"kernel {ms:.4f} ms (C entry, events) | library composition {lib:.3f} ms "
            f"| bound {bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.0f}% of it")
        del h, sc, pen, res, r
    torch.cuda.empty_cache()
    return out


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


def compare_dense_pool(gen, x, w, b, s, pen, pool, acc_bound=False):
    """dense_pool_stats' forward and backward kernels vs the plain version
    and its autograd, each kernel twice. fp32: 1e-4 relative (summation
    order only). bf16, where accumulation order can flip one rounding of z:
    psel within 1 bf16 ulp of |z|, asel equal wherever the runner-up is more
    than 1 ulp below, ssum, ssq, dw, db within 1e-3 relative and dx within
    2e-2 relative (bf16 values), relative to the largest entry; bf16 db
    against the fp32 sum of the plain version's dz, before its cast.
    `acc_bound` adds to the psel and gap tolerances the a-priori error bound
    of z's fp32 sums in either order, Cin 2^-24 (|x| |w| + |b|): on trained
    activations a pooled z whose terms cancel to round-off carries an error
    larger than its own bf16 ulp (the paths' own inputs take it; the log
    counts the pools that needed it).
    Returns the largest absolute errors of the forward (psel) and of the
    backward (dw), and the kernel's forward outputs."""
    from pointcloud_tpu_torch.ops import (
        dense_pool_stats,
        dense_pool_stats_bwd,
        dense_pool_stats_reference,
        pool_fwd_plan,
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
    beyond = 0
    if dtype == torch.float32:
        ps_ok = (got[0] - want[0]).abs() <= 1e-4 * want[0].abs().max()
        gap = top2[:, :, 0] - top2[:, :, 1] > 1e-5 * top2[:, :, 0].abs()
    else:
        slack = slack_gap = 0.0
        if acc_bound:
            a = (torch.matmul(x.float().abs(), w.float().abs()) + b.float().abs()
                 ).reshape(B, R // pool, pool, C) * (Cin * 2.0 ** -24)
            slack = torch.gather(a, 2, want[1].long()[:, :, None, :])[:, :, 0]
            slack_gap = 2 * a.amax(dim=2)
            del a
        ps_diff = (got[0].float() - want[0].float()).abs()
        ps_ok = ps_diff <= bf16_ulp(want[0]) + slack
        beyond = int((ps_diff > bf16_ulp(want[0])).sum())  # inside the slack only
        gap = top2[:, :, 0] - top2[:, :, 1] > bf16_ulp(top2[:, :, 0]) + slack_gap
    if not bool(ps_ok.all()):
        i = tuple((~ps_ok).nonzero()[0].tolist())
        raise AssertionError(
            f"dense_pool_stats psel {dtype} off by more than its tolerance at "
            f"{int((~ps_ok).sum())} entries; first {i}: kernel "
            f"{float(got[0][i]):.6e}, plain {float(want[0][i]):.6e}")
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
    route = pool_fwd_plan(B * R, Cin, C, dtype == torch.bfloat16, pool).route
    log(f"  dense_pool_stats {str(dtype)[6:]} B={B} R={R} Cin={Cin} C={C} "
        f"pool={pool} pen={masked} ({route} route): psel ok"
        f"{f' ({beyond} of {got[0].numel()} pools past one ulp, inside the accumulation bound)' if acc_bound else ''}, asel equal off ties, ssum/ssq "
        f"rel {e_stats:.1e}; bwd dx rel {e_dx:.1e}, dw/db rel {e_dw:.1e}; "
        f"fwd and bwd two runs bit-equal")
    return err, err_bwd, got


def pool_library_fwd(x, w, b, pool):
    """bf16 matmul + each pool block's aminmax + the fp32 sums, the
    composition that stores z: a yardstick timed here, never called by the
    port. Returns the thunk."""
    def run():
        z = torch.matmul(x, w) + b
        B, R, C = z.shape
        zmin, zmax = torch.aminmax(z.reshape(B, R // pool, pool, C), dim=2)
        zf = z.float()
        return zmin, zmax, zf.sum(dim=(0, 1)), (zf * zf).sum(dim=(0, 1))
    return run


def pool_fwd_bound(x, C, pool, pen):
    """The dense-pool forward's bound: one product at the dense bf16 rate;
    bytes x, w and the bias read (bf16), pen read, psel (bf16) and asel
    (int32) written, the sums written (fp32)."""
    B, R, Cin = x.shape
    return bound(2 * B * R * Cin * C,
                 (B * R * Cin + Cin * C + C) * 2 + (0 if pen is None else B * R * 4)
                 + B * (R // pool) * C * 6 + 2 * C * 4, PEAK_BF16_FLOPS)


def pool_fwd_yardstick(gen, layer, x_raw, spec, label, err):
    """The dense-pool forward at a PointNet train path's own dbnpool2 input
    (one more forward in train mode): held against its plain version (the
    accumulation bound), then its plan, time, plain and library time and
    bound printed."""
    from pointcloud_tpu_torch.ops import (
        dense_pool_stats,
        dense_pool_stats_reference,
        pool_fwd_plan,
    )

    feats = {}
    hook = layer.register_forward_pre_hook(
        lambda m, inp: feats.__setitem__("x", inp[0].detach()))
    with torch.no_grad():
        spec.model(spec.in_transform(x_raw)[0], train=True)
    hook.remove()
    x = feats.pop("x").to(torch.bfloat16).contiguous()
    w = layer.weight.detach().t().to(torch.bfloat16).contiguous()
    b = layer.bias.detach().to(torch.bfloat16)
    s = torch.where(layer.scale >= 0, 1.0, -1.0).float().detach()
    (B, R, Cin), C = x.shape, w.shape[1]
    e_fwd, _, _ = compare_dense_pool(gen, x, w, b, s, None, R, acc_bound=True)
    err["dense_pool_stats"] = max(err["dense_pool_stats"], e_fwd)
    torch.cuda.empty_cache()
    k_ms = cuda_ms(lambda: dense_pool_stats(x, w, b, s, None, R), iters=10)
    p_ms = cuda_ms(lambda: dense_pool_stats_reference(x, w, b, s, None, R), iters=3,
                   warmup=1)
    l_ms = cuda_ms(pool_library_fwd(x, w, b, R), iters=3, warmup=1)
    bnd = pool_fwd_bound(x, C, R, None)
    plan = pool_fwd_plan(B * R, Cin, C, True, R)
    log(f"  dense_pool_stats fwd at {label}: B={B} R={R} Cin={Cin} C={C} bf16 "
        f"({plan.route} route; {plan.chunks} chunks of {plan.chunk_rows} rows x "
        f"{plan.col_blocks} channel blocks): kernel {k_ms:.3f} ms | plain {p_ms:.3f} ms | "
        f"library matmul + aminmax + sums {l_ms:.3f} ms | bound {bnd[0]:.3f} ms ({bnd[1]})")
    torch.cuda.empty_cache()


def pool_bwd_bound(B, R, Cin, C, pool):
    """The dense-pool backward's bound: three products (z, dx, dw) at the
    dense bf16 rate; bytes x read and dx written (bf16), w and the bias read,
    asel and dpsel read, dw and db written (fp32)."""
    return bound(3 * 2 * B * R * Cin * C,
                 (2 * B * R * Cin + Cin * C + C) * 2 + B * (R // pool) * C * (4 + 4)
                 + Cin * C * 4 + 3 * C * 4, PEAK_BF16_FLOPS)


def pool_library_bwd(x, w, b, pool, g_ps, g_s):
    """Autograd through bf16 matmul + the pool blocks' amax + the sums, the
    composition that stores z: a yardstick timed here, never called by the
    port. Returns the thunk."""
    xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, b))

    def run():
        z = torch.matmul(xl, wl) + bl
        B, R, C = z.shape
        zmax = z.reshape(B, R // pool, pool, C).amax(dim=2)
        zf = z.float()
        return torch.autograd.grad(
            (zmax, zf.sum(dim=(0, 1)), (zf * zf).sum(dim=(0, 1))), (xl, wl, bl),
            (g_ps.to(zmax.dtype), g_s, g_s))
    return run


def time_pool_bwd_parts(x, w, b, s, asel, g_ps, g_s, pool):
    """(dx ms, dw ms) of one dense_pool_stats_bwd call: the device time of its
    dx kernel, and of its dw kernel with the fixed-order sums of its partials
    (colsum_kernel), from a torch.profiler trace of 5 calls."""
    from torch.profiler import ProfilerActivity, profile

    from pointcloud_tpu_torch.ops import dense_pool_stats_bwd

    calls = 5
    dense_pool_stats_bwd(x, w, b, s, asel, g_ps, g_s, g_s, pool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            dense_pool_stats_bwd(x, w, b, s, asel, g_ps, g_s, g_s, pool)
        torch.cuda.synchronize()
    dx = dw = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.is_user_annotation:
            continue
        ms = e.device_time_total / 1e3 / calls
        if "dx_wgmma_kernel" in e.key or "bwd_dx_kernel" in e.key:
            dx += ms
        elif any(k in e.key for k in ("dw_wgmma_kernel", "bwd_dw_kernel", "colsum_kernel")):
            dw += ms
    if dx <= 0 or dw <= 0:
        raise AssertionError(f"the backward's trace holds no dx ({dx}) or dw ({dw}) time")
    return dx, dw


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
    N(0, 0.1) and variances in [0.5, 2]. The chain layers' numbered leaves
    (`w{i}` (cin, co), `scale{i}`, `var{i}`, ...) are drawn as their names
    say."""
    with torch.no_grad():
        for name, t in module.state_dict().items():
            leaf, shape = name.rsplit(".", 1)[-1].rstrip("0123456789"), t.shape
            if leaf == "weight":
                v = torch.randn(shape, generator=gen) / shape[1] ** 0.5
            elif leaf == "w":
                v = torch.randn(shape, generator=gen) / shape[0] ** 0.5
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
    from pointcloud_tpu_torch.train import zero_gradient_biases

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
        zero = zero_gradient_biases(cpu)
        for name, want in [*grads_c.items(), ("input", dx_c)]:
            got = dx_g if name == "input" else grads_g[name]
            if name in zero:
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


def check_card_grads(label, card, cpu, zero):
    """First-step gradients, card against CPU ({name: tensor}): 1e-3
    relative plus 3e-3 of each tensor's largest entry; the zero-gradient
    biases `zero` round-off on the card (below 1e-4 of the largest
    gradient). Returns the largest relative error."""
    top = max(float(g.abs().max()) for g in cpu.values())
    worst = 0.0
    for k, want in cpu.items():
        got = card[k]
        if k in zero:
            if float(got.abs().max()) > 1e-4 * top:
                raise AssertionError(f"{label} {k}: gradient on the card is not "
                                     f"round-off")
            continue
        excess = ((got - want).abs() - 1e-3 * want.abs()
                  - 3e-3 * float(want.abs().max())).max()
        worst = max(worst, rel_err(got, want))
        if float(excess) > 0:
            raise AssertionError(f"{label} {k}: card vs CPU first-step gradient differs")
    return worst


def card_vs_cpu_train(seed, x_raw, loss_override="chamfer", first_tol=1e-5,
                      steps_tol=1e-3):
    """The fp32 model's train step on the card and on the CPU, from the same
    weights, on one cloud repeated (B=2: the STN heads' batch variance is
    then exactly 0 on both sides, see tests/test_torch_train_slice.py, so
    their weights get no gradient here; card_vs_cpu_heads covers them).
    First-step loss `first_tol` relative and gradients 1e-3 relative plus
    3e-3 of each tensor's largest entry (zero-gradient biases: round-off
    below 1e-4 of the largest gradient); losses of 3 steps `steps_tol`
    relative. With loss_override=None the loss is the default EMD: the
    card's kernel and the CPU's plain version may match a near-tied row to
    another target (1 / 2048 of the point loss and of its gradient a row), so
    the caller passes a first-loss tolerance of 1e-4; and the later steps'
    matchings follow weights that Adam's first update moved by ~lr in
    directions that differ on round-off entries, while the loss swings (0.22,
    0.38, 0.21 on an NVIDIA H100), so it passes 1e-2 for the three steps
    (measured there: 0, 2.4e-4, 2.9e-3)."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import chamfer as tchamfer
    from pointcloud_tpu_torch.train import (
        create_model,
        make_optimizer,
        make_train_step,
        zero_gradient_biases,
    )

    cfg.precision = "fp32"
    try:
        specs = [create_model("Autoencoder", "PointNet", "Cube",
                              loss_override=loss_override, device=d, seed=seed)
                 for d in ("cuda", "cpu")]
    finally:
        cfg.precision = "bf16-mixed"
    xs = x_raw[:1].repeat(2, 1, 1)
    losses, grads = [], []
    for spec in specs:
        step = make_train_step(spec, make_optimizer(spec))
        xd = xs.to(next(spec.model.parameters()).device)
        ls = []
        with recording(tchamfer, "nn_sweep") as nn_calls:
            for i in range(3):
                ls.append(float(step(xd, xd)[0]))
                if i == 0:
                    grads.append({k: p.grad.detach().float().cpu()
                                  for k, p in spec.model.named_parameters()})
        if xd.is_cuda and nn_calls:
            nn_expansion_error(*(t.detach() for t in nn_calls[0][0][:2]),
                               "the fp32 PointNet first train step's Chamfer inputs")
        losses.append(ls)
    worst = check_card_grads("PointNet", grads[0], grads[1],
                             zero_gradient_biases(specs[1].model))
    l_gpu, l_cpu = losses
    if abs(l_gpu[0] - l_cpu[0]) > first_tol * l_cpu[0] or any(
            abs(a - b) > steps_tol * b for a, b in zip(l_gpu, l_cpu)):
        raise AssertionError(f"card vs CPU train losses {l_gpu} vs {l_cpu}")
    log(f"  fp32 train step ({loss_override or 'EMD'} loss), card vs CPU, B=2: "
        f"losses {l_gpu} vs {l_cpu} (first rel diff "
        f"{abs(l_gpu[0] - l_cpu[0]) / l_cpu[0]:.2e}); first-step gradients max rel "
        f"err {worst:.2e}")
    return l_gpu[0]


def check_fps(gen, B, N, K, C=3, masked=True, keep=0.8, mask_last=True):
    """farthest_point_sample vs fps_reference: equal indices (the same
    rounded operations in the same order), the kernel twice. Points N//2..
    duplicate points 0.. (exact ties; on the cluster route the copies lie
    in other blocks); with masks a share `keep` of the points valid, point 0
    of cloud 0 masked and, with mask_last, every point of the last cloud
    masked (all slots 0 there). Returns the largest index difference (0)."""
    from pointcloud_tpu_torch.ops import farthest_point_sample, fps_plan, fps_reference

    dev = torch.device("cuda")
    xyz = torch.rand((B, N, C), generator=gen, device=dev)
    xyz[:, N - N // 2:] = xyz[:, : N // 2]
    mask = None
    if masked:
        mask = torch.rand((B, N), generator=gen, device=dev) < keep
        mask[0, 0] = False
        if mask_last:
            mask[-1] = False
    got = twice_equal("fps", lambda: (farthest_point_sample(xyz, K, mask),))[0]
    want = fps_reference(xyz, K, mask)
    if not torch.equal(got, want):
        raise AssertionError(f"fps indices differ from the plain version "
                             f"(B={B} N={N} K={K} C={C} masked={masked})")
    if masked and mask_last and not bool((got[-1] == 0).all()):
        raise AssertionError("fps on a fully masked cloud must give zeros")
    plan = fps_plan(B, N)
    log(f"  fps B={B} N={N} K={K} C={C} masked={masked} ({plan.route} route, "
        f"{plan.cluster} block(s) of {plan.per_block} points a cloud): indices "
        f"equal to the plain version's; two runs bit-equal")
    return float((got - want).abs().max())


def check_ball_group(gen, B, N, S, k, F, dtype, masked, radius):
    """ball_group vs ball_group_reference: idx, valid and grouped equal
    (the same membership test, gathers and one rounding), the kernel twice.
    Centroids on every (N // S)-th point, the last one far outside the
    cloud (an empty ball: every slot point 0, none valid). Returns the
    largest |grouped error| (0)."""
    from pointcloud_tpu_torch.ops import ball_group, ball_group_reference

    dev = torch.device("cuda")
    xyz = torch.rand((B, N, 3), generator=gen, device=dev)
    feats = torch.randn((B, N, F), generator=gen, device=dev).to(dtype) if F else None
    cents = xyz[:, :: N // S][:, :S].clone()
    cents[:, -1] += 5.0
    mask = torch.rand((B, N), generator=gen, device=dev) > 0.33 if masked else None
    got = twice_equal("ball_group",
                      lambda: ball_group(xyz, feats, cents, mask, k, radius))
    want = ball_group_reference(xyz, feats, cents, mask, k, radius)
    if not all(a.dtype == w.dtype and torch.equal(a, w) for a, w in zip(got, want)):
        raise AssertionError(f"ball_group differs from the plain version (N={N} "
                             f"S={S} k={k} F={F} {dtype} masked={masked})")
    if not (bool((got[1][:, -1] == 0).all()) and not bool(got[2][:, -1].any())):
        raise AssertionError("ball_group: an empty ball must give point 0, invalid")
    fill = float(got[2].float().mean())
    log(f"  ball_group B={B} N={N} S={S} k={k} F={F} {str(dtype)[6:]} "
        f"masked={masked} r={radius}: idx, valid and grouped equal to the plain "
        f"version's ({fill:.2f} of the slots in a ball); two runs bit-equal")
    return float((got[0].float() - want[0].float()).abs().max())


def ball_library(xyz, feats, cents, k, radius):
    """cdist + first-k selection + gather, storing the (B, S, N) distance
    matrix: timed as a yardstick, never called by the port."""
    N = xyz.shape[1]
    inb = torch.cdist(cents, xyz).square() <= radius * radius
    key = torch.where(inb, torch.arange(N, dtype=torch.int32, device=xyz.device), N)
    first = torch.topk(key, k, dim=-1, largest=False).values
    valid = first < N
    idx = torch.where(valid, first, torch.where(valid[..., :1], first[..., :1], 0))
    flat = idx.reshape(idx.shape[0], -1, 1).long()
    rows = torch.gather(torch.cat([xyz, feats.float()], -1), 1,
                        flat.expand(-1, -1, 3 + feats.shape[-1]))
    rows = rows.reshape(*idx.shape, -1)
    return torch.cat([rows[..., :3] - cents[:, :, None], rows[..., 3:]], -1).to(
        feats.dtype), idx, valid


def fps_bound(B, N, K):
    """~9 fp32 operations per (step, point) (3 sub, 3 mul, 2 add, 1 min);
    bytes: xyz read once, indices written once."""
    return bound(B * (K - 1) * N * 9, B * N * 3 * 4 + B * K * 4, PEAK_FP32_FLOPS)


def ball_bound(B, N, S, k, F, esize, idx, valid):
    """Bytes: xyz, features and centroids read once, grouped rows, idx and
    valid written once. Operations: a distance test is 9 fp32 instructions
    (3 differences, 3 products, 3 sums: rounded intrinsics, no FMA), counted
    at the issue rate PEAK_FP32_ISSUE, over the points this run's data
    makes the kernel test (up to the k-th in-ball point, else all N)."""
    scanned = torch.where(valid[..., -1], idx[..., -1].long() + 1, N)
    ops = 9 * float(scanned.sum())
    nbytes = (B * N * 3 * 4 + B * N * F * esize + B * S * 3 * 4
              + B * S * k * ((3 + F) * esize + 4 + 1))
    return bound(ops, nbytes, PEAK_FP32_ISSUE)


def sensor_cloud(gen, sc, dev):
    """One cloud of the scene's cameras x width x height points (xyz + rgb),
    xyz drawn in a box 1.3x the scene's bbox so that FilterBBox drops about
    half of them."""
    n = len(sc.cameras) * sc.camera_size[0] * sc.camera_size[1]
    bbox = torch.tensor(sc.bbox, dtype=torch.float32, device=dev)
    mid, half = bbox.mean(1), (bbox[:, 1] - bbox[:, 0]) / 2 * 1.3
    xyz = mid + (2 * torch.rand((n, 3), generator=gen, device=dev) - 1) * half
    return torch.cat([xyz, torch.rand((n, 3), generator=gen, device=dev)], -1)


def host_ms(fn, calls, warmup):
    """Sorted host-clock ms of `calls` synchronised calls after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t1) * 1e3)
    return sorted(out)


def pointnet2_path(seed, gen, x_raw, smi, err):
    """The PointNet2 eval path, `encode` and the sensor chain at full width,
    each with its launch counts; FPS and the ball grouping held against
    their plain versions at the path's shapes and timed beside them, a
    yardstick and their bounds; the step's parts. Returns the numbers of the
    two kernels' `kernels` entries."""
    from pointcloud_tpu_torch.envs.scenes import scene_config
    from pointcloud_tpu_torch.ops import (
        ball_group,
        ball_group_reference,
        farthest_point_sample,
        fps_plan,
        fps_reference,
        index_points,
        nn_sweep,
        sample_and_group_all,
    )
    from pointcloud_tpu_torch.train import create_model, make_eval_step
    from pointcloud_tpu_torch.transforms import (
        Compose,
        FilterBBox,
        SampleFurthestPoints,
    )

    dev = torch.device("cuda")
    log(f"[PointNet2 eval path] Autoencoder / PointNet2 / Chamfer, scene Cube, "
        f"B={B_PN2} x 2048 x 6, bf16")
    spec = create_model("Autoencoder", "PointNet2", "Cube",
                        loss_override="chamfer", device=dev, seed=seed)
    step = make_eval_step(spec)
    ev = drive_eval(step, x_raw[:B_PN2].contiguous(), ITERS)
    loss, out, x, counts = ev["loss"], ev["out"], ev["x"], ev["counts"]
    first_s, ms_step, per_iter, peak = (ev["first_s"], ev["ms"], ev["per_iter"],
                                        ev["peak"])
    expect_counts("PointNet2 eval path", counts, nn_sweep=ITERS + 1,
                  fps=2 * (ITERS + 1), ball_group=2 * (ITERS + 1))
    log(f"  eval step B={B_PN2}: first call {first_s:.3f} s; {ITERS} chained "
        f"steps {ms_step:.3f} ms/step on the host clock -> "
        f"{B_PN2 / (ms_step / 1e3):.1f} clouds/s; event-to-event median "
        f"{per_iter[ITERS // 2]:.3f} ms (min {per_iter[0]:.3f}, max "
        f"{per_iter[-1]:.3f}); peak memory {peak:.2f} GiB | {smi}")
    log(f"  loss {float(loss):.6f}; launches {counts}")
    if not bool(torch.isfinite(loss)) or out.shape != (B_PN2, 2048, 6) \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"PointNet2 eval: loss {loss}, out {tuple(out.shape)}")

    with torch.inference_mode():
        one = spec.in_transform(x_raw[:1])[0]
        zero_counts()
        lat = host_ms(lambda: spec.model.encode(one), calls=20, warmup=5)
        enc_counts = read_counts()
        enc = spec.model.encode(one)
    expect_counts("PointNet2 encode", enc_counts, fps=2 * 25, ball_group=2 * 25)
    if enc.shape != (1, 13) or not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"PointNet2 encode gave {tuple(enc.shape)}")
    log(f"  encode(1 cloud) -> {tuple(enc.shape)}; host clock, 20 calls after 5 "
        f"warm-ups: median {lat[10]:.3f} ms, max {lat[-1]:.3f} ms; launches "
        f"{enc_counts}")

    # the step's parts at B=256, CUDA events around the same calls
    bb = spec.model.encoder.backbone
    with torch.inference_mode():
        xn = spec.in_transform(x)[0]
        xyz = xn[..., :3].contiguous()
        feats = xn[..., 3:].to(torch.bfloat16).contiguous()
        parts, level_in = {}, []
        for i, sa in enumerate((bb.SetAbstraction_0, bb.SetAbstraction_1)):
            idx = farthest_point_sample(xyz, sa.npoint)
            new_xyz = index_points(xyz, idx)
            grouped, _, valid = ball_group(xyz, feats, new_xyz, None, sa.nsample,
                                           sa.radius)
            level_in.append((xyz, feats, new_xyz))
            parts[f"SA{i + 1} fps"] = cuda_ms(
                lambda: farthest_point_sample(xyz, sa.npoint), iters=5)
            parts[f"SA{i + 1} ball_group"] = cuda_ms(lambda: ball_group(
                xyz, feats, new_xyz, None, sa.nsample, sa.radius), iters=5)
            parts[f"SA{i + 1} MLP + pool"] = cuda_ms(lambda: sa.pool(grouped, valid),
                                                   iters=5)
            xyz, feats = new_xyz, sa.pool(grouped, valid)
        _, grouped, gmask, _ = sample_and_group_all(xyz, feats)
        parts["SA3 MLP + pool"] = cuda_ms(
            lambda: bb.SetAbstraction_2.pool(grouped, gmask), iters=5)
        h = spec.model.encoder(xn)
        parts["decoder"] = cuda_ms(lambda: spec.model.decoder(h), iters=5)
        y = spec.out_transform(x)[0]
        parts["nn_sweep"] = cuda_ms(lambda: nn_sweep(out, y), iters=5)
    log(f"  eval step parts at B={B_PN2} (CUDA events, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.3f} vs the step's {ms_step:.3f}")

    # FPS at SA1's shape (the path's heaviest FPS launch)
    xyz1, feats1, cents1 = level_in[0]
    B, N, K = xyz1.shape[0], xyz1.shape[1], bb.SetAbstraction_0.npoint
    got = farthest_point_sample(xyz1, K)
    if not torch.equal(got, fps_reference(xyz1, K)):
        raise AssertionError("fps differs from the plain version at SA1's inputs")
    f_ms = cuda_ms(lambda: farthest_point_sample(xyz1, K), iters=10)
    f_plain = cuda_ms(lambda: fps_reference(xyz1, K), iters=2, warmup=1)
    f_bound = fps_bound(B, N, K)
    log(f"  fps B={B} N={N} K={K} (SA1): kernel {f_ms:.3f} ms | plain "
        f"{f_plain:.3f} ms | library none (no PyTorch call selects points "
        f"sequentially) | bound {f_bound[0]:.4f} ms ({f_bound[1]}; {K - 1} "
        f"serial steps)")
    # fps at every shape a driven path launches it at, on clouds of a
    # generator of its own (`gen` goes on to draw the paths' clouds)
    fps_driven_times(torch.Generator(device=dev).manual_seed(seed + 7))

    # ball grouping at both levels; SA2's (the heaviest) goes to `kernels`
    ball = {}
    for lvl, sa in (("SA1", bb.SetAbstraction_0), ("SA2", bb.SetAbstraction_1)):
        bx, bf, bc = level_in[0 if lvl == "SA1" else 1]
        args = (bx, bf, bc, None, sa.nsample, sa.radius)
        got = ball_group(*args)
        want = ball_group_reference(*args)
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            raise AssertionError(f"ball_group differs from the plain version at "
                                 f"{lvl}'s inputs")
        err["ball_group"] = max(err["ball_group"], float(
            (got[0].float() - want[0].float()).abs().max()))
        lib = ball_library(bx, bf, bc, sa.nsample, sa.radius)
        if not (torch.equal(lib[1], got[1]) and torch.equal(lib[2], got[2])):
            log(f"  note: the cdist yardstick's membership differs at {lvl} "
                f"(matmul expansion near the radius)")
        Bb, Nb, Sb, kb, Fb = bx.shape[0], bx.shape[1], bc.shape[1], sa.nsample, bf.shape[2]
        bnd = ball_bound(Bb, Nb, Sb, kb, Fb, bf.element_size(), got[1], got[2])
        fill = float(got[2].float().mean())
        del got, want, lib
        torch.cuda.empty_cache()
        ball[lvl] = (cuda_ms(lambda: ball_group(*args), iters=10),
                     cuda_ms(lambda: ball_group_reference(*args), iters=2, warmup=1),
                     cuda_ms(lambda: ball_library(bx, bf, bc, sa.nsample, sa.radius),
                             iters=2, warmup=1), bnd)
        log(f"  ball_group {lvl} B={Bb} N={Nb} S={Sb} k={kb} F={Fb} bf16 "
            f"({fill:.3f} of the slots in a ball): kernel {ball[lvl][0]:.3f} ms | "
            f"plain {ball[lvl][1]:.3f} ms | library cdist + topk + gather "
            f"{ball[lvl][2]:.3f} ms | bound {bnd[0]:.4f} ms ({bnd[1]})")
    del spec, step, out, x, ev, xn, h, y, level_in, grouped, feats, xyz
    torch.cuda.empty_cache()

    # the sensor's FilterBBox -> SampleFurthestPoints on one cloud
    sc = scene_config("Cube")
    cloud = sensor_cloud(gen, sc, dev)
    chain = Compose([FilterBBox(sc.bbox), SampleFurthestPoints(sc.sample_points)])
    log(f"[sensor] FilterBBox -> SampleFurthestPoints({sc.sample_points}) on one "
        f"cloud of {cloud.shape[0]} points ({len(sc.cameras)} cameras x "
        f"{sc.camera_size[0]} x {sc.camera_size[1]})")
    zero_counts()
    down, dmask = chain(cloud)
    torch.cuda.synchronize()
    s_counts = read_counts()
    expect_counts("sensor chain", s_counts, fps=1)
    s_lat = host_ms(lambda: chain(cloud), calls=5, warmup=1)
    keep = FilterBBox(sc.bbox)(cloud)[1]
    s_xyz = cloud[None, :, :3].contiguous()
    s_idx = farthest_point_sample(s_xyz, sc.sample_points, keep[None])
    cpu_idx = fps_reference(s_xyz.cpu(), sc.sample_points, keep[None].cpu())
    cpu_down, _ = chain(cloud.cpu())
    if not (torch.equal(s_idx.cpu(), cpu_idx) and torch.equal(down.cpu(), cpu_down)):
        raise AssertionError("sensor chain: card and CPU FPS indices differ")
    if down.shape != (sc.sample_points, 6) or not bool(dmask.all()) \
            or not bool(FilterBBox(sc.bbox)(down)[1].all()):
        raise AssertionError("sensor chain output is not 2048 points in the bbox")
    s_ms = cuda_ms(lambda: farthest_point_sample(s_xyz, sc.sample_points, keep[None]),
                   iters=3, warmup=1)
    s_plain = cuda_ms(lambda: fps_reference(s_xyz, sc.sample_points, keep[None]),
                      iters=1, warmup=1)
    s_bound = fps_bound(1, s_xyz.shape[1], sc.sample_points)
    s_plan = fps_plan(1, s_xyz.shape[1])
    steps = sc.sample_points - 1
    log(f"  {float(keep.float().mean()):.3f} of the points inside the bbox; "
        f"chain host clock, 5 calls: median {s_lat[2]:.3f} ms, max "
        f"{s_lat[-1]:.3f} ms; launches {s_counts}; FPS indices card vs CPU "
        f"equal")
    log(f"  fps B=1 N={s_xyz.shape[1]} K={sc.sample_points} (sensor, {s_plan.route} "
        f"route, a cluster of {s_plan.cluster} blocks x {s_plan.per_block} points): "
        f"kernel {s_ms:.3f} ms ({1e3 * s_ms / steps:.2f} us a step) | plain "
        f"{s_plain:.3f} ms | library none | bound {s_bound[0]:.4f} ms "
        f"({1e3 * s_bound[0] / steps:.3f} us a step; {s_bound[1]}; {steps} serial "
        f"steps)")
    return {"counts": counts, "fps": (f_ms, f_plain, f_bound),
            "ball_group": ball["SA2"]}


def card_vs_cpu_pointnet2(seed, x_raw):
    """The fp32 PointNet2 model's eval step on the card and on the CPU, from
    the same weights, at B=2: SA1's FPS indices equal, outputs within 1e-4,
    the loss within 1e-5. The bf16 model's loss within 5% of fp32's."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import farthest_point_sample
    from pointcloud_tpu_torch.train import create_model, make_eval_step

    cfg.precision = "fp32"
    try:
        specs = [create_model("Autoencoder", "PointNet2", "Cube",
                              loss_override="chamfer", device=d, seed=seed)
                 for d in ("cuda", "cpu")]
    finally:
        cfg.precision = "bf16-mixed"
    xs = x_raw[:2]
    idx = [farthest_point_sample(
        sp.in_transform(xs.to(d))[0][..., :3].contiguous(), 512)
        for sp, d in zip(specs, ("cuda", "cpu"))]
    if not torch.equal(idx[0].cpu(), idx[1]):
        raise AssertionError("PointNet2 SA1 FPS indices differ, card vs CPU")
    (l_gpu, _, o_gpu), (l_cpu, _, o_cpu) = (
        make_eval_step(sp)(xs.to(d), xs.to(d))
        for sp, d in zip(specs, ("cuda", "cpu")))
    e_out = float((o_gpu.cpu() - o_cpu).abs().max())
    e_loss = abs(float(l_gpu) - float(l_cpu))
    bf = create_model("Autoencoder", "PointNet2", "Cube", loss_override="chamfer",
                      device="cuda", seed=seed)
    l_bf = float(make_eval_step(bf)(xs, xs)[0])
    bf_loss = abs(l_bf - float(l_gpu)) / float(l_gpu)
    log(f"  PointNet2 fp32 eval step, card vs CPU, B=2: SA1 FPS indices equal; "
        f"max |out err| {e_out:.2e}, |loss err| {e_loss:.2e}; bf16 model's loss "
        f"vs fp32 rel diff {bf_loss:.2e}")
    if e_out > 1e-4 or e_loss > 1e-5:
        raise AssertionError("fp32 PointNet2 on the card disagrees with the CPU")
    if bf_loss > 0.05:
        raise AssertionError("bf16 PointNet2 loss is > 5% off the fp32 one")


def chain_inputs(gen, B, R, layout, dtype, pool, masked):
    """Inputs of the Dense-BN-ReLU-pool chain: x (B, R, Cin) in dtype, fp32
    weights ~ N(0, 1/Cin), scales of random sign with |scale| in [0.5, 1.5],
    offsets ~ N(0, 0.1) and pen. The last row of every group repeats its
    first row (an exact tie in every channel, pen included); with masks ~30%
    of the rows are kept out of the pool and group 0 of cloud 0 entirely."""
    dev = torch.device("cuda")
    x = torch.randn((B, R, layout[0][0]), generator=gen, device=dev).to(dtype)
    x4 = x.view(B, R // pool, pool, -1)
    x4[:, :, -1] = x4[:, :, 0]
    ws = [torch.randn(s, generator=gen, device=dev) / s[0] ** 0.5 for s in layout]
    gs = [torch.where(torch.rand((s[1],), generator=gen, device=dev) < 0.2, -1.0, 1.0)
          * (0.5 + torch.rand((s[1],), generator=gen, device=dev)) for s in layout]
    bs = [0.1 * torch.randn((s[1],), generator=gen, device=dev) for s in layout]
    pen = torch.zeros((B, R), device=dev)
    if masked:
        pen = torch.where(torch.rand((B, R), generator=gen, device=dev) < 0.3, 1e9, 0.0)
        pen[0, :pool] = 1e9
        p3 = pen.view(B, R // pool, pool)
        p3[:, :, -1] = p3[:, :, 0]
    return x, ws, gs, bs, pen


def close_act(name, got, want):
    """Tensors in the activation dtype whose fp32 accumulations ran in
    another order. fp32: 1e-4 of the largest entry. bf16: one bf16 ulp of the
    entry (the order can flip its one rounding) plus 2e-6 of the largest
    entry (entries near 0). Returns the largest absolute error."""
    g, w = got.float(), want.float()
    e = (g - w).abs()
    scale = float(w.abs().max())
    tol = 1e-4 * scale if want.dtype == torch.float32 else bf16_ulp(w) + 2e-6 * scale
    if got.dtype != want.dtype or got.shape != want.shape or not bool((e <= tol).all()):
        raise AssertionError(f"{name} {want.dtype}: off by {float(e.max()):.3e} "
                             f"(largest entry {scale:.3e})")
    return float(e.max())


def close_sums(name, got, want, tol):
    """fp32 sums over rows, relative to the largest of them."""
    e = rel_err(got, want)
    if e > tol:
        raise AssertionError(f"{name}: sums differ by {e:.2e} rel (> {tol})")
    return e


# the kernels of one chain backward pass (csrc/mlp_chain.cu), by name
BWD_KERNELS = ("bwd_dh_kernel", "bwd_da_wgmma_kernel", "bwd_dw_wgmma_kernel",
               "bwd_da_f32_kernel", "bwd_dw_f32_kernel")
# and of its forward products: the TMA + wgmma kernel, the tile kernel
FWD_KERNELS = ("fwd_wgmma_kernel", "mm_stats_kernel")
# fps's register routes (csrc/fps.cu), the Chamfer sweep's wgmma kernel
# (csrc/nn_sweep.cu) and the dense-pool backward's TMA + wgmma kernels
# (csrc/dense_bn_pool.cu)
FPS_KERNELS = ("fps_block_kernel", "fps_cluster_kernel")
NN_KERNELS = ("nn_sweep_kernel",)
POOL_KERNELS = ("pool_fwd_wgmma_kernel", "dx_wgmma_kernel", "dw_wgmma_kernel")
SINKHORN_KERNELS = ("sweep_kernel",)


def bwd_stages(a, kw):
    """The plan of one `chain_bwd_pass(*a, **kw)` and its three stage
    launches as thunks: dh(), da(dh) -> (dzd, sdse, a_up), dw(dh, a_up)."""
    from pointcloud_tpu_torch.ops import preextract_fused as tpf

    h_up, uc, w, a_in, sc_down = a
    (B, R, cd), cu = a_in.shape, w.shape[1]
    pool = kw.get("pool", 1)
    plan = tpf.bwd_plan(B * R, cd, cu, a_in.dtype == torch.bfloat16, sc_down is None,
                        tpf.sm_count(a_in.device.index))
    cot = {k: kw.get(k) for k in ("dz", "dosel", "amax")}
    joins = {k: kw.get(k) for k in ("res", "skip_pool", "skip_dense")}
    return (plan,
            lambda: tpf._bwd_dh(plan, h_up, uc, pool=pool, **cot),
            lambda dh: tpf._bwd_da(plan, dh, w, a_in, sc_down, kw.get("need_dzd", True),
                                   pool=pool, **joins),
            lambda dh, a_up: tpf._bwd_dw(plan, dh, a_up))


def check_bwd_stages(a, kw, what):
    """Each stage kernel of one backward pass against its plain stage on the
    same inputs, each twice and bit-equal: dh bit-equal (its pad 0), dzd by
    `close_act` (one bf16 ulp), a_up bit-equal, sd / se 1e-4 (fp32) or 5e-3
    (bf16) relative, dw 1e-4 / 1e-3 relative (summation order only: both
    sides read the same dh and a_up bits). Returns the largest dzd error and
    relative sums error."""
    from pointcloud_tpu_torch.ops import (
        chain_da_reference,
        chain_dh_reference,
        chain_dw_reference,
    )

    h_up, uc, w, a_in, sc_down = a
    dt, cu, cd = a_in.dtype, w.shape[1], w.shape[0]
    tol = 1e-4 if dt == torch.float32 else 1e-3
    plan, dh_run, da_run, dw_run = bwd_stages(a, kw)
    dh = twice_equal(f"{what} dh stage", lambda: (dh_run(),))[0]
    want_dh = chain_dh_reference(h_up, uc, kw.get("dz"), kw.get("dosel"),
                                 kw.get("amax"), kw.get("pool", 1))
    if not torch.equal(dh[:, :cu].reshape(want_dh.shape), want_dh) \
            or bool(dh[:, cu:].float().abs().sum()):
        raise AssertionError(f"{what}: the dh stage differs from its plain stage")
    dzd, sdse, a_up = twice_equal(f"{what} da stage", lambda: da_run(dh))
    need = kw.get("need_dzd", True)
    w_dzd, w_sd, w_se, w_aup = chain_da_reference(
        want_dh, w, a_in, sc_down, need, kw.get("res"), kw.get("skip_pool"),
        kw.get("skip_dense"), kw.get("pool", 1))
    e_dz = close_act(f"{what} da stage dzd", dzd, w_dzd) if need else 0.0
    if not torch.equal(a_up[:, :cd].reshape(w_aup.shape), w_aup):
        raise AssertionError(f"{what}: the da stage's a_up differs from its plain "
                             f"stage's")
    e_sums = 0.0
    if sc_down is not None:
        stol = 1e-4 if dt == torch.float32 else 5e-3
        e_sums = max(close_sums(f"{what} da stage sd", sdse[0], w_sd, stol),
                     close_sums(f"{what} da stage se", sdse[1], w_se, stol))
    dw = twice_equal(f"{what} dw stage", lambda: (dw_run(dh, a_up),))[0]
    e_sums = max(e_sums, close_sums(f"{what} dw stage", dw,
                                    chain_dw_reference(w_aup, want_dh), tol))
    return e_dz, e_sums


def compare_chain(gen, x, ws, gs, bs, pen, pool, final_relu, err, label,
                  need_dx=True, planted=False, residual=False, tag="", path=False):
    """Each pass of the chain against its plain version ON THE SAME INPUTS
    (the kernel chain's own tensors feed both: the passes are walked by the
    port's own _chain_forward and _chain_backward), each kernel twice and
    bit-equal. mm_stats / bnact_mm_stats: h by `close_act`, ssum and ssq 1e-4
    (fp32) or 1e-3 (bf16) relative, a stored residual r (write_r) exactly
    equal. bn_pool: out, maxv, amax and hsel exactly equal (the same rounded
    operations, lowest row on ties). chain_bwd_pass (and each of its three
    stages against its plain stage, `check_bwd_stages`): dzd by `close_act`; dw
    1e-4 / 1e-3 relative (dh is bit-equal on both sides, so dw differs by
    summation order only); sd and se 1e-4 (fp32) or 5e-3 (bf16) relative:
    they sum the rounded dzd, whose entries differ by a bf16 ulp where the
    order flipped a rounding, and the sums cancel. `residual`: PointMLP's
    residual chain (pen None): the residual adds, the stored block outputs
    and the skip shares of the backward. `planted`: the inputs are
    `chain_inputs`', whose ties are then checked (with pen, every call
    checks that exactly the groups without a valid row give -1e9). `path`:
    a driven path's own tensors, whose bf16 products must take the TMA +
    wgmma kernel (`fwd_plan`), never the tile kernel. Updates
    `err` (keys: the wrapper's name + `tag`) with the largest absolute
    errors (of h, out, dw); returns the forward's saved tensors (ws_c, hs,
    scs, rs, maxv, amax, hsel) and the pooled output."""
    from pointcloud_tpu_torch.ops import (
        bn_pool,
        bn_pool_reference,
        bnact_mm_stats,
        bnact_mm_stats_reference,
        chain_bwd_pass,
        chain_bwd_pass_reference,
        mm_stats,
        mm_stats_reference,
    )
    from pointcloud_tpu_torch.ops import preextract_fused as tpf

    (B, R, _), dt = x.shape, x.dtype
    tol = 1e-4 if dt == torch.float32 else 1e-3
    worst = {"stats": 0.0, "sums": 0.0, "dz": 0.0}

    def note(name, e):
        err[name + tag] = max(err.get(name + tag, 0.0), e)

    def product(name, fn, ref):
        def run(*a, **kw):
            w = a[-1]
            plan = tpf.fwd_plan(B * R, w.shape[0], w.shape[1], dt == torch.bfloat16,
                                name == "mm_stats", tpf.sm_count(x.device.index))
            if path and dt == torch.bfloat16 and not plan.panel_rows:
                raise AssertionError(f"{name} {label} {tuple(w.shape)}: a driven "
                                     f"path's product went to the tile kernel")
            got = twice_equal(name, lambda: fn(*a, **kw))
            want = ref(*a, **kw)
            note(name, close_act(f"{name} {label} {tuple(a[-1].shape)}", got[0],
                                 want[0]))
            worst["stats"] = max(worst["stats"],
                                 close_sums(f"{name} {label} ssum", got[1], want[1], tol),
                                 close_sums(f"{name} {label} ssq", got[2], want[2], tol))
            if len(got) == 4 and not torch.equal(got[3], want[3]):
                raise AssertionError(f"{name} {label}: the stored residual differs "
                                     f"from the plain version's")
            return got
        return run

    def pool_pass(*a, **kw):
        got = twice_equal("bn_pool", lambda: bn_pool(*a, **kw))
        want = bn_pool_reference(*a, **kw)
        for what, g, w in zip(("out", "maxv", "amax", "hsel"), got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"bn_pool {label}: {what} differs from the plain "
                                     f"version's")
        note("bn_pool", float((got[0].float() - want[0].float()).abs().max()))
        return got

    def bwd(*a, **kw):
        got = twice_equal("chain_bwd_pass", lambda: chain_bwd_pass(*a, **kw))
        want = chain_bwd_pass_reference(*a, **kw)
        what = f"chain_bwd_pass {label} {tuple(a[2].shape)}"
        if got[0] is not None:
            worst["dz"] = max(worst["dz"], close_act(f"{what} dzd", got[0], want[0]))
        if got[1] is not None:
            for g, w in zip(got[1:3], want[1:3]):
                worst["sums"] = max(worst["sums"], close_sums(
                    f"{what} sd/se", g, w, 1e-4 if dt == torch.float32 else 5e-3))
        worst["sums"] = max(worst["sums"], close_sums(f"{what} dw", got[3], want[3], tol))
        note("chain_bwd_pass", float((got[3] - want[3]).abs().max()))
        e_dz, e_sums = check_bwd_stages(a, kw, what)
        worst["dz"], worst["sums"] = max(worst["dz"], e_dz), max(worst["sums"], e_sums)
        return got

    passes = (product("mm_stats", mm_stats, mm_stats_reference),
              product("bnact_mm_stats", bnact_mm_stats, bnact_mm_stats_reference),
              pool_pass)
    out, _, saved = tpf._chain_forward(x, ws, gs, bs, pen, pool, final_relu, passes,
                                       residual)
    amax = saved[5]
    if planted and pool > 1 and bool((amax == pool - 1).any()):
        raise AssertionError(f"bn_pool {label}: a tie went to the higher row")
    if pen is not None:
        # -1e9 in every channel of a group without a valid row, and only there
        empty = ~(pen.view(B, R // pool, pool) == 0).any(dim=2)
        if not torch.equal(out.float() < -5e8, empty[..., None].expand_as(out)):
            raise AssertionError(f"bn_pool {label}: -1e9 must mark exactly the "
                                 f"groups without a valid row")
    dout = torch.randn(out.shape, generator=gen, device=x.device).to(dt)
    tpf._chain_backward(x, gs, saved, dout, pool, final_relu, need_dx, bwd, residual)
    log(f"  chain {label} {str(dt)[6:]} B={B} R={R} pool={pool} layers "
        f"{[tuple(w.shape) for w in ws]} {'residual' if residual else 'plain'}, "
        f"final_relu={final_relu}: h within tolerance, ssum/ssq rel "
        f"{worst['stats']:.1e}; bn_pool equal; backward (whole passes and each "
        f"stage: dh and a_up bit-equal) dzd max |err| {worst['dz']:.1e}, sd/se/dw "
        f"rel {worst['sums']:.1e}; every kernel twice bit-equal")
    return saved, out


def check_chain(gen, B, R, layout, pool, dtype, masked, final_relu, err,
                residual=False, tag=""):
    """The four passes on `chain_inputs` (residual: no pen), then the whole
    `mlp_pool_fused` or `preextract_pool_fused` (forward and backward through
    autograd) against the composition of its own wrappers: bit-equal, being
    the same launches."""
    from pointcloud_tpu_torch.ops import mlp_pool_fused, preextract_pool_fused

    x, ws, gs, bs, pen = chain_inputs(gen, B, R, layout, dtype, pool, masked)
    if residual:
        pen = None
    label = f"Cin={layout[0][0]}"
    _, pooled = compare_chain(gen, x, ws, gs, bs, pen, pool, final_relu, err, label,
                              planted=True, residual=residual, tag=tag)
    leaves = [t.clone().requires_grad_() for t in (x, *ws, *gs, *bs)]
    L = len(ws)

    def whole():
        args = (leaves[0], leaves[1:1 + L], leaves[1 + L:1 + 2 * L], leaves[1 + 2 * L:])
        out, stats = (preextract_pool_fused(*args, pool) if residual
                      else mlp_pool_fused(*args, pen, pool, final_relu))
        grads = torch.autograd.grad(out.float().sum(), leaves)
        return [out, *[t for pair in stats for t in pair], *grads]

    res = twice_equal("preextract_pool_fused" if residual else "mlp_pool_fused", whole)
    if not torch.equal(res[0], pooled) or res[1].requires_grad:
        raise AssertionError(f"fused chain {label}: the chain disagrees with its "
                             f"passes, or its statistics carry a gradient")
    if not all(g.dtype == t.dtype and bool(torch.isfinite(g).all())
               for g, t in zip(res[1 + 2 * L:], leaves)):
        raise AssertionError(f"fused chain {label}: bad gradients")


def check_ball_group_grad(gen, B, N, S, k, F, dtype, radius):
    """The gradient of ball_group on the card (one scatter_rows launch)
    against the same function on the CPU (its plain forward and plain
    scatter) and, in fp32, against autograd through ball_group_reference on
    the card; the backward twice, bit-equal. fp32 gradients 1e-5 relative
    (summation order); bf16 feature gradients within one bf16 ulp (fp32 sums
    of the bf16 cotangent, rounded once on both sides). Returns the largest
    absolute error."""
    from pointcloud_tpu_torch.ops import ball_group, ball_group_reference

    dev = torch.device("cuda")
    xyz = torch.rand((B, N, 3), generator=gen, device=dev)
    feats = torch.randn((B, N, F), generator=gen, device=dev).to(dtype)
    cents = xyz[:, :: N // S][:, :S].clone()
    cents[:, -1] += 5.0  # an empty ball
    mask = torch.rand((B, N), generator=gen, device=dev) > 0.33
    cw = torch.randn((B, S, k, 3 + F), generator=gen, device=dev)

    def grads(fn, d):
        leaves = [t.detach().to(d).clone().requires_grad_() for t in (xyz, feats, cents)]
        g = fn(*leaves, mask.to(d), k, radius)[0]
        return list(torch.autograd.grad((g.float() * cw.to(d)).sum(), leaves))

    before = dict(read_counts())
    got = twice_equal("ball_group backward", lambda: grads(ball_group, dev))
    after = read_counts()
    if (after["ball_group"] - before["ball_group"],
            after["scatter_rows"] - before["scatter_rows"]) != (2, 2):
        raise AssertionError("ball_group's gradient must take one ball_group and "
                             "one scatter_rows launch")
    refs = [grads(ball_group, "cpu")]
    if dtype == torch.float32:
        refs.append(grads(ball_group_reference, dev))
    worst = 0.0
    for want in refs:
        for name, g, w in zip(("xyz", "feats", "new_xyz"), got, want):
            w = w.to(dev)
            worst = max(worst, float((g.float() - w.float()).abs().max()))
            if g.dtype != w.dtype:
                raise AssertionError(f"ball_group d{name}: dtype {g.dtype}")
            if w.dtype == torch.bfloat16:
                ok = (g.float() - w.float()).abs() <= bf16_ulp(w) + 1e-6
            else:
                ok = (g - w).abs() <= 1e-5 * w.abs().max()
            if not bool(ok.all()):
                raise AssertionError(f"ball_group gradient of {name} differs "
                                     f"({dtype}, k={k})")
    log(f"  ball_group gradient B={B} N={N} S={S} k={k} F={F} {str(dtype)[6:]}: "
        f"d xyz, d feats, d new_xyz equal to the CPU path's"
        f"{' and to autograd through the plain version' if len(refs) > 1 else ''} "
        f"within tolerance (max |err| {worst:.1e}); two runs bit-equal; one "
        f"scatter_rows launch per backward")
    return worst


def chain_bounds(rows, groups, cd, cu, es, sparse, down_bn, need_dzd=True,
                 res=False, write_r=False, pen=True, skip=None):
    """(forward product, pool pass over cu channels, backward pass) bounds of
    one layer: bytes with every tensor read or written once, operations at
    the dense bf16 tensor-core rate (2 rows cd cu a product; the pool's ~6
    fp32 operations an element on the CUDA cores). The residual chain's
    extras: `res` reads a residual tensor of the layer input's width (the
    pool's: cu), `write_r` writes the layer input, `pen` (the masked pool)
    reads a penalty a row, `skip` adds a pooled ("pool": groups x cd
    cotangents and rows) or dense ("dense": rows x cd) share to da."""
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
    """Bounds of one backward pass's three stages, each reading its inputs
    and writing its outputs once (dh and a_up between them): dh (5 fp32
    operations an element), da (2 rows cd cu at the dense bf16 rate; below a
    BatchNorm it reads h_{u-1} and writes dzd and a_up, the residual and
    skip shares not counted), dw (2 rows cd cu)."""
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


def time_chain(x, ws, gs, bs, pen, pool, fwd, need_dx, level, residual=False):
    """Each launch of one level's (or stage's) chain at the path's own tensors
    (`fwd` from compare_chain), walked as the chain walks them: kernel,
    plain version, a library yardstick (bf16 matmul +
    F.batch_norm(training=True) + ReLU [+ the residual add] + amax, and
    autograd through them; timed here, never called by the port) and the
    bound (each product pass, each backward pass and their library
    yardsticks over 10 calls after 2 warm-ups); each backward pass also as its three stages alone (dh, da,
    dw, 10 calls each), beside their bounds. Returns rows of (kernel name,
    layer, ms, plain ms, library ms, (bound ms, by))."""
    import torch.nn.functional as F

    from pointcloud_tpu_torch.ops import (
        bn_pool,
        bn_pool_reference,
        bnact_mm_stats,
        bnact_mm_stats_reference,
        chain_bwd_pass,
        chain_bwd_pass_reference,
        mm_stats,
        mm_stats_reference,
    )
    from pointcloud_tpu_torch.ops import preextract_fused as tpf
    from pointcloud_tpu_torch.ops.preextract_fused import EPS

    saved, out = fwd
    ws_c, hs, scs, rs, maxv, amax, hsel = saved
    (B, R, _), L, dt = x.shape, len(ws), x.dtype
    rows, groups, es = B * R, B * R // pool, x.element_size()

    def sums(h):
        hf = h.float()
        return h, hf.sum(dim=(0, 1)), (hf * hf).sum(dim=(0, 1))

    def bn(h, u):  # train-mode BatchNorm of layer u over all rows, in dt
        return F.batch_norm(h.reshape(rows, -1), None, None, gs[u].to(dt),
                            bs[u].to(dt), True, 0.0, EPS).reshape(h.shape)

    def lib_res(res):  # the residual as the library forms it
        if res is None:
            return 0.0
        return torch.relu(bn(res[0], 0)) if isinstance(res, tuple) else res

    out_rows = []
    for u in range(L):
        cd, cu = ws[u].shape
        if u:
            res = tpf._layer_residual(u, L, residual, hs, scs, rs)
            write_r = residual and u % 2 == 1 and (u + 1) // 2 >= 2
            args, kw = (hs[u - 1], scs[u - 1], ws_c[u]), dict(res=res, write_r=write_r)
            ms = cuda_ms(lambda: bnact_mm_stats(*args, **kw), iters=10, warmup=2)
            plain = cuda_ms(lambda: bnact_mm_stats_reference(*args, **kw), iters=1,
                            warmup=1)
            lib = cuda_ms(lambda: sums(torch.matmul(
                torch.relu(bn(hs[u - 1], u - 1) + lib_res(res)), ws_c[u])), iters=10,
                warmup=2)
            bnd = chain_bounds(rows, groups, cd, cu, es, False, True,
                               res=res is not None, write_r=write_r)[0]
        else:
            ms = cuda_ms(lambda: mm_stats(x, ws_c[0]), iters=10, warmup=2)
            plain = cuda_ms(lambda: mm_stats_reference(x, ws_c[0]), iters=1, warmup=1)
            lib = cuda_ms(lambda: sums(torch.matmul(x, ws_c[0])), iters=10, warmup=2)
            bnd = chain_bounds(rows, groups, cd, cu, es, False, False)[0]
        out_rows.append(("bnact_mm_stats" if u else "mm_stats", u, ms, plain, lib, bnd))
    cl = ws[-1].shape[1]
    pool_res = None
    if residual:
        pool_res = (hs[0], scs[0]) if L == 3 else rs[(L - 1) // 2 - 2]
    pkw = dict(res=pool_res)
    ms = cuda_ms(lambda: bn_pool(hs[-1], scs[-1], pen, pool, **pkw), iters=5)
    plain = cuda_ms(lambda: bn_pool_reference(hs[-1], scs[-1], pen, pool, **pkw),
                    iters=1, warmup=1)
    pen4 = 0.0 if pen is None else pen.reshape(B, R // pool, pool, 1)
    lib = cuda_ms(lambda: torch.relu(torch.amax(
        (bn(hs[-1], L - 1) + lib_res(pool_res)).reshape(B, R // pool, pool, cl).float()
        - pen4, dim=2)), iters=2, warmup=1)
    out_rows.append(("bn_pool", L - 1, ms, plain, lib, chain_bounds(
        rows, groups, 1, cl, es, False, True, res=residual, pen=pen is not None)[1]))

    layer = [L]
    splits = {}

    def timed_bwd(*a, **kw):
        """One backward pass, timed three ways, and its three stages alone;
        returns the kernel's result."""
        layer[0] -= 1
        u = layer[0]
        h_up, _, w, a_in, sc_down = a
        cd, cu = w.shape
        res = chain_bwd_pass(*a, **kw)
        ms = cuda_ms(lambda: chain_bwd_pass(*a, **kw), iters=10, warmup=2)
        _, dh_run, da_run, dw_run = bwd_stages(a, kw)
        dh = dh_run()
        a_up = da_run(dh)[2]
        splits[u] = [cuda_ms(fn, iters=10, warmup=2) for fn in (
            dh_run, lambda: da_run(dh), lambda: dw_run(dh, a_up))]
        del dh, a_up
        plain = cuda_ms(lambda: chain_bwd_pass_reference(*a, **kw), iters=1, warmup=1)
        # library: autograd through relu(bn + res) -> matmul -> batch_norm for
        # the same cotangent, to the tensor below and to w
        need = kw.get("need_dzd", True)
        leaf = (a_in if u == 0 else torch.relu(bn(a_in, u - 1)
                                               + lib_res(kw.get("res")))).detach()
        leaf.requires_grad_(need)
        wl = w.detach().clone().requires_grad_()
        y = bn(torch.matmul(torch.relu(leaf) if u else leaf, wl), u)
        sparse = "dosel" in kw
        if sparse:
            cot = torch.zeros((B, R // pool, pool, cu), dtype=dt, device=x.device)
            cot.scatter_(2, kw["amax"].long()[:, :, None, :],
                         kw["dosel"].to(dt)[:, :, None, :])
            cot = cot.reshape(B, R, cu)
        else:
            cot = kw["dz"]
        wrt = (leaf, wl) if need else (wl,)
        lib = cuda_ms(lambda: torch.autograd.grad(y, wrt, cot, retain_graph=True),
                      iters=10, warmup=2)
        del y, leaf, cot
        skip = ("pool" if "skip_pool" in kw else "dense" if "skip_dense" in kw
                else None)
        out_rows.append(("chain_bwd_pass", u, ms, plain, lib, chain_bounds(
            rows, groups, cd, cu, es, sparse, sc_down is not None, need,
            res=kw.get("res") is not None, skip=skip)[2]))
        return res

    dout = torch.randn(out.shape, device=x.device).to(dt)
    tpf._chain_backward(x, gs, saved, dout, pool, True, need_dx, timed_bwd, residual)
    for name, u, ms, plain, lib, bnd in out_rows:
        cd, cu = ws[u].shape
        shape = f"C={cu} pool={pool}" if name == "bn_pool" else f"{cd}->{cu}"
        split = ""
        if name in ("mm_stats", "bnact_mm_stats"):
            p = tpf.fwd_plan(rows, cd, cu, dt == torch.bfloat16, u == 0,
                             tpf.sm_count(x.device.index))
            split = (f" | plan: panels of {p.panel_rows} rows, {p.wn} channels a "
                     f"consumer, {p.stages} stages, {p.slots} slots, {p.chunks} "
                     f"chunks, {p.smem} B" if p.panel_rows else " | tile kernel")
        if name == "chain_bwd_pass":
            sb = bwd_stage_bounds(rows, groups, cd, cu, es, u == L - 1, u > 0,
                                  u > 0 or need_dx)
            split = " | stages dh / da / dw " + " / ".join(
                f"{t:.3f} ms (bound {b[0]:.3f})" for t, b in zip(splits[u], sb))
        log(f"  {level} {name} layer {u} rows={rows} {shape}: kernel {ms:.3f} ms | "
            f"plain {plain:.3f} ms | library {lib:.3f} ms | bound {bnd[0]:.3f} ms "
            f"({bnd[1]}){split}")
    return out_rows


def time_scatters(scattered, label, err):
    """Each recorded `scatter_rows(g, idx, n)` call of a path (its grouping
    gradients, at the path's own rows) against its plain version (1e-4
    relative, two runs bit-equal), timed beside it, the library's
    `index_add_` (atomics; timed here, never called by the port) and the
    bound, the kernel and the library over 10 calls after 2 warm-ups.
    Returns rows of (shape, ms, plain ms, library ms, (bound ms, by))."""
    from pointcloud_tpu_torch.ops import scatter_rows, scatter_rows_reference

    dev = torch.device("cuda")
    out = []
    for (g, idx, n), _ in scattered:
        got = twice_equal("scatter_rows", lambda: (scatter_rows(g, idx, n),))[0]
        want = scatter_rows_reference(g, idx, n)
        e = rel_err(got, want)
        err["scatter_rows"] = max(err["scatter_rows"],
                                  float((got - want).abs().max()))
        if e > 1e-4:
            raise AssertionError(f"scatter_rows at {label} differs by {e:.2e} rel")
        Bs, R, C = g.shape
        off = (idx.long() + torch.arange(Bs, device=dev)[:, None] * n).reshape(-1)
        src = g.reshape(-1, C).float()
        t = (cuda_ms(lambda: scatter_rows(g, idx, n), iters=10, warmup=2),
             cuda_ms(lambda: scatter_rows_reference(g, idx, n), iters=2, warmup=1),
             cuda_ms(lambda: torch.zeros((Bs * n, C), device=dev).index_add_(
                 0, off, src), iters=10, warmup=2),
             bound(Bs * R * C, Bs * R * (C * g.element_size() + 4) + Bs * n * C * 4,
                   PEAK_FP32_FLOPS))
        dev_ms = sum(kernel_split(lambda: scatter_rows(g, idx, n)).values())
        log(f"  scatter_rows at {label}, B={Bs} R={R} -> n={n} C={C} "
            f"{str(g.dtype)[6:]}: rel err {e:.2e}, two runs bit-equal; kernel "
            f"{t[0]:.3f} ms ({dev_ms:.4f} device, trace) | plain {t[1]:.3f} ms | "
            f"library index_add_ {t[2]:.3f} ms | bound {t[3][0]:.4f} ms ({t[3][1]})")
        out.append(((Bs, R, n, C), *t))
        del got, want, off, src
    torch.cuda.empty_cache()
    return out


def pointnet2_train_path(seed, gen, x_raw, smi, err):
    """The PointNet2 train path at full width with its launch counts; the
    four chain kernels held against their plain versions at SA1, SA2 and
    SA3 of that batch and timed there beside them, the library yardstick
    and their bounds; the step's parts and each level's forward and
    backward. Returns the launch counts and the timing rows of each level."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.train import (
        create_model,
        make_optimizer,
        make_train_step,
    )

    dev = torch.device("cuda")
    log(f"[PointNet2 train path] make_train_step, Autoencoder / PointNet2 / "
        f"Chamfer, B={B_PN2} x 2048 x 6, bf16, Adam lr {cfg.vision_lr}")
    spec = create_model("Autoencoder", "PointNet2", "Cube",
                        loss_override="chamfer", device=dev, seed=seed)
    opt = make_optimizer(spec)
    step = make_train_step(spec, opt)
    xt = x_raw[:B_PN2].contiguous()
    tr = drive_train(step, xt, xt, TRAIN_ITERS)
    counts, losses, first_loss = tr["counts"], tr["losses"], tr["first_loss"]
    first_s, ms_step, per_iter, peak = (tr["first_s"], tr["ms"], tr["per_iter"],
                                        tr["peak"])
    per_step = dict(fps=2, ball_group=2, mm_stats=3, bnact_mm_stats=6, bn_pool=3,
                    chain_bwd_pass=9, scatter_rows=1, nn_sweep=1, chamfer_bwd=1)
    expect_counts("PointNet2 train path", counts,
                  **{k: v * TRAIN_ITERS for k, v in per_step.items()})
    log(f"  train step B={B_PN2}: warm-up step {first_s:.3f} s; {TRAIN_ITERS} "
        f"chained steps {ms_step:.3f} ms/step on the host clock -> "
        f"{B_PN2 / (ms_step / 1e3):.1f} clouds/s; event-to-event median "
        f"{per_iter[TRAIN_ITERS // 2]:.3f} ms (min {per_iter[0]:.3f}, max "
        f"{per_iter[-1]:.3f}); peak memory {peak:.2f} GiB | {smi}")
    log(f"  losses: warm-up {float(first_loss):.6f}, then "
        f"{', '.join(f'{v:.6f}' for v in losses)}; launches {counts}")
    log(f"  the host alone enqueues a step in {tr['enqueue_ms']:.3f} ms")
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite PointNet2 train loss {losses}")
    # Adam's first update (every entry moves by ~lr) raises this model's loss
    # from its initial value; it falls over the chained steps that follow
    if not losses[-1] < losses[0]:
        raise AssertionError("the PointNet2 train loss did not fall over the "
                             f"{TRAIN_ITERS} steps")
    bb = spec.model.encoder.backbone
    for name, buf in bb.named_buffers():
        if not bool(torch.isfinite(buf).all()) or bool((buf == (
                1.0 if "var" in name else 0.0)).all()):
            raise AssertionError(f"running statistic {name} did not move")
    trace_steps(step, xt, xt, ms_step, f"PointNet2 train step, B={B_PN2}",
                tr["enqueue_ms"])

    fwd_ms, bwd_ms, opt_ms = step_parts(spec, opt, xt, xt)
    log(f"  train step parts (median of 3, CUDA events): forward + loss "
        f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, Adam {opt_ms:.3f} ms")
    # one more step, recording SA2's grouping gradient on its way to
    # scatter_rows (SA1's grouped features are the input: no gradient)
    with recording(sys.modules["pointcloud_tpu_torch.ops.ball_group"],
                   "scatter_rows") as scattered:
        step(xt, xt)
    if len(scattered) != per_step["scatter_rows"]:
        raise AssertionError(f"the PointNet2 step scattered {len(scattered)} times")
    scatters = time_scatters(scattered, f"SA2's grouping gradient of the B={B_PN2} "
                             f"step", err)
    del scattered
    opt.zero_grad(set_to_none=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    xn = spec.in_transform(xt)[0]

    # each level alone: forward in train mode and the backward of its output
    xyz = xn[..., :3].contiguous()
    feats = xn[..., 3:]
    levels, level_ms = [], []
    for i in range(3):
        sa = getattr(bb, f"SetAbstraction_{i}")
        fin = feats.detach().requires_grad_(i > 0)
        times = []
        for _ in range(3):
            ev[0].record()
            new_xyz, out, _ = sa(xyz, fin, train=True)
            ev[1].record()
            wrt = [*sa.parameters(), *([fin] if i else [])]
            torch.autograd.grad(out, wrt, torch.ones_like(out))
            ev[2].record()
            torch.cuda.synchronize()
            times.append([ev[j].elapsed_time(ev[j + 1]) for j in range(2)])
        level_ms.append([sorted(t[j] for t in times)[1] for j in range(2)])
        with torch.no_grad():
            _, grouped, gmask, _ = sa.group(xyz, feats)
            B, S, K, cin = grouped.shape
            levels.append((
                grouped.reshape(B, S * K, cin).to(torch.bfloat16).contiguous(),
                [getattr(sa, f"w{j}").detach() for j in range(3)],
                [getattr(sa, f"scale{j}").detach() for j in range(3)],
                [getattr(sa, f"offset{j}").detach() for j in range(3)],
                torch.where(gmask.reshape(B, S * K), 0.0, 1e9), K))
        xyz, feats = new_xyz, out.detach()
    log("  SA levels alone (median of 3, CUDA events, ms): " + ", ".join(
        f"SA{i + 1} forward {f:.3f} backward {b:.3f}"
        for i, (f, b) in enumerate(level_ms)))
    del spec, opt, step, xn, fin, out, grouped, gmask
    torch.cuda.empty_cache()

    rows = {}
    for i, (x, ws, gs, bs, pen, K) in enumerate(levels):
        level = f"SA{i + 1}"
        fwd = compare_chain(gen, x, ws, gs, bs, pen, K, True, err,
                            f"{level} of the B={B_PN2} batch", need_dx=i > 0,
                            path=True)
        torch.cuda.empty_cache()
        rows[level] = time_chain(x, ws, gs, bs, pen, K, fwd, i > 0, level)
        levels[i] = None
        del fwd, x, ws, gs, bs, pen
        torch.cuda.empty_cache()
    for name in ("mm_stats", "bnact_mm_stats", "bn_pool", "chain_bwd_pass"):
        tot = [sum(r[j] for lv in rows.values() for r in lv if r[0] == name)
               for j in (2, 3, 4)]
        bnd = sum(r[5][0] for lv in rows.values() for r in lv if r[0] == name)
        log(f"  {name}, its {per_step[name]} launches of one step together: kernel "
            f"{tot[0]:.3f} ms | plain {tot[1]:.3f} ms | library {tot[2]:.3f} ms | "
            f"bound {bnd:.3f} ms")
    return {"counts": counts, "rows": rows, "scatters": scatters}


def card_vs_cpu_pointnet2_train(seed, x_raw):
    """The fp32 PointNet2 model's train step on the card and on the CPU, from
    the same weights, on two clouds: SA1's FPS indices equal; the first
    step's loss 1e-5 relative; every first-step gradient within 1e-3 relative
    plus 1e-3 of its tensor's largest entry. The gradients of SetAbstraction_0
    and _1 pass two max-pools whose best two rows can lie within round-off of
    each other, where card and CPU may send a pooled gradient to different
    rows (tests/test_torch_pointnet2_train_slice.py measures such flips at
    percent of a weight gradient). This seed's two clouds have no such flip
    (NVIDIA H100: 1.4e-4 there, 1.0e-4 elsewhere), so they get no slack; a
    seed that has one fails here and names the tensor. Losses of 3 steps 3e-3
    relative (Adam's first step amplifies round-off entries, as in that
    test)."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import chamfer as tchamfer
    from pointcloud_tpu_torch.ops import farthest_point_sample
    from pointcloud_tpu_torch.train import (
        create_model,
        make_optimizer,
        make_train_step,
    )

    cfg.precision = "fp32"
    try:
        specs = [create_model("Autoencoder", "PointNet2", "Cube",
                              loss_override="chamfer", device=d, seed=seed)
                 for d in ("cuda", "cpu")]
    finally:
        cfg.precision = "bf16-mixed"
    xs = x_raw[:2]
    idx = [farthest_point_sample(
        sp.in_transform(xs.to(d))[0][..., :3].contiguous(), 512)
        for sp, d in zip(specs, ("cuda", "cpu"))]
    if not torch.equal(idx[0].cpu(), idx[1]):
        raise AssertionError("PointNet2 SA1 FPS indices differ, card vs CPU")
    losses, grads = [], []
    for spec, d in zip(specs, ("cuda", "cpu")):
        step = make_train_step(spec, make_optimizer(spec))
        xd = xs.to(d)
        ls = []
        with recording(tchamfer, "nn_sweep") as nn_calls:
            for i in range(3):
                ls.append(float(step(xd, xd)[0]))
                if i == 0:
                    grads.append({k: p.grad.detach().float().cpu()
                                  for k, p in spec.model.named_parameters()})
        if d == "cuda":
            nn_expansion_error(*(t.detach() for t in nn_calls[0][0][:2]),
                               "the fp32 PointNet2 first train step's Chamfer inputs")
        losses.append(ls)
    worst = {"before": 0.0, "past": 0.0}  # the two pooled levels, the rest
    for k, want in grads[1].items():
        e = (grads[0][k] - want).abs()
        big = float(want.abs().max())
        pooled = "SetAbstraction_0" in k or "SetAbstraction_1" in k
        if pooled and big <= 1e-6:
            continue  # the last offset's true gradient is 0: round-off
        where = "before" if pooled else "past"
        worst[where] = max(worst[where], float(e.max()) / big)
        if float((e - 1e-3 * want.abs() - 1e-3 * big).max()) > 0:
            raise AssertionError(f"{k}: card vs CPU gradient differs, max err "
                                 f"{float(e.max()) / big:.2e} of its largest entry")
    l_gpu, l_cpu = losses
    if abs(l_gpu[0] - l_cpu[0]) > 1e-5 * l_cpu[0] or any(
            abs(a - b) > 3e-3 * b for a, b in zip(l_gpu, l_cpu)):
        raise AssertionError(f"card vs CPU PointNet2 train losses {l_gpu} vs {l_cpu}")
    log(f"  PointNet2 fp32 train step, card vs CPU, B=2: SA1 FPS indices equal; "
        f"losses {l_gpu} vs {l_cpu}; first-step gradients max rel err "
        f"{worst['past']:.2e} (SetAbstraction_2, MLP, decoder), "
        f"{worst['before']:.2e} (SetAbstraction_0 and _1, through the pools)")


def sinkhorn_bound(B, N, M, iters):
    """The larger of: one ex2 a pair in each of the 2 iters sweeps, on the
    special-function units; the exponent's least fp32 work a pair of a
    sweep, 3 FMAs and an add by the expansion of the distance (7 operations;
    the kernel spends 3 subtractions and 4 FMAs to keep direct differences),
    and ~10 operations a pair of the last pass, on the CUDA cores; bytes
    (both clouds' xyz read once, dists and assignment written once)."""
    pairs = B * N * M
    t_sfu = 2 * iters * pairs / PEAK_SFU_OPS * 1e3
    t_rest, by = bound((7 * 2 * iters + 10) * pairs,
                       B * (N + M) * 12 + B * N * 8, PEAK_FP32_FLOPS)
    return (t_sfu, "operations") if t_sfu >= t_rest else (t_rest, by)


def sweep_sass_loop():
    """(instructions, ex2) of the common path of the main loop of sinkhorn's
    sweep_kernel in the built library's SASS (cuobjdump -sass): of the spans
    from a backward branch's target to the branch, the shortest of those
    holding the most ex2, less the blocks a forward branch in it skips that
    hold an FMNMX (the rescaling path: a chunk's maximum, taken when its sum
    passes 2^64)."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from pointcloud_tpu_torch.ops import _build

    sass = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass",
                           str(_build.library_path("sinkhorn"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if "12sweep_kernel" in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2)) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    best = None
    for at, text in ins:
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= at:
            span = [(a, t) for a, t in ins if int(m.group(1), 16) <= a <= at]
            ex2 = sum("MUFU.EX2" in t for _, t in span)
            if ex2 and (best is None or (-ex2, len(span)) < (-best[1], len(best[0]))):
                best = (span, ex2)
    if best is None:
        raise AssertionError("no loop with an ex2 in sweep_kernel's SASS")
    span, cold = best[0], set()
    for a, t in span:
        m = re.search(r"@!?U?P\d\s+BRA\s+(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) > a:
            skipped = [b for b, u in span if a < b < int(m.group(1), 16)]
            if any("FMNMX" in u for b, u in span if b in skipped):
                cold.update(skipped)
    hot = [t for a, t in span if a not in cold]
    return len(hot), sum("MUFU.EX2" in t for t in hot)


def fps_step_sass(threads, slots):
    """The step loop of fps_block_kernel<threads, slots> in the built
    library's SASS (cuobjdump -sass): the backward branch's span that holds a
    barrier. Returns its instruction count and the counts of barriers,
    redux.sync, shared-memory loads and stores, and fp32 instructions."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from pointcloud_tpu_torch.ops import _build

    sass = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass",
                           str(_build.library_path("fps"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    tag = f"16fps_block_kernelILi{threads}ELi{slots}EE"
    body = next(f for f in sass.split("Function : ")[1:]
                if tag in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2)) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = []
    for at, text in ins:
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= at:
            span = [t for a, t in ins if int(m.group(1), 16) <= a <= at]
            if any("BAR.SYNC" in t for t in span):
                loops.append(span)
    if not loops:
        raise AssertionError(f"no loop with a barrier in {tag}'s SASS")
    span = min(loops, key=len)
    count = {"BAR": "BAR.SYNC", "REDUX": "REDUX", "LDS": "LDS", "STS": "STS"}
    out = {k: sum(v in t for t in span) for k, v in count.items()}
    out["fp32"] = sum(bool(re.search(r"\b(FADD|FMUL|FFMA|FMNMX|FSETP|FSEL)\b", t))
                      for t in span)
    out["all"] = len(span)
    return out


def compare_sinkhorn(x, y, eps, iters, anneal, label, err, share=0.995):
    """sinkhorn vs sinkhorn_reference on the same clouds, the kernel twice
    and bit-equal. The kernel's potentials differ from the plain version's by
    rounding (ex2.approx, another summation order) and the matching is an
    argmax, so a row whose two best scores lie within that round-off may go
    to another target: at least `share` of the rows must have equal
    assignments, on every other row the kernel's target must score within
    1e-6 of the best (float64 scores from the plain version's potentials),
    and dists agree within 1e-6 where the assignments do. Returns the
    kernel's (dists, assignment) and the share of equal rows."""
    from pointcloud_tpu_torch.ops import (
        eps_schedule,
        matching_difference,
        sinkhorn,
        sinkhorn_reference,
    )

    got = twice_equal("sinkhorn", lambda: sinkhorn(x, y, eps, iters, anneal))
    *want, f, g = sinkhorn_reference(x, y, eps_schedule(eps, iters, anneal))
    same, gap, d_err = matching_difference(x, y, f, g, got, want)
    rows = got[1].numel()
    if not (got[0].shape == got[1].shape == x.shape[:2]
            and got[1].dtype == torch.int32 and int(got[1].min()) >= 0
            and int(got[1].max()) < y.shape[1] and float(got[0].min()) >= 0.0):
        raise AssertionError(f"sinkhorn {label}: malformed outputs")
    if same < share or gap > 1e-6 or d_err > 1e-6:
        raise AssertionError(
            f"sinkhorn {label}: {same:.5f} of {rows} rows equal (need {share}), "
            f"largest score gap on the others {gap:.2e}, dists off by {d_err:.2e}")
    err["sinkhorn"] = max(err["sinkhorn"], d_err)
    log(f"  sinkhorn {label} B={x.shape[0]} N={x.shape[1]} M={y.shape[1]} "
        f"C={x.shape[2]} eps={eps} x {iters}"
        f"{'' if anneal is None else f' from {anneal}'}: "
        f"{round((1 - same) * rows)} of {rows} rows to another target (largest "
        f"score gap {gap:.1e}); dists max |err| {d_err:.1e} elsewhere; two runs "
        f"bit-equal")
    return got, same


def check_sinkhorn(gen, B, N, M, C, eps, iters, anneal, err, identical=False,
                   share=0.995):
    """compare_sinkhorn on unit-cube clouds; `identical`: y = x, where the
    assignment must be the identity and every distance at most 1e-6."""
    dev = torch.device("cuda")
    x = torch.rand((B, N, C), generator=gen, device=dev)
    y = x.clone() if identical else torch.rand((B, M, C), generator=gen, device=dev)
    (d, a), _ = compare_sinkhorn(x, y, eps, iters, anneal,
                                 "identical clouds" if identical else "random",
                                 err, share)
    if identical and not (torch.equal(a, torch.arange(N, device=dev, dtype=torch.int32)
                                      .expand(B, N)) and float(d.max()) <= 1e-6):
        raise AssertionError("sinkhorn on identical clouds must give the identity")


def drive_eval(step, x0, iters, y0=None):
    """A first call of an eval step on (x0, x0), then `iters` calls chained
    on the previous loss, with the launch counts set to 0 before and read
    after. With `y0` the target is y0 throughout (a labelled cloud or a
    dict of states) and only the input is chained."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    loss, logs, out = step(x0, x0 if y0 is None else y0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    x = x0
    t0 = time.perf_counter()
    events[0].record()
    for i in range(iters):
        x = x + loss * 1e-9  # chained on the previous loss, as bench.py
        loss, logs, out = step(x, x if y0 is None else y0)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"first_s": first_s, "ms": wall / iters * 1e3, "loss": loss, "logs": logs,
            "out": out, "x": x, "counts": read_counts(),
            "per_iter": sorted(events[i].elapsed_time(events[i + 1])
                               for i in range(iters)),
            "peak": torch.cuda.max_memory_allocated() / 2**30}


def drive_train(step, x, y, iters):
    """A warm-up train step, then `iters` chained steps on the fixed batch
    (x, y) with the launch counts set to 0 before them and read after. Then
    the host's own time to enqueue one step on an idle card (median of 3
    more steps, the clock stopped before the synchronize): where it nears the
    step's time the host, not the card, sets the pace."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first_loss, _ = step(x, y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    zero_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(iters):
        loss, logs = step(x, y)  # chained: each step reads the last's weights
        losses.append(loss)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    host = []  # the host's own time for a step: an idle card, no synchronize
    for _ in range(3):
        t1 = time.perf_counter()
        step(x, y)
        host.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
    return {"first_s": first_s, "first_loss": float(first_loss),
            "ms": wall / iters * 1e3, "enqueue_ms": sorted(host)[1],
            "losses": [float(v) for v in losses],
            "logs": logs, "counts": counts,
            "per_iter": sorted(events[i].elapsed_time(events[i + 1])
                               for i in range(iters)),
            "peak": torch.cuda.max_memory_allocated() / 2**30}


def step_parts(spec, opt, x, y):
    """Forward + loss, backward and Adam of one train step (median of 3,
    CUDA events around the same calls as the step)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = []
    for _ in range(3):
        ev[0].record()
        xn, _ = spec.in_transform(x)
        yn, _ = spec.out_transform(y)
        tl = spec.loss(spec.model(xn, train=True), yn)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        tl.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    return [sorted(p[i] for p in parts)[1] for i in range(3)]


def report_train(label, B, tr, want_logs, smi, must_fall=True):
    """Print a drive_train result; fail on a non-finite loss, on a loss that
    does not fall (unless not `must_fall`), or on missing log keys. Under
    EMD the matching changes from step to step and Adam's first updates
    raise the loss before it falls, so single steps are noisy: falling means
    that the last three chained steps average below the first three."""
    n = len(tr["losses"])
    log(f"  train step B={B}: warm-up step {tr['first_s']:.3f} s; {n} chained "
        f"steps {tr['ms']:.3f} ms/step on the host clock -> "
        f"{B / (tr['ms'] / 1e3):.1f} clouds/s; event-to-event median "
        f"{tr['per_iter'][n // 2]:.3f} ms (min {tr['per_iter'][0]:.3f}, max "
        f"{tr['per_iter'][-1]:.3f}); the host alone enqueues a step in "
        f"{tr['enqueue_ms']:.3f} ms; peak memory {tr['peak']:.2f} GiB | {smi}")
    log(f"  losses: warm-up {tr['first_loss']:.6f}, then "
        f"{', '.join(f'{v:.6f}' for v in tr['losses'])}; logs "
        f"{ {k: round(float(v.detach()), 6) for k, v in tr['logs'].items()} }; "
        f"launches {tr['counts']}")
    if not all(torch.isfinite(torch.tensor(tr["losses"]))):
        raise AssertionError(f"{label}: non-finite train loss {tr['losses']}")
    if must_fall and not sum(tr["losses"][-3:]) < sum(tr["losses"][:3]):
        raise AssertionError(f"{label}: the train loss did not fall over the steps")
    if set(tr["logs"]) != want_logs:
        raise AssertionError(f"{label}: logged {sorted(tr['logs'])}")


def emd_paths(seed, gen, x_raw, smi, err):
    """The Earth Mover's Distance paths at full width, each with its launch
    counts: the PointNet autoencoder with its default loss (eval and train
    steps at B=128), the Segmenter (one eval step and the train steps at B=64,
    target xyz + a class label) and the PointNet2 autoencoder and segmenter
    with EMD (one eval and one train step each at B=64); the Sinkhorn kernel at the B=128 path's own inputs against
    its plain version, timed beside it, the library formulation
    (`emd.sinkhorn_match`: a stored cost and torch.logsumexp; timed here,
    never called by the port on the card) and its bound, at the training and
    at the eval operating point. Returns the numbers of the kernel's
    `kernels` entry."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import (
        eps_schedule,
        sinkhorn,
        sinkhorn_match,
        sinkhorn_plan,
        sinkhorn_reference,
    )
    from pointcloud_tpu_torch.train import (
        create_model,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    dev = torch.device("cuda")
    ae_logs = {"train_loss/EMD", "train_loss/feature"}
    seg_logs = ae_logs | {"train_loss/cross_entropy", "train_loss/kl_divergence"}

    log(f"[EMD eval path] Autoencoder / PointNet / default EMD loss (eps "
        f"{cfg.emd_eps} x {cfg.emd_iterations}), scene Cube, B={B_EMD} x 2048 x 6, "
        f"bf16")
    spec = create_model("Autoencoder", "PointNet", "Cube", device=dev, seed=seed)
    xe = x_raw[:B_EMD].contiguous()
    ev = drive_eval(make_eval_step(spec), xe, ITERS)
    expect_counts("EMD eval path", ev["counts"], sinkhorn=ITERS + 1)
    log(f"  eval step B={B_EMD}: first call {ev['first_s']:.3f} s; {ITERS} chained "
        f"steps {ev['ms']:.3f} ms/step on the host clock -> "
        f"{B_EMD / (ev['ms'] / 1e3):.1f} clouds/s; event-to-event median "
        f"{ev['per_iter'][ITERS // 2]:.3f} ms (min {ev['per_iter'][0]:.3f}, max "
        f"{ev['per_iter'][-1]:.3f}); peak memory {ev['peak']:.2f} GiB | {smi}")
    log(f"  loss {float(ev['loss']):.6f}; logs "
        f"{ {k: round(float(v), 6) for k, v in ev['logs'].items()} }; launches "
        f"{ev['counts']}")
    out = ev["out"]
    if not bool(torch.isfinite(ev["loss"])) or out.shape != (B_EMD, 2048, 6) \
            or not bool(torch.isfinite(out).all()) or set(ev["logs"]) != ae_logs:
        raise AssertionError(f"EMD eval: loss {ev['loss']}, out {tuple(out.shape)}, "
                             f"logs {sorted(ev['logs'])}")
    trace_steps(make_eval_step(spec), xe, xe, ev["ms"], f"PointNet + EMD eval step, "
                f"B={B_EMD}")

    # the kernel at the path's own inputs: the decoder's output against its
    # target, at the training and at the eval operating point
    y = spec.out_transform(ev["x"])[0]
    kern = {}
    for point, (eps, iters, anneal) in (
            ("train", (cfg.emd_eps, cfg.emd_iterations, None)),
            ("eval", (cfg.emd_eval_eps, cfg.emd_eval_iterations, cfg.emd_anneal_from))):
        compare_sinkhorn(out, y, eps, iters, anneal,
                         f"at the B={B_EMD} path's inputs, {point} point", err)
        torch.cuda.empty_cache()
        sched = eps_schedule(eps, iters, anneal)
        k_ms = cuda_ms(lambda: sinkhorn(out, y, eps, iters, anneal), iters=5)
        p_ms = cuda_ms(lambda: sinkhorn_reference(out, y, sched), iters=1, warmup=0)
        l_ms = cuda_ms(lambda: sinkhorn_match(out[..., :3], y[..., :3], eps, iters,
                                              anneal), iters=1, warmup=1)
        bnd = sinkhorn_bound(B_EMD, out.shape[1], y.shape[1], iters)
        kern[point] = (k_ms, p_ms, bnd, l_ms)
        torch.cuda.empty_cache()
        plan = sinkhorn_plan(B_EMD, out.shape[1], y.shape[1])
        log(f"  sinkhorn B={B_EMD} N=M=2048, {point} point (eps {eps} x {iters}"
            f"{'' if anneal is None else f' from {anneal}'}; {2 * iters + 1} CUDA "
            f"launches a call; {plan.outputs} outputs a thread, q split "
            f"{plan.split_x} / {plan.split_y}, {plan.blocks_x} / {plan.blocks_y} "
            f"blocks a cloud): kernel {k_ms:.3f} ms | plain {p_ms:.1f} ms | library "
            f"emd.sinkhorn_match (stored cost, torch.logsumexp) {l_ms:.1f} ms | "
            f"bound {bnd[0]:.3f} ms ({bnd[1]}: one ex2 a pair at "
            f"{PEAK_SFU_OPS:.3g}/s)")
    del out, y, ev
    torch.cuda.empty_cache()

    log(f"[EMD train path] make_train_step, Autoencoder / PointNet / default EMD "
        f"loss, B={B_EMD} x 2048 x 6, bf16, Adam lr {cfg.vision_lr}")
    opt = make_optimizer(spec)
    tstep = make_train_step(spec, opt)
    tr = drive_train(tstep, xe, xe, TRAIN_ITERS)
    expect_counts("EMD train path", tr["counts"], sinkhorn=TRAIN_ITERS,
                  dense_pool_stats=3 * TRAIN_ITERS,
                  dense_pool_stats_bwd=3 * TRAIN_ITERS)
    report_train("EMD train path", B_EMD, tr, ae_logs, smi)
    trace_steps(tstep, xe, xe, tr["ms"], f"PointNet + EMD train step, B={B_EMD}",
                tr["enqueue_ms"])
    fwd_ms, bwd_ms, opt_ms = step_parts(spec, opt, xe, xe)
    log(f"  train step parts (median of 3, CUDA events): forward + loss "
        f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, Adam {opt_ms:.3f} ms")
    pool_fwd_yardstick(gen, spec.model.encoder.backbone.dbnpool2, xe, spec,
                       f"the B={B_EMD} EMD train path's own input", err)
    del spec, opt, tstep
    torch.cuda.empty_cache()

    spec = create_model("Segmenter", "PointNet", "Cube", device=dev, seed=seed)
    classes = len(spec.scene.classes)
    log(f"[Segmenter train path] make_train_step, Segmenter / PointNet / EMD with "
        f"{classes} classes, B={B_SEG} x 2048, bf16; target xyz + a class label")
    xs = x_raw[:B_SEG].contiguous()
    labels = torch.randint(0, classes, (B_SEG, xs.shape[1], 1), generator=gen,
                           device=dev).float()
    ys = torch.cat([xs[..., :3], labels], dim=-1)
    zero_counts()
    loss, logs, seg_out = make_eval_step(spec)(xs, ys)
    torch.cuda.synchronize()
    expect_counts("Segmenter eval step", read_counts(), sinkhorn=1)
    if not bool(torch.isfinite(loss)) or set(logs) != seg_logs \
            or seg_out.shape != (B_SEG, 2048, 3 + classes) \
            or not bool(torch.isfinite(seg_out).all()) \
            or float(seg_out[..., :3].min()) < 0 or float(seg_out[..., :3].max()) > 1:
        raise AssertionError(f"Segmenter eval: loss {loss}, out {tuple(seg_out.shape)}")
    log(f"  eval step: loss {float(loss):.6f}; xyz in the unit cube, {classes} raw "
        f"logits a point")
    opt = make_optimizer(spec)
    tstep = make_train_step(spec, opt)
    sg = drive_train(tstep, xs, ys, TRAIN_ITERS)
    expect_counts("Segmenter train path", sg["counts"], sinkhorn=TRAIN_ITERS,
                  dense_pool_stats=3 * TRAIN_ITERS,
                  dense_pool_stats_bwd=3 * TRAIN_ITERS)
    report_train("Segmenter train path", B_SEG, sg, seg_logs, smi)
    trace_steps(tstep, xs, ys, sg["ms"], f"Segmenter train step, B={B_SEG}",
                sg["enqueue_ms"])
    fwd_ms, bwd_ms, opt_ms = step_parts(spec, opt, xs, ys)
    log(f"  train step parts (median of 3, CUDA events): forward + loss "
        f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, Adam {opt_ms:.3f} ms")
    del spec, opt, tstep
    torch.cuda.empty_cache()

    log(f"[PointNet2 + EMD] Autoencoder and Segmenter / PointNet2 / EMD, B={B_SEG} x "
        f"2048, bf16: one eval and one train step each")
    pn2_step = dict(fps=2, ball_group=2, mm_stats=3, bnact_mm_stats=6, bn_pool=3,
                    chain_bwd_pass=9, scatter_rows=1, sinkhorn=1)
    for model_type, target, want_logs in (("Autoencoder", xs, ae_logs),
                                          ("Segmenter", ys, seg_logs)):
        spec = create_model(model_type, "PointNet2", "Cube", device=dev, seed=seed)
        zero_counts()
        loss, logs, out = make_eval_step(spec)(xs, target)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"{model_type} / PointNet2 + EMD eval step", counts, fps=2,
                      ball_group=2, sinkhorn=1)
        if not bool(torch.isfinite(loss)) or out.shape[:2] != (B_SEG, 2048) \
                or set(logs) != want_logs:
            raise AssertionError(f"{model_type} / PointNet2 + EMD eval: loss {loss}")
        log(f"  {model_type} eval step: loss {float(loss):.6f}; launches {counts}")
        tstep = make_train_step(spec, make_optimizer(spec))
        zero_counts()
        loss, logs = tstep(xs, target)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"{model_type} / PointNet2 + EMD train step", counts, **pn2_step)
        if not bool(torch.isfinite(loss)) or set(logs) != want_logs:
            raise AssertionError(f"{model_type} / PointNet2 + EMD train: loss {loss}")
        log(f"  {model_type} train step: loss {float(loss):.6f}; launches {counts}")
        del spec, tstep, out
    torch.cuda.empty_cache()
    return {"counts": tr["counts"], "sinkhorn": kern["train"]}



B_MLP = 32  # bench.py's PointMLP batch
K_MLP = 24  # neighbours a group at every PointMLP stage


def check_knn_group(gen, B, N, S, k, F, dtype, masked, with_xyz, ties=False,
                    offset=0, route=None):
    """knn_group vs knn_group_reference: idx and the gathered rows equal
    (the same penalised distances, the same (distance, index) order, exact
    gathers), the kernel twice. Centroids on every (N // S)-th point; with
    masks ~30% of the points masked, cloud 1 under-full (3 valid points) and
    cloud 2 without a valid point (every slot repeats slot 0). `ties`: every
    fourth point copies the one before it (exact distance ties); `offset`:
    the features start `offset` elements past an aligned base; `route`: the
    plan's route the shape must take. Returns the largest |grouped error|
    (0)."""
    from pointcloud_tpu_torch.ops import knn_group, knn_group_plan, knn_group_reference

    dev = torch.device("cuda")
    xyz = torch.rand((B, N, 3), generator=gen, device=dev)
    if ties:
        xyz[:, 3::4] = xyz[:, 2::4][:, :xyz[:, 3::4].shape[1]]
    feats = None
    if F:
        flat = torch.randn(B * N * F + offset, generator=gen, device=dev).to(dtype)
        feats = flat[offset:].view(B, N, F)
    if route is not None:
        row = F * (2 if dtype == torch.bfloat16 else 4)
        word = next(w for w in (16, 8, 4, 2)
                    if row % w == 0 and (feats is None or feats.data_ptr() % w == 0))
        plan = knn_group_plan(B, N, S, k, F, dtype, word, with_xyz)
        if plan.route != route:
            raise AssertionError(f"knn_group B={B} N={N} S={S} k={k}: route "
                                 f"{plan.route}, expected {route}")
    cents = xyz[:, :: max(1, N // S)][:, :S].contiguous()
    mask = None
    if masked:
        mask = torch.rand((B, N), generator=gen, device=dev) > 0.3
        mask[1] = False
        mask[1, [0, N // 2, N - 1]] = True
        mask[2] = False
    got = twice_equal("knn_group", lambda: tuple(
        t for t in knn_group(xyz, feats, cents, mask, k, with_xyz) if t is not None))
    want = tuple(t for t in knn_group_reference(xyz, feats, cents, mask, k, with_xyz)
                 if t is not None)
    if len(got) != len(want) or not all(
            a.dtype == w.dtype and torch.equal(a, w) for a, w in zip(got, want)):
        raise AssertionError(f"knn_group differs from the plain version (B={B} N={N} "
                             f"S={S} k={k} F={F} {dtype} masked={masked} "
                             f"xyz={with_xyz})")
    idx = got[-1]
    if masked and not (bool((idx[1, :, min(3, k):] == idx[1, :, :1]).all())
                       and bool((idx[2] == idx[2, :, :1]).all())):
        raise AssertionError("knn_group: slots past the valid count must repeat slot 0")
    log(f"  knn_group B={B} N={N} S={S} k={k} F={F} {str(dtype)[6:]} masked={masked} "
        f"xyz={with_xyz}{' ties' if ties else ''}"
        f"{f' base +{offset}' if offset else ''}{f' ({route})' if route else ''}: idx "
        f"and rows equal to the plain version's; two runs bit-equal")
    return 0.0 if len(got) == 1 else max(
        float((a.float() - w.float()).abs().max()) for a, w in zip(got[:-1], want[:-1]))


def check_knn_group_grad(gen, B, N, S, k, F, dtype, with_xyz):
    """The gradient of knn_group on the card (one scatter_rows launch)
    against the same function on the CPU and, in fp32, against autograd
    through knn_group_reference on the card; the backward twice, bit-equal.
    Tolerances as check_ball_group_grad. Returns the largest absolute
    error."""
    from pointcloud_tpu_torch.ops import knn_group, knn_group_reference

    dev = torch.device("cuda")
    xyz = torch.rand((B, N, 3), generator=gen, device=dev)
    feats = torch.randn((B, N, F), generator=gen, device=dev).to(dtype)
    cents = xyz[:, :: N // S][:, :S].contiguous()
    mask = torch.rand((B, N), generator=gen, device=dev) > 0.33
    cws = [torch.randn((B, S, k, c), generator=gen, device=dev)
           for c in ((3, F) if with_xyz else (F,))]

    def grads(fn, d):
        leaves = [t.detach().to(d).clone().requires_grad_() for t in (xyz, feats)]
        gx, gf, _ = fn(*leaves, cents.to(d), mask.to(d), k, with_xyz)
        outs = ([gx] if with_xyz else []) + [gf]
        loss = sum((o.float() * cw.to(d)).sum() for o, cw in zip(outs, cws))
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [g for g in got if g is not None]

    before = dict(read_counts())
    got = twice_equal("knn_group backward", lambda: grads(knn_group, dev))
    after = read_counts()
    if (after["knn_group"] - before["knn_group"],
            after["scatter_rows"] - before["scatter_rows"]) != (2, 2):
        raise AssertionError("knn_group's gradient must take one knn_group and one "
                             "scatter_rows launch")
    refs = [grads(knn_group, "cpu")]
    if dtype == torch.float32:
        refs.append(grads(knn_group_reference, dev))
    worst = 0.0
    for want in refs:
        if len(want) != len(got):
            raise AssertionError("knn_group: gradients of other inputs than the CPU's")
        for g, w in zip(got, want):
            w = w.to(dev)
            worst = max(worst, float((g.float() - w.float()).abs().max()))
            if g.dtype != w.dtype:
                raise AssertionError(f"knn_group gradient dtype {g.dtype}")
            if w.dtype == torch.bfloat16:
                ok = (g.float() - w.float()).abs() <= bf16_ulp(w) + 1e-6
            else:
                ok = (g - w).abs() <= 1e-5 * w.abs().max()
            if not bool(ok.all()):
                raise AssertionError(f"knn_group gradient differs ({dtype}, k={k})")
    log(f"  knn_group gradient B={B} N={N} S={S} k={k} F={F} {str(dtype)[6:]} "
        f"xyz={with_xyz}: equal to the CPU path's"
        f"{' and to autograd through the plain version' if len(refs) > 1 else ''} "
        f"within tolerance (max |err| {worst:.1e}); two runs bit-equal; one "
        f"scatter_rows launch per backward")
    return worst


def grouping_route_checks(gen, err):
    """knn_group and group_gather at both sides of every route boundary of
    their plans: the list capacity (k = 32 / 33 / 64 / 65), the shared /
    global switch (the largest cloud each plan stages, and one point more),
    feature rows of 2, 6, 66 and 640 bytes, a feature base 2 bytes past a
    16-byte boundary (2-byte words), S not a multiple of a block's
    centroids, exact ties, masks, a fully masked cloud, an empty ball,
    with_xyz both ways; exactly equal to the plain versions, two runs
    bit-equal."""
    from pointcloud_tpu_torch.ops import group_gather_plan, knn_group_plan
    from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT

    bf, f32 = torch.bfloat16, torch.float32
    # the largest clouds the two plans stage at these shapes
    most_knn = (SMEM_LIMIT - knn_group_plan(3, 96, 20, 24, 3, bf, 2).smem
                + 16 * 96) // 512 * 32
    most_gg = (SMEM_LIMIT - group_gather_plan(2, 512, 20, 64, 640, 16, False).smem
               + 16 * 512) // 16
    err["knn_group"] = max(
        err.get("knn_group", 0.0),
        check_knn_group(gen, 3, 300, 40, 32, 16, bf, True, True, ties=True, route="list"),
        check_knn_group(gen, 3, 300, 40, 33, 16, bf, True, False, ties=True, route="list"),
        check_knn_group(gen, 3, 300, 40, 64, 16, f32, True, True, route="list"),
        check_knn_group(gen, 3, 300, 40, 65, 16, f32, True, True, ties=True,
                        route="rounds"),
        check_knn_group(gen, 3, most_knn, 20, 24, 3, bf, True, False, route="list"),
        check_knn_group(gen, 3, most_knn + 1, 20, 24, 3, bf, True, False,
                        route="global"),
        check_knn_group(gen, 3, 500, 37, 24, 1, bf, False, True, ties=True),  # 2-byte rows
        check_knn_group(gen, 3, 500, 37, 24, 33, bf, True, False),  # 66-byte rows
        check_knn_group(gen, 3, 700, 300, 24, 320, bf, True, True),  # 640-byte rows
        check_knn_group(gen, 3, 700, 300, 24, 320, bf, False, False, offset=1),
        check_knn_group(gen, 3, 2048, 1000, 24, 64, bf, True, False, ties=True))
    err["group_gather"] = max(
        err.get("group_gather", 0.0),
        check_group_gather(gen, 2, most_gg, 20, 64, 320, bf, True, 0.2, False,
                           route="shared"),
        check_group_gather(gen, 2, most_gg + 1, 20, 64, 320, bf, True, 0.2, False,
                           route="global"),
        check_group_gather(gen, 3, 2048, 37, 16, 1, bf, True, 0.1, True),  # 2-byte rows
        check_group_gather(gen, 3, 2048, 300, 32, 3, bf, True, 0.2, True),  # 6-byte rows
        check_group_gather(gen, 3, 512, 100, 64, 33, bf, False, 0.3, False),  # 66-byte
        check_group_gather(gen, 3, 512, 129, 128, 320, bf, True, 0.8, True),  # 640-byte
        check_group_gather(gen, 3, 512, 129, 32, 320, bf, False, 0.4, True, offset=1),
        check_group_gather(gen, 3, 2048, 512, 128, 3, f32, False, 0.4, False))


def knn_library(xyz, feats, cents, k):
    """cdist + topk + gather, storing the (B, S, N) distance matrix: timed as
    a yardstick, never called by the port (topk does not promise the
    kernel's tie order)."""
    idx = torch.topk(torch.cdist(cents, xyz).square(), k, dim=-1,
                     largest=False).indices
    B, S, _ = idx.shape
    rows = torch.gather(feats, 1, idx.reshape(B, S * k, 1).expand(-1, -1, feats.shape[2]))
    return rows.reshape(B, S, k, -1), idx


def knn_bound(B, N, S, k, F, esize):
    """Bytes: xyz, features and centroids read once, the grouped rows and
    idx written once. Operations: every (centroid, point) pair is a distance
    test, 9 fp32 instructions as ball_bound counts them, at the issue rate
    PEAK_FP32_ISSUE."""
    return bound(9.0 * B * S * N,
                 B * N * 3 * 4 + B * N * F * esize + B * S * 3 * 4
                 + B * S * k * (F * esize + 4), PEAK_FP32_ISSUE)


def pointmlp_stage_inputs(bb, xn):
    """(xyz, feats, new_xyz) of each stage's kNN grouping in one eval forward
    of the backbone `bb` (the kernels outside any counted window)."""
    from pointcloud_tpu_torch.ops import farthest_point_sample, index_points

    got = []

    def grab(module, args):
        xyz, feats, groups = args[:3]
        new_xyz = index_points(xyz, farthest_point_sample(xyz, groups))
        got.append((xyz, feats.contiguous(), new_xyz))

    hooks = [getattr(bb, f"LocalGrouper_{i}").register_forward_pre_hook(grab)
             for i in range(bb.n_stages)]
    try:
        with torch.inference_mode():
            bb(xn)
    finally:
        for h in hooks:
            h.remove()
    return got


def pointmlp_stage_times(bb, xn):
    """CUDA-event times (ms) of each part of the backbone's eval forward at
    the batch of xn: the embedding, then per stage the grouper (FPS, the kNN
    kernel, the normalisation), PreExtraction and PosExtraction."""
    parts = {}
    with torch.inference_mode():
        parts["embed"] = cuda_ms(lambda: bb.DenseBNAct_0(xn[..., :3]), iters=5)
        xyz = xn[..., :3].float().contiguous()
        feats = bb.DenseBNAct_0(xn[..., :3])
        groups = xyz.shape[1]
        for i in range(bb.n_stages):
            groups //= bb.reducers[i]
            lg, pre, pos = (getattr(bb, f"{n}_{i}") for n in
                            ("LocalGrouper", "PreExtraction", "PosExtraction"))
            parts[f"S{i + 1} grouper"] = cuda_ms(lambda: lg(xyz, feats, groups),
                                                 iters=5)
            xyz, grouped, _ = lg(xyz, feats, groups)
            parts[f"S{i + 1} pre"] = cuda_ms(lambda: pre(grouped), iters=5)
            h = pre(grouped)
            parts[f"S{i + 1} pos"] = cuda_ms(lambda: pos(h), iters=5)
            feats = pos(h)
            del grouped, h
    return parts


def knn_margins(xyz, k=K_MLP):
    """Smallest relative gap between each centroid's k-th and (k+1)-th
    float64 squared distance, over every PointMLP stage of the clouds xyz
    (B, N, 3) (FPS on the CPU, halving at every stage)."""
    from pointcloud_tpu_torch.ops import fps_reference, index_points

    xyz = xyz.detach().cpu().float()
    worst = 1.0
    for _ in range(4):
        cents = index_points(xyz, fps_reference(xyz, xyz.shape[1] // 2))
        d = torch.cdist(cents.double(), xyz.double()).square()
        two = torch.topk(d, k + 1, dim=-1, largest=False).values[..., k - 1:]
        worst = min(worst, float(((two[..., 1] - two[..., 0])
                                  / two[..., 1].clamp_min(1e-30)).min()))
        xyz = cents
    return worst


def card_vs_cpu_pointmlp(seed, x_raw, bf):
    """The fp32 PointMLP autoencoder's eval step (Chamfer) on the card and on
    the CPU from the same weights, at B=2 clouds whose every stage keeps each
    centroid's 24th and 25th distances 1e-5 apart (relative): FPS and kNN
    indices equal at every stage, outputs within 1e-4, the loss within 1e-5;
    the loss of `bf`, the bf16 model from the same seed, within 5% of
    fp32's."""
    import copy
    import dataclasses

    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import farthest_point_sample, knn_group
    from pointcloud_tpu_torch.train import create_model, make_eval_step

    cfg.precision = "fp32"
    try:
        cpu = create_model("Autoencoder", "PointMLP", "Cube", loss_override="chamfer",
                           device="cpu", seed=seed)
    finally:
        cfg.precision = "bf16-mixed"
    # the same fp32 modules on the card (drawing the weights again costs
    # seconds on the host)
    specs = [dataclasses.replace(cpu, model=copy.deepcopy(cpu.model).cuda()), cpu]
    for start in range(0, 16, 2):
        xs = x_raw[start:start + 2]
        margin = knn_margins(specs[1].in_transform(xs.cpu())[0][..., :3])
        if margin > 1e-5:
            break
    else:
        raise AssertionError("no pair of clouds keeps its kNN sets 1e-5 apart")
    idx = []
    for sp, d in zip(specs, ("cuda", "cpu")):
        got = []
        for xyz, feats, new_xyz in pointmlp_stage_inputs(
                sp.model.encoder.backbone, sp.in_transform(xs.to(d))[0]):
            got.append(farthest_point_sample(xyz, new_xyz.shape[1]))
            got.append(knn_group(xyz, feats, new_xyz, None, K_MLP)[2])
        idx.append(got)
    if len(idx[0]) != 8 or not all(torch.equal(a.cpu(), b)
                                   for a, b in zip(*idx)):
        raise AssertionError("PointMLP FPS or kNN indices differ, card vs CPU")
    (l_gpu, _, o_gpu), (l_cpu, _, o_cpu) = (
        make_eval_step(sp)(xs.to(d), xs.to(d))
        for sp, d in zip(specs, ("cuda", "cpu")))
    e_out = float((o_gpu.cpu() - o_cpu).abs().max())
    e_loss = abs(float(l_gpu) - float(l_cpu))
    l_bf = float(make_eval_step(bf)(xs, xs)[0])
    bf_loss = abs(l_bf - float(l_gpu)) / float(l_gpu)
    log(f"  PointMLP fp32 eval step, card vs CPU, B=2 (clouds {start}, "
        f"{start + 1}: kNN margin {margin:.2e}): FPS and kNN indices equal at all "
        f"4 stages; max |out err| {e_out:.2e}, |loss err| {e_loss:.2e}; bf16 "
        f"model's loss vs fp32 rel diff {bf_loss:.2e}")
    if e_out > 1e-4 or e_loss > 1e-5:
        raise AssertionError("fp32 PointMLP on the card disagrees with the CPU")
    if bf_loss > 0.05:
        raise AssertionError("bf16 PointMLP loss is > 5% off the fp32 one")


def pointmlp_paths(seed, gen, x_raw, smi):
    """The PointMLP eval paths at full width, each with exact launch counts:
    PointMLP with Chamfer and PointMLP-Elite with its default EMD loss at
    B=32 (eval steps, the stage-by-stage encoder time, `encode`), and the
    Segmenter on PointMLP-Elite at B=8 (one eval step, counts only);
    knn_group at every stage of the B=32 path's own inputs against its
    plain version, timed (CUDA events over launches through the C entry)
    beside it, a library
    yardstick and its bound.
    Returns the numbers of the kernel's `kernels` entry and the bf16
    PointMLP spec."""
    from pointcloud_tpu_torch.ops import knn_group, knn_group_plan, knn_group_reference
    from pointcloud_tpu_torch.train import create_model, make_eval_step

    dev = torch.device("cuda")
    xb = x_raw[:B_MLP].contiguous()
    out = {}
    for backbone, loss_override, loss_kernel in (("PointMLP", "chamfer", "nn_sweep"),
                                                 ("PointMLPE", None, "sinkhorn")):
        log(f"[PointMLP eval path] Autoencoder / {backbone} / "
            f"{loss_override or 'default EMD'} loss, scene Cube, B={B_MLP} x 2048 "
            f"x 6, bf16")
        spec = create_model("Autoencoder", backbone, "Cube",
                            loss_override=loss_override, device=dev, seed=seed)
        ev = drive_eval(make_eval_step(spec), xb, ITERS)
        expect_counts(f"{backbone} eval path", ev["counts"], fps=4 * (ITERS + 1),
                      knn_group=4 * (ITERS + 1), **{loss_kernel: ITERS + 1})
        log(f"  eval step B={B_MLP}: first call {ev['first_s']:.3f} s; {ITERS} "
            f"chained steps {ev['ms']:.3f} ms/step on the host clock -> "
            f"{B_MLP / (ev['ms'] / 1e3):.1f} clouds/s; event-to-event median "
            f"{ev['per_iter'][ITERS // 2]:.3f} ms (min {ev['per_iter'][0]:.3f}, "
            f"max {ev['per_iter'][-1]:.3f}); peak memory {ev['peak']:.2f} GiB | {smi}")
        log(f"  loss {float(ev['loss']):.6f}; launches {ev['counts']}")
        o = ev["out"]
        if not bool(torch.isfinite(ev["loss"])) or o.shape != (B_MLP, 2048, 6) \
                or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{backbone} eval: loss {ev['loss']}, out "
                                 f"{tuple(o.shape)}")
        bb = spec.model.encoder.backbone
        with torch.inference_mode():
            xn = spec.in_transform(ev["x"])[0]
            parts = pointmlp_stage_times(bb, xn)
            enc_ms = cuda_ms(lambda: spec.model.encoder(xn), iters=5)
            h = spec.model.encoder(xn)
            dec_ms = cuda_ms(lambda: spec.model.decoder(h), iters=5)
        log(f"  encoder {enc_ms:.3f} ms, decoder {dec_ms:.3f} ms of the step; "
            f"encoder parts (CUDA events, ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f"; sum {sum(parts.values()):.3f}")

        with torch.inference_mode():
            one = spec.in_transform(x_raw[:1])[0]
            zero_counts()
            lat = host_ms(lambda: spec.model.encode(one), calls=20, warmup=5)
            enc_counts = read_counts()
            enc = spec.model.encode(one)
        expect_counts(f"{backbone} encode", enc_counts, fps=4 * 25, knn_group=4 * 25)
        if enc.shape != (1, 13) or not bool(torch.isfinite(enc).all()):
            raise AssertionError(f"{backbone} encode gave {tuple(enc.shape)}")
        log(f"  encode(1 cloud) -> {tuple(enc.shape)}; host clock, 20 calls after "
            f"5 warm-ups: median {lat[10]:.3f} ms, max {lat[-1]:.3f} ms; launches "
            f"{enc_counts}")
        with torch.inference_mode():
            trace_steps(lambda a, _: spec.model.encode(a), one, None, lat[10],
                        f"{backbone} encode, 1 cloud")

        # the kernel at every stage of this path's own inputs
        stages = pointmlp_stage_inputs(bb, xn)
        for st in range(4):
            sx, sf, sc = stages[st]
            args = (sx, sf, sc, None, K_MLP)
            got = knn_group(*args)
            want = knn_group_reference(*args)
            if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
                raise AssertionError(f"knn_group differs from the plain version at "
                                     f"{backbone} stage {st + 1}'s inputs")
            lib = knn_library(sx, sf, sc, K_MLP)
            same = float((torch.sort(lib[1], -1).values
                          == torch.sort(got[2].long(), -1).values).all(-1)
                         .float().mean())
            del got, want, lib
            torch.cuda.empty_cache()
            Bs, Ns, Ss, Fs = sx.shape[0], sx.shape[1], sc.shape[1], sf.shape[2]
            bnd = knn_bound(Bs, Ns, Ss, K_MLP, Fs, sf.element_size())
            # through the C entry: a wrapper call's host time passes the
            # card's at stages 3-4
            times = (cuda_ms(knn_direct(sx, sf, sc, K_MLP), iters=20),
                     cuda_ms(lambda: knn_group_reference(*args), iters=2, warmup=1),
                     cuda_ms(lambda: knn_library(sx, sf, sc, K_MLP), iters=3,
                             warmup=1), bnd)
            out[(backbone, st + 1)] = times
            log(f"  knn_group {backbone} stage {st + 1} B={Bs} N={Ns} S={Ss} "
                f"k={K_MLP} F={Fs} bf16 ({knn_group_plan(Bs, Ns, Ss, K_MLP, Fs, sf.dtype).route} "
                f"route): kernel {times[0]:.4f} ms | plain "
                f"{times[1]:.3f} ms | library cdist + topk + gather {times[2]:.3f} "
                f"ms ({same:.4f} of the groups the same set) | bound "
                f"{bnd[0]:.4f} ms ({bnd[1]})")
        out[backbone] = ev["counts"]
        if backbone == "PointMLP":
            out["spec"] = spec
        del spec, ev, o, xn, h, stages
        torch.cuda.empty_cache()

    log("[PointMLP Segmenter] Segmenter / PointMLPE / EMD, B=8 x 2048, bf16: one "
        "eval step")
    spec = create_model("Segmenter", "PointMLPE", "Cube", device=dev, seed=seed)
    classes = len(spec.scene.classes)
    xs = x_raw[:8].contiguous()
    labels = torch.randint(0, classes, (8, xs.shape[1], 1), generator=gen,
                           device=dev).float()
    zero_counts()
    loss, logs, seg_out = make_eval_step(spec)(xs, torch.cat([xs[..., :3], labels], -1))
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("Segmenter / PointMLPE eval step", counts, fps=4, knn_group=4,
                  sinkhorn=1)
    if not bool(torch.isfinite(loss)) or seg_out.shape != (8, 2048, 3 + classes):
        raise AssertionError(f"Segmenter / PointMLPE eval: loss {loss}")
    log(f"  eval step: loss {float(loss):.6f}; launches {counts}")
    del spec
    torch.cuda.empty_cache()
    return out


def pointmlp_kernel_checks(gen, err):
    """knn_group against its plain version at small odd shapes and at every
    stage's shape of the B=32 path (random inputs), and its gradient."""
    bf, f32 = torch.bfloat16, torch.float32
    err["knn_group"] = max(
        err.get("knn_group", 0.0),
        check_knn_group(gen, 3, 100, 12, 1, 7, f32, True, True),
        check_knn_group(gen, 3, 100, 12, 5, 0, f32, True, True),
        check_knn_group(gen, 3, 300, 40, 32, 16, bf, True, False),
        check_knn_group(gen, 3, 20, 4, 24, 3, f32, True, True),  # k > N
        check_knn_group(gen, 3, 1000, 77, 24, 33, bf, False, True),  # 2-byte rows
        check_knn_group(gen, 3, 20000, 64, 24, 8, bf, True, False),  # global path
        *(check_knn_group(gen, B_MLP, n, n // 2, K_MLP, f, bf, False, False)
          for n, fs in ((2048, (64, 32)), (1024, (128, 64)), (512, (256, 128)),
                        (256, (512, 256))) for f in fs))
    err["scatter_rows"] = max(
        err["scatter_rows"],
        check_knn_group_grad(gen, 3, 512, 64, 16, 6, f32, True),
        check_knn_group_grad(gen, 3, 512, 64, 24, 64, bf, False))


MLP_TRAIN_ITERS = 5  # chained PointMLP train steps after the warm-up step
RES = " (residual mode)"  # the err keys and `kernels` names of the residual passes


def pointmlp_train_kernel_checks(gen, err):
    """The residual chain's passes against their plain versions at small
    odd shapes: Elite's mid width 16 with a pool of 24 over 144 rows (a
    group straddles the 64-row tiles), two blocks with a pool of 24, three
    blocks (RES_DENSE inside the stack), PointMLP's stage-4 width 1024;
    fp32 and bf16; planted ties; then the whole preextract_pool_fused."""
    bf, f32 = torch.bfloat16, torch.float32
    elite = [(12, 64), (64, 16), (16, 64)]
    two = [(10, 16)] + [(16, 16)] * 4
    for dt in (f32, bf):
        check_chain(gen, 2, 72, elite, 24, dt, False, True, err, residual=True, tag=RES)
        check_chain(gen, 3, 48, two, 24, dt, False, True, err, residual=True, tag=RES)
    check_chain(gen, 1, 96, [(6, 8)] + [(8, 8)] * 6, 4, f32, False, True, err,
                residual=True, tag=RES)
    check_chain(gen, 2, 24 * 8, [(2048, 1024)] + [(1024, 1024)] * 4, 24, bf, False,
                True, err, residual=True, tag=RES)


def pre_extraction_inputs(bb, xn):
    """Each stage's PreExtraction input (B, G * K, D) in the activation dtype
    and its weights, scales and offsets, from one train-mode forward of the
    backbone `bb` without autograd (the kernels outside any counted
    window)."""
    got = []

    def grab(module, args):
        B, G, K, D = args[0].shape
        dt = module.dtype or args[0].dtype
        got.append((args[0].reshape(B, G * K, D).to(dt).contiguous(),
                    *[[getattr(module, f"{n}{i}").detach() for i in range(module.n_layers)]
                      for n in ("w", "scale", "offset")], K))

    hooks = [getattr(bb, f"PreExtraction_{i}").register_forward_pre_hook(grab)
             for i in range(bb.n_stages)]
    try:
        with torch.no_grad():
            bb(xn, train=True)
    finally:
        for h in hooks:
            h.remove()
    return got


def pointmlp_train_paths(seed, gen, x_raw, smi, err):
    """The PointMLP train paths at full width with exact launch counts:
    PointMLP with Chamfer and PointMLP-Elite with its default EMD loss at
    B=32 (a warm-up step and MLP_TRAIN_ITERS chained steps, the step's parts,
    a trace), every stage's residual chain held against its plain versions
    at that batch's own inputs, and both configurations' four stages timed
    beside the plain versions, the library yardstick and the bounds;
    PointMLP's four grouping gradients (`scatter_rows`, one a stage) held and
    timed at one more step's own inputs; one train step of the Segmenter on
    PointMLP-Elite at B=8 (counts only). Returns each path's counts, the
    timing rows by stage and the scatter rows."""
    from pointcloud_tpu_torch.train import create_model, make_optimizer, make_train_step

    dev = torch.device("cuda")
    xb = x_raw[:B_MLP].contiguous()
    out = {}
    for backbone, loss_override, loss_kernels in (
            ("PointMLP", "chamfer", dict(nn_sweep=1, chamfer_bwd=1)),
            ("PointMLPE", None, dict(sinkhorn=1))):
        label = f"{backbone} train step, B={B_MLP}"
        log(f"[PointMLP train path] make_train_step, Autoencoder / {backbone} / "
            f"{loss_override or 'default EMD'} loss, scene Cube, B={B_MLP} x 2048 x 6, "
            f"bf16")
        spec = create_model("Autoencoder", backbone, "Cube", loss_override=loss_override,
                            device=dev, seed=seed)
        opt = make_optimizer(spec)
        step = make_train_step(spec, opt)
        bb = spec.model.encoder.backbone
        layers = [getattr(bb, f"PreExtraction_{i}").n_layers for i in range(bb.n_stages)]
        per_step = dict(fps=4, knn_group=4, scatter_rows=4, mm_stats=4,
                        bnact_mm_stats=sum(layers) - 4, bn_pool=4,
                        chain_bwd_pass=sum(layers), **loss_kernels)
        tr = drive_train(step, xb, xb, MLP_TRAIN_ITERS)
        expect_counts(f"{backbone} train path", tr["counts"],
                      **{k: v * MLP_TRAIN_ITERS for k, v in per_step.items()})
        # a few steps from the random init: Adam's first updates may raise
        # the loss before it falls, so only its finiteness is required here
        report_train(label, B_MLP, tr, set() if loss_override else
                     {"train_loss/EMD", "train_loss/feature"}, smi, must_fall=False)
        for name, buf in bb.named_buffers():
            if not bool(torch.isfinite(buf).all()) or bool((buf == (
                    1.0 if "var" in name else 0.0)).all()):
                raise AssertionError(f"{backbone}: running statistic {name} did not move")
        trace_steps(step, xb, xb, tr["ms"], label, tr["enqueue_ms"])
        fwd_ms, bwd_ms, opt_ms = step_parts(spec, opt, xb, xb)
        log(f"  train step parts (median of 3, CUDA events): forward + loss "
            f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, Adam {opt_ms:.3f} ms")
        scatters = []
        if backbone == "PointMLP":
            # one more step, recording each stage's grouping gradient on its
            # way to scatter_rows (one a stage, at its feature width)
            with recording(sys.modules["pointcloud_tpu_torch.ops.scatter_rows"],
                           "scatter_rows") as scattered:
                step(xb, xb)
            if len(scattered) != per_step["scatter_rows"]:
                raise AssertionError(f"the {backbone} step scattered "
                                     f"{len(scattered)} times")
            scatters = time_scatters(scattered, f"a grouping gradient of the "
                                     f"{backbone} B={B_MLP} step", err)
            del scattered
        opt.zero_grad(set_to_none=True)
        stages = pre_extraction_inputs(bb, spec.in_transform(xb)[0])
        counts = tr["counts"]
        del spec, opt, step, tr
        torch.cuda.empty_cache()
        rows = {}
        for i in range(len(stages)):
            x, ws, gs, bs, K = stages[i]
            stage = f"{backbone} S{i + 1}"
            fwd = compare_chain(gen, x, ws, gs, bs, None, K, True, err,
                                f"{stage} of the B={B_MLP} batch", residual=True,
                                tag=RES, path=True)
            torch.cuda.empty_cache()
            rows[f"S{i + 1}"] = time_chain(x, ws, gs, bs, None, K, fwd, True, stage,
                                           residual=True)
            stages[i] = None
            del fwd, x, ws, gs, bs
            torch.cuda.empty_cache()
        for name in ("mm_stats", "bnact_mm_stats", "bn_pool", "chain_bwd_pass"):
            tot = [[sum(r[j] for r in lv if r[0] == name) for lv in rows.values()]
                   for j in (2, 3, 4)]
            bnd = [sum(r[5][0] for r in lv if r[0] == name) for lv in rows.values()]
            log(f"  {name}, its {per_step[name]} launches of one step by stage (ms, "
                f"S1 / S2 / S3 / S4): kernel {' / '.join(f'{v:.3f}' for v in tot[0])} | "
                f"plain {' / '.join(f'{v:.3f}' for v in tot[1])} | library "
                f"{' / '.join(f'{v:.3f}' for v in tot[2])} | bound "
                f"{' / '.join(f'{v:.3f}' for v in bnd)}")
        out[backbone] = {"counts": counts, "rows": rows, "scatters": scatters}

    log("[PointMLP Segmenter train] Segmenter / PointMLPE / EMD, B=8 x 2048, bf16: "
        "one train step")
    spec = create_model("Segmenter", "PointMLPE", "Cube", device=dev, seed=seed)
    classes = len(spec.scene.classes)
    xs = x_raw[:8].contiguous()
    labels = torch.randint(0, classes, (8, xs.shape[1], 1), generator=gen,
                           device=dev).float()
    step = make_train_step(spec, make_optimizer(spec))
    zero_counts()
    loss, logs = step(xs, torch.cat([xs[..., :3], labels], -1))
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("Segmenter / PointMLPE train step", counts, fps=4, knn_group=4,
                  scatter_rows=4, mm_stats=4, bnact_mm_stats=10, bn_pool=4,
                  chain_bwd_pass=14, sinkhorn=1)
    if not bool(torch.isfinite(loss)) or len(logs) != 4:
        raise AssertionError(f"Segmenter / PointMLPE train: loss {loss}, logs {logs}")
    log(f"  train step: loss {float(loss):.6f}; launches {counts}")
    del spec, step
    torch.cuda.empty_cache()
    return out


def card_vs_cpu_pointmlp_train(seed, x_raw):
    """The fp32 PointMLP autoencoder's train step (Chamfer) on the card and on
    the CPU from the same weights, at B=2 clouds of 512 points (at 2048 a
    stage's 1024 x 128 pools leave some within 1e-6) whose every stage keeps
    each centroid's 24th and 25th distances 1e-5 apart (relative) and every
    PreExtraction pool its best row 1e-6 above its runner-up (measured on
    the CPU's plain chain): FPS and kNN indices equal at every stage; the
    first loss 1e-5 relative; the first-step gradients within 2e-2 of the
    model's largest entry and the first update as
    tests/test_torch_pointmlp_train_slice.py holds it: every entry within 2
    lr, 1e-3 relative wherever the gradient is above 1% of its tensor's
    largest entry and 3e-2 of the model's (the final max over a stage-4
    channel's groups has gaps below the two devices' forward difference, so
    a few channels route their gradient to another group)."""
    import copy
    import dataclasses

    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import farthest_point_sample, knn_group
    from pointcloud_tpu_torch.ops import preextract_fused as tpf
    from pointcloud_tpu_torch.train import create_model, make_optimizer, make_train_step

    cfg.precision = "fp32"
    try:
        cpu = create_model("Autoencoder", "PointMLP", "Cube", loss_override="chamfer",
                           device="cpu", seed=seed)
    finally:
        cfg.precision = "bf16-mixed"
    init = copy.deepcopy(cpu.model)
    gaps, plain_pool = [], tpf.bn_pool_reference

    def recording_pool(h, sc, pen, pool, final_relu=True, res=None):
        v = tpf._with_residual(tpf._bn_pre(h, sc), res).reshape(
            h.shape[0], -1, pool, h.shape[2])
        best = v.amax(dim=2, keepdim=True)
        second = torch.where(v < best, v, -torch.inf).amax(dim=2, keepdim=True)
        gaps.append(float((best - second).min()))
        return plain_pool(h, sc, pen, pool, final_relu, res)

    plain = tpf._PLAIN
    tpf._PLAIN = (*plain[:2], recording_pool)
    try:
        for start in range(0, 16, 2):
            xs = x_raw[start:start + 2, :512].contiguous()
            margin = knn_margins(cpu.in_transform(xs.cpu())[0][..., :3])
            gaps.clear()
            with torch.no_grad():
                copy.deepcopy(init)(cpu.in_transform(xs.cpu())[0], train=True)
            if margin > 1e-5 and min(gaps) > 1e-6:
                break
        else:
            raise AssertionError("no pair of clouds keeps its kNN sets 1e-5 apart and "
                                 "its pools 1e-6 apart")
    finally:
        tpf._PLAIN = plain
    pool_gap = min(gaps)
    specs = [dataclasses.replace(cpu, model=copy.deepcopy(init).cuda()),
             dataclasses.replace(cpu, model=copy.deepcopy(init))]
    idx = []
    for sp, d in zip(specs, ("cuda", "cpu")):
        got = []
        for xyz, feats, new_xyz in pointmlp_stage_inputs(
                sp.model.encoder.backbone, sp.in_transform(xs.to(d))[0]):
            got.append(farthest_point_sample(xyz, new_xyz.shape[1]))
            got.append(knn_group(xyz, feats, new_xyz, None, K_MLP)[2])
        idx.append(got)
    if len(idx[0]) != 8 or not all(torch.equal(a.cpu(), b) for a, b in zip(*idx)):
        raise AssertionError("PointMLP FPS or kNN indices differ, card vs CPU")
    res = []
    for sp, d in zip(specs, ("cuda", "cpu")):
        before = {k: p.detach().cpu().clone() for k, p in sp.model.named_parameters()}
        loss, _ = make_train_step(sp, make_optimizer(sp))(xs.to(d), xs.to(d))
        res.append((float(loss), {k: p.grad.detach().cpu() for k, p in
                                  sp.model.named_parameters()},
                    {k: p.detach().cpu() - before[k] for k, p in
                     sp.model.named_parameters()}))
    (l_gpu, g_gpu, u_gpu), (l_cpu, g_cpu, u_cpu) = res
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst_g = max(float((g_gpu[k] - g).abs().max()) for k, g in g_cpu.items()) / top
    worst_u, n_sig = 0.0, 0
    for k, g in g_cpu.items():
        du = (u_gpu[k] - u_cpu[k]).abs()
        sig = (g.abs() > 1e-2 * g.abs().max()) & (g.abs() > 3e-2 * top)
        n_sig += int(sig.sum())
        # 2 lr plus the parameters' fp32 roundings
        if float(du.max()) > 2 * cfg.vision_lr + 1e-6 or bool(
                (du[sig] > 1e-3 * u_cpu[k].abs()[sig]).any()):
            raise AssertionError(f"PointMLP card vs CPU first update of {k} differs")
        if bool(sig.any()):
            worst_u = max(worst_u, float((du[sig] / u_cpu[k].abs()[sig]).max()))
    log(f"  PointMLP fp32 train step, card vs CPU, B=2 (clouds {start}, {start + 1}: "
        f"kNN margin {margin:.2e}, pool gap {pool_gap:.2e}): FPS and kNN indices equal "
        f"at all 4 stages; first loss {l_gpu:.7f} vs {l_cpu:.7f}; gradients max err "
        f"{worst_g:.2e} of the largest entry; first update {worst_u:.2e} rel on the "
        f"{n_sig} entries above the noise")
    if abs(l_gpu - l_cpu) > 1e-5 * l_cpu or worst_g > 2e-2 or n_sig == 0:
        raise AssertionError("fp32 PointMLP train step on the card disagrees with the "
                             "CPU")


B_MSG = 32  # the MSG slice's eval and train batch (bench.py's PointMLP batch)
# the card-vs-CPU pair: clouds 6 and 7 of the seed-0 batch, of its first four
# pairs the one whose fp32 train-mode pools keep the widest best-to-runner-up
# gap on the CPU (6.3e-7)
MSG_CVC_START = 6


def msg_spec(device, seed):
    """The TrainSpec of the multi-scale-grouping PointNet2 autoencoder,
    wired as create_model("Autoencoder", ..., "Cube", loss_override=
    "chamfer") wires the factory's backbones (the factory has no MSG entry,
    as the JAX package's has none)."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.data import PointCloudDataset
    from pointcloud_tpu_torch.envs.scenes import scene_config
    from pointcloud_tpu_torch.losses import ChamferDistance
    from pointcloud_tpu_torch.models import AE, PointNet2MSGEncoder
    from pointcloud_tpu_torch.models.layers import init_flax_
    from pointcloud_tpu_torch.train.harness import TrainSpec
    from pointcloud_tpu_torch.transforms import Normalize

    device = torch.device(device)
    sc = scene_config("Cube")
    dtype = cfg.compute_dtype(device)
    model = AE(PointNet2MSGEncoder(feature_dims=3, dtype=dtype),
               out_points=sc.sample_points, out_dim=6,
               bottleneck=sum(sc.class_latent_dim), dtype=dtype)
    init_flax_(model, torch.Generator().manual_seed(seed))
    return TrainSpec(model=model.to(device).eval(), loss=ChamferDistance(),
                     open_dataset=lambda input_dir: PointCloudDataset(
                         root_dir=input_dir, in_features=["rgb"], out_features=["rgb"]),
                     in_transform=Normalize(sc.bbox),
                     out_transform=Normalize(sc.bbox), model_type="Autoencoder",
                     backbone="PointNet2MSG", scene_name="Cube", scene=sc)


def msg_branches(bb):
    """(level, radius, k) of PointNet2MSGEncoder's six ball groupings."""
    return [(lv, r, k) for lv, sa in enumerate((bb.SetAbstractionMsg_0,
                                                bb.SetAbstractionMsg_1))
            for r, k in zip(sa.radius_list, sa.nsample_list)]


def msg_level_inputs(bb, xn):
    """(xyz, features, centroids) of both MSG levels on normalised clouds
    xn (B, N, 6), the features in the model's dtype."""
    from pointcloud_tpu_torch.ops import farthest_point_sample, index_points

    xyz = xn[..., :3].contiguous()
    feats = xn[..., 3:].to(bb.SetAbstractionMsg_0.dtype or xn.dtype).contiguous()
    out = []
    for sa in (bb.SetAbstractionMsg_0, bb.SetAbstractionMsg_1):
        new_xyz = index_points(xyz, farthest_point_sample(xyz, sa.npoint))
        out.append((xyz, feats, new_xyz))
        _, feats, _ = sa(xyz, feats)
        xyz = new_xyz
    return out


def check_group_gather(gen, B, N, S, k, F, dtype, masked, radius, with_xyz, offset=0,
                       route=None):
    """group_gather vs group_gather_reference: every output equal (the same
    membership test, first-k selection and exact gathers), the kernel twice.
    Centroids on every (N // S)-th point, the last one far outside the cloud
    (an empty ball: every slot point 0, none valid); with masks ~1/3 of the
    points masked and the last cloud fully masked. `offset`: the features
    start `offset` elements past an aligned base; `route`: the plan's route
    the shape must take. Returns the largest |gather error| (0)."""
    from pointcloud_tpu_torch.ops import group_gather, group_gather_plan, \
        group_gather_reference
    from pointcloud_tpu_torch.ops.group_gather import _word_bytes

    dev = torch.device("cuda")
    xyz = torch.rand((B, N, 3), generator=gen, device=dev)
    feats = None
    if F:
        flat = torch.randn(B * N * F + offset, generator=gen, device=dev).to(dtype)
        feats = flat[offset:].view(B, N, F)
    if route is not None:
        row = F * (2 if dtype == torch.bfloat16 else 4)
        plan = group_gather_plan(B, N, S, k, row,
                                 _word_bytes(row, feats) if F else 16, with_xyz)
        if plan.route != route:
            raise AssertionError(f"group_gather B={B} N={N} S={S} k={k}: route "
                                 f"{plan.route}, expected {route}")
    cents = xyz[:, :: max(1, N // S)][:, :S].clone()
    cents[:, -1] += 5.0
    mask = None
    if masked:
        mask = torch.rand((B, N), generator=gen, device=dev) > 0.33
        mask[-1] = False
    got = twice_equal("group_gather", lambda: tuple(
        t for t in group_gather(xyz, feats, cents, mask, k, radius, with_xyz)
        if t is not None))
    want = tuple(t for t in group_gather_reference(xyz, feats, cents, mask, k, radius,
                                                   with_xyz) if t is not None)
    if len(got) != len(want) or not all(
            a.dtype == w.dtype and torch.equal(a, w) for a, w in zip(got, want)):
        raise AssertionError(f"group_gather differs from the plain version (B={B} "
                             f"N={N} S={S} k={k} F={F} {dtype} masked={masked} "
                             f"xyz={with_xyz})")
    idx, valid = got[-2], got[-1]
    if not (bool((idx[:, -1] == 0).all()) and not bool(valid[:, -1].any())) or (
            masked and (bool(idx[-1].any()) or bool(valid[-1].any()))):
        raise AssertionError("group_gather: an empty ball must give point 0, invalid")
    fill = float(valid.float().mean())
    log(f"  group_gather B={B} N={N} S={S} k={k} F={F} {str(dtype)[6:]} "
        f"masked={masked} r={radius} xyz={with_xyz}{f' base +{offset}' if offset else ''}"
        f"{f' ({route})' if route else ''}: every output equal to the plain version's "
        f"({fill:.2f} of the slots in a ball); two runs bit-equal")
    return max([0.0] + [float((a.float() - w.float()).abs().max())
                        for a, w in zip(got[:-2], want[:-2])])


def check_group_gather_grad(gen, B, N, S, k, F, dtype, radius):
    """The gradient of group_gather on the card (one scatter_rows launch),
    the backward twice and bit-equal, against the same function on the CPU
    (plain forward and plain scatter) and against fp32 autograd through
    group_gather_reference on the card on the cotangents the kernel path
    sums (rounded to bf16 where the features are bf16): fp32 gradients 1e-5
    relative (summation order), bf16 feature gradients within one bf16 ulp
    (fp32 sums rounded once). Returns the largest absolute error."""
    from pointcloud_tpu_torch.ops import group_gather, group_gather_reference

    dev = torch.device("cuda")
    xyz = torch.rand((B, N, 3), generator=gen, device=dev)
    feats = torch.randn((B, N, F), generator=gen, device=dev).to(dtype)
    cents = xyz[:, :: N // S][:, :S].clone()
    cents[:, -1] += 5.0  # an empty ball: its slots send their share to point 0
    mask = torch.rand((B, N), generator=gen, device=dev) > 0.33
    cws = [torch.randn((B, S, k, c), generator=gen, device=dev) for c in (3, F)]

    def grads(fn, d, leaf_dtype, cw_dtype):
        leaves = [xyz.to(d).clone().requires_grad_(),
                  feats.to(d, leaf_dtype).clone().requires_grad_()]
        gx, gf, _, _ = fn(*leaves, cents.to(d), mask.to(d), k, radius)
        loss = sum((o.float() * cw.to(d, cw_dtype).float()).sum()
                   for o, cw in zip((gx, gf), cws))
        return [g.to(dev) for g in torch.autograd.grad(loss, leaves)]

    before = dict(read_counts())
    got = twice_equal("group_gather backward",
                      lambda: grads(group_gather, dev, dtype, torch.float32))
    after = read_counts()
    if (after["group_gather"] - before["group_gather"],
            after["scatter_rows"] - before["scatter_rows"]) != (2, 2):
        raise AssertionError("group_gather's gradient must take one group_gather and "
                             "one scatter_rows launch")
    worst = 0.0
    for label, want in (
            ("the CPU path", grads(group_gather, "cpu", dtype, torch.float32)),
            ("autograd through the plain version",
             grads(group_gather_reference, dev, torch.float32, dtype))):
        for g, w in zip(got, want):
            worst = max(worst, float((g.float() - w.float()).abs().max()))
            if g.dtype == torch.bfloat16:
                ok = (g.float() - w.float()).abs() <= bf16_ulp(w) + 1e-6
            else:
                ok = (g - w).abs() <= 1e-5 * w.abs().max()
            if not bool(ok.all()):
                raise AssertionError(f"group_gather gradient differs from {label} "
                                     f"({dtype}, k={k})")
    log(f"  group_gather gradient B={B} N={N} S={S} k={k} F={F} {str(dtype)[6:]}: "
        f"d xyz, d feats equal to the CPU path's and to autograd through the "
        f"plain version within tolerance (max |err| {worst:.1e}); two runs "
        f"bit-equal; one scatter_rows launch per backward")
    return worst


def group_gather_library(xyz, feats, cents, k, radius):
    """cdist + first-k selection + gather, storing the (B, S, N) distance
    matrix: timed as a yardstick, never called by the port."""
    N = xyz.shape[1]
    inb = torch.cdist(cents, xyz).square() <= radius * radius
    key = torch.where(inb, torch.arange(N, dtype=torch.int32, device=xyz.device), N)
    first = torch.topk(key, min(k, N), dim=-1, largest=False).values
    valid = first < N
    idx = torch.where(valid, first, torch.where(valid[..., :1], first[..., :1], 0))
    B, S, kk = idx.shape
    flat = idx.reshape(B, S * kk, 1).long()
    gx = torch.gather(xyz, 1, flat.expand(-1, -1, 3)).reshape(B, S, kk, 3)
    gf = torch.gather(feats, 1, flat.expand(-1, -1, feats.shape[2])).reshape(
        B, S, kk, -1)
    return gx, gf, idx, valid


def group_gather_bound(B, N, S, k, F, esize, idx, valid):
    """Bytes: xyz, features and centroids read once; gathered xyz and
    features, idx and valid written once. Operations: a distance test is 9
    fp32 instructions, counted at the issue rate PEAK_FP32_ISSUE as
    ball_bound counts them, over the points this run's data makes the
    kernel test (up to the k-th in-ball point, else all N)."""
    scanned = torch.where(valid[..., -1], idx[..., -1].long() + 1, N)
    ops = 9 * float(scanned.sum())
    nbytes = (B * N * 3 * 4 + B * N * F * esize + B * S * 3 * 4
              + B * S * k * (3 * 4 + F * esize + 4 + 1))
    return bound(ops, nbytes, PEAK_FP32_ISSUE)


def msg_kernel_checks(gen, err):
    """group_gather against its plain version at small odd shapes, and its
    gradient."""
    bf, f32 = torch.bfloat16, torch.float32
    err["group_gather"] = max(
        err.get("group_gather", 0.0),
        check_group_gather(gen, 3, 300, 40, 5, 7, f32, True, 0.3, True),
        check_group_gather(gen, 3, 300, 40, 5, 7, bf, True, 0.3, False),
        check_group_gather(gen, 3, 256, 16, 40, 0, f32, True, 0.2, True),  # F = 0
        check_group_gather(gen, 3, 20, 4, 32, 3, f32, False, 0.5, True),  # k > N
        check_group_gather(gen, 3, 512, 64, 128, 320, bf, True, 0.8, True),
        check_group_gather(gen, 2, 5000, 64, 24, 4, bf, True, 0.1, True),  # global
        check_group_gather(gen, 2, 5000, 64, 24, 3, f32, False, 0.1, False))
    err["scatter_rows"] = max(
        err["scatter_rows"],
        check_group_gather_grad(gen, 3, 512, 64, 16, 5, f32, 0.3),
        check_group_gather_grad(gen, 3, 512, 64, 32, 320, bf, 0.3))


def msg_eval_path(seed, x_raw, smi, err):
    """The MSG autoencoder's eval path at full width (B_MSG x 2048 x 6, bf16)
    with exact launch counts: 20 chained steps, a trace, the level-by-level
    time, `encode` on one cloud; fps at both levels and nn_sweep on the
    step's output against their plain versions; group_gather at the six
    branches of the batch's own inputs against its plain version, timed
    beside it, a library yardstick and its bound. Returns the counts and the
    timing rows."""
    from pointcloud_tpu_torch.ops import (
        farthest_point_sample,
        fps_reference,
        group_gather,
        group_gather_reference,
        nn_sweep,
        nn_sweep_reference,
    )
    from pointcloud_tpu_torch.train import make_eval_step

    dev = torch.device("cuda")
    log(f"[MSG eval path] Autoencoder / PointNet2MSGEncoder / Chamfer, scene Cube, "
        f"B={B_MSG} x 2048 x 6, bf16")
    spec = msg_spec(dev, seed)
    step = make_eval_step(spec)
    ev = drive_eval(step, x_raw[:B_MSG].contiguous(), ITERS)
    counts = ev["counts"]
    expect_counts("MSG eval path", counts, fps=2 * (ITERS + 1),
                  group_gather=6 * (ITERS + 1), nn_sweep=ITERS + 1)
    log(f"  eval step B={B_MSG}: first call {ev['first_s']:.3f} s; {ITERS} chained "
        f"steps {ev['ms']:.3f} ms/step on the host clock -> "
        f"{B_MSG / (ev['ms'] / 1e3):.1f} clouds/s; event-to-event median "
        f"{ev['per_iter'][ITERS // 2]:.3f} ms (min {ev['per_iter'][0]:.3f}, max "
        f"{ev['per_iter'][-1]:.3f}); peak memory {ev['peak']:.2f} GiB | {smi}")
    log(f"  loss {float(ev['loss']):.6f}; launches {counts}")
    out = ev["out"]
    if not bool(torch.isfinite(ev["loss"])) or out.shape != (B_MSG, 2048, 6) \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"MSG eval: loss {ev['loss']}, out {tuple(out.shape)}")
    trace_steps(step, ev["x"], ev["x"], ev["ms"], f"MSG eval step, B={B_MSG}")

    bb = spec.model.encoder.backbone
    with torch.inference_mode():
        xn = spec.in_transform(ev["x"])[0]
        levels = msg_level_inputs(bb, xn)
        for (lx, _, _), sa in zip(levels, (bb.SetAbstractionMsg_0,
                                           bb.SetAbstractionMsg_1)):
            K = sa.npoint
            got = twice_equal("fps", lambda: (farthest_point_sample(lx, K),))[0]
            if not torch.equal(got, fps_reference(lx, K)):
                raise AssertionError(f"fps differs from the plain version at the "
                                     f"MSG batch's own clouds (N={lx.shape[1]})")
            log(f"  fps B={lx.shape[0]} N={lx.shape[1]} K={K} on the batch's own "
                f"clouds: indices equal to the plain version's; two runs bit-equal")
        y = spec.out_transform(ev["x"])[0]
        got = twice_equal("nn_sweep", lambda: nn_sweep(out, y))
        want = nn_sweep_reference(out, y)
        e_nn = max(float((got[j] - want[j]).abs().max()) for j in (0, 2))
        err["nn_sweep"] = max(err["nn_sweep"], e_nn)
        if e_nn > 1e-5:
            raise AssertionError(f"nn_sweep at the MSG eval step's output differs by "
                                 f"{e_nn}")
        log(f"  nn_sweep B={B_MSG} N=M=2048 on the step's output and target: "
            f"distances max |err| {e_nn:.2e}; two runs bit-equal")
        del got, want
        parts = {}
        for i, sa in enumerate((bb.SetAbstractionMsg_0, bb.SetAbstractionMsg_1)):
            lx, lf, _ = levels[i]
            parts[f"MSG level {i + 1}"] = cuda_ms(lambda: sa(lx, lf), iters=5)
        l2 = bb.SetAbstractionMsg_1(*levels[1][:2])
        parts["group-all level"] = cuda_ms(
            lambda: bb.SetAbstraction_0(l2[0], l2[1]), iters=5)
        h = spec.model.encoder(xn)
        parts["decoder"] = cuda_ms(lambda: spec.model.decoder(h), iters=5)
        parts["nn_sweep"] = cuda_ms(lambda: nn_sweep(out, y), iters=5)
    log(f"  eval step parts at B={B_MSG} (CUDA events, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.3f} vs the step's {ev['ms']:.3f}")
    del h, l2

    with torch.inference_mode():
        one = spec.in_transform(x_raw[:1])[0]
        zero_counts()
        lat = host_ms(lambda: spec.model.encode(one), calls=20, warmup=5)
        enc_counts = read_counts()
        enc = spec.model.encode(one)
    expect_counts("MSG encode", enc_counts, fps=2 * 25, group_gather=6 * 25)
    if enc.shape != (1, 13) or not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"MSG encode gave {tuple(enc.shape)}")
    log(f"  encode(1 cloud) -> {tuple(enc.shape)}; host clock, 20 calls after 5 "
        f"warm-ups: median {lat[10]:.3f} ms, max {lat[-1]:.3f} ms; launches "
        f"{enc_counts}")

    rows = {}
    with torch.inference_mode():
        for lv, r, k in msg_branches(bb):
            gx, gf, gc = levels[lv]
            args = (gx, gf, gc, None, k, r)
            got = group_gather(*args)
            want = group_gather_reference(*args)
            if not all(torch.equal(a, w) for a, w in zip(got, want)):
                raise AssertionError(f"group_gather differs from the plain version "
                                     f"at level {lv + 1}, r={r}, at the path's inputs")
            lib = group_gather_library(gx, gf, gc, k, r)
            same = torch.equal(lib[2].int(), got[2]) and torch.equal(lib[3], got[3])
            Bb, Nb, Sb, Fb = gx.shape[0], gx.shape[1], gc.shape[1], gf.shape[2]
            bnd = group_gather_bound(Bb, Nb, Sb, k, Fb, gf.element_size(), got[2],
                                     got[3])
            fill = float(got[3].float().mean())
            del got, want, lib
            torch.cuda.empty_cache()
            rows[(lv + 1, r)] = (  # through the C entry (knn_direct's reason)
                cuda_ms(group_gather_direct(gx, gf, gc, k, r), iters=20),
                cuda_ms(lambda: group_gather_reference(*args), iters=2, warmup=1),
                cuda_ms(lambda: group_gather_library(gx, gf, gc, k, r), iters=3,
                        warmup=1), bnd)
            t = rows[(lv + 1, r)]
            log(f"  group_gather level {lv + 1} r={r} B={Bb} N={Nb} S={Sb} k={k} "
                f"F={Fb} bf16 ({fill:.3f} of the slots in a ball): kernel "
                f"{t[0]:.4f} ms | plain {t[1]:.3f} ms | library "
                f"cdist + first-k + gather {t[2]:.3f} ms ({'the same' if same else 'other'} "
                f"memberships) | bound {bnd[0]:.4f} ms ({bnd[1]})")
    log(f"  group_gather, its 6 launches of one step together: kernel "
        f"{sum(t[0] for t in rows.values()):.3f} ms | plain "
        f"{sum(t[1] for t in rows.values()):.3f} ms | library "
        f"{sum(t[2] for t in rows.values()):.3f} ms | bound "
        f"{sum(t[3][0] for t in rows.values()):.4f} ms")
    del spec, step, ev, out, xn, levels, y
    torch.cuda.empty_cache()
    return {"counts": counts, "rows": rows}


def msg_train_path(seed, gen, x_raw, smi, err):
    """The MSG autoencoder's train path at full width (B_MSG x 2048 x 6,
    bf16): a warm-up step and TRAIN_ITERS chained steps with exact launch
    counts, the step's parts and a trace; then, on what one more step hands
    its kernels, each held against its plain version and timed there:
    chamfer_bwd, level 2's three scatter_rows (its grouped feature
    cotangents), the group-all level's chain (compare_chain, time_chain),
    and dense_pool_stats forward and backward at the six branches' last
    layers (pools of 16 / 32 / 128 / 32 / 64 / 128). Returns the counts."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.models import DenseBNMaxPool
    from pointcloud_tpu_torch.ops import (
        dense_pool_stats,
        dense_pool_stats_bwd,
        dense_pool_stats_reference,
        pool_bwd_plan,
        pool_fwd_plan,
    )
    from pointcloud_tpu_torch.train import make_optimizer, make_train_step

    dev = torch.device("cuda")
    log(f"[MSG train path] make_train_step, Autoencoder / PointNet2MSGEncoder / "
        f"Chamfer, B={B_MSG} x 2048 x 6, bf16, Adam lr {cfg.vision_lr}")
    spec = msg_spec(dev, seed)
    opt = make_optimizer(spec)
    step = make_train_step(spec, opt)
    xt = x_raw[:B_MSG].contiguous()
    tr = drive_train(step, xt, xt, TRAIN_ITERS)
    # per step: 2 FPS and 6 ball groupings; each branch's last layer is a
    # DenseBNMaxPool (dense_pool_stats forward and backward); level 2's three
    # groupings scatter their features' gradient (level 1's features are the
    # input); the group-all level is one 3-layer chain (mm_stats, 2
    # bnact_mm_stats, bn_pool; 3 backward passes); Chamfer's backward is one
    # chamfer_bwd
    per_step = dict(fps=2, group_gather=6, dense_pool_stats=6,
                    dense_pool_stats_bwd=6, scatter_rows=3, mm_stats=1,
                    bnact_mm_stats=2, bn_pool=1, chain_bwd_pass=3, nn_sweep=1,
                    chamfer_bwd=1)
    expect_counts("MSG train path", tr["counts"],
                  **{k: v * TRAIN_ITERS for k, v in per_step.items()})
    # Adam's first update raises this model's loss, as PointNet2's
    report_train("MSG train path", B_MSG, tr, set(), smi, must_fall=False)
    bb = spec.model.encoder.backbone
    for name, buf in bb.named_buffers():
        start = 1.0 if name.rsplit(".", 1)[-1].startswith("var") else 0.0
        if not bool(torch.isfinite(buf).all()) or bool((buf == start).all()):
            raise AssertionError(f"running statistic {name} did not move")
    trace_steps(step, xt, xt, tr["ms"], f"MSG train step, B={B_MSG}",
                tr["enqueue_ms"])
    fwd_ms, bwd_ms, opt_ms = step_parts(spec, opt, xt, xt)
    log(f"  train step parts (median of 3, CUDA events): forward + loss "
        f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, Adam {opt_ms:.3f} ms")

    # one more train step, recording what the path hands its kernels: the
    # six DenseBNMaxPool layers' inputs, the group-all level's (xyz, features),
    # level 2's three grouped cotangents on their way to scatter_rows and the
    # Chamfer backward's inputs
    captured, group_all = [], []

    def grab(mod, args, kwargs):
        x, mask = args[0], kwargs["mask"]
        B, S, K, cin = x.shape
        captured.append((x.detach().reshape(B, S * K, cin).to(torch.bfloat16)
                         .contiguous(), mod.weight.detach().t().to(torch.bfloat16)
                         .contiguous(), mod.bias.detach().to(torch.bfloat16),
                         torch.where(mod.scale >= 0, 1.0, -1.0).float().detach(),
                         torch.where(mask.reshape(B, S * K), 0.0, 1e9).float(), K))

    sa = bb.SetAbstraction_0
    hooks = [m.register_forward_pre_hook(grab, with_kwargs=True)
             for m in bb.modules() if isinstance(m, DenseBNMaxPool)]
    hooks.append(sa.register_forward_pre_hook(
        lambda mod, args: group_all.append(([a.detach() for a in args], [
            getattr(mod, f"{n}{j}").detach().clone() for n in ("w", "scale", "offset")
            for j in range(mod.n_layers)]))))
    with recording(sys.modules["pointcloud_tpu_torch.ops.scatter_rows"],
                   "scatter_rows") as scattered, \
            recording(sys.modules["pointcloud_tpu_torch.ops.chamfer"],
                      "chamfer_bwd") as chamfer_args:
        step(xt, xt)
    for hk in hooks:
        hk.remove()
    (xyz2, feats2), params = group_all[0]
    with torch.no_grad():
        _, grouped, gmask, _ = sa.group(xyz2, feats2)
    B, S, K, cin = grouped.shape
    chain = (grouped.reshape(B, S * K, cin).to(torch.bfloat16).contiguous(),
             params[:3], params[3:6], params[6:],
             torch.where(gmask.reshape(B, S * K), 0.0, 1e9), K)
    del spec, opt, step, grouped, gmask, group_all
    torch.cuda.empty_cache()

    err["chamfer_bwd"] = max(err["chamfer_bwd"], compare_chamfer_bwd(
        tuple(a.detach() for a in chamfer_args[0][0]),
        f"the MSG B={B_MSG} train step's own inputs"))
    if sorted(a[0].shape[1] for a, _ in scattered) != [128 * k for k in (32, 64, 128)]:
        raise AssertionError(f"level 2's backward scattered "
                             f"{[tuple(a[0].shape) for a, _ in scattered]}")
    time_scatters(scattered, f"level 2's backward of the MSG B={B_MSG} step", err)
    del scattered, chamfer_args
    torch.cuda.empty_cache()
    x, ws, gs, bs, pen, K = chain
    fwd = compare_chain(gen, x, ws, gs, bs, pen, K, True, err,
                        f"group-all level of the MSG B={B_MSG} batch", path=True)
    torch.cuda.empty_cache()
    time_chain(x, ws, gs, bs, pen, K, fwd, True, "MSG group-all")
    del chain, fwd, x, ws, gs, bs, pen
    torch.cuda.empty_cache()
    if [c[-1] for c in captured] != [16, 32, 128, 32, 64, 128]:
        raise AssertionError(f"DenseBNMaxPool pools {[c[-1] for c in captured]}")
    times = []
    for x, w, b, s, pen, pool in captured:
        e_fwd, e_bwd, fwd_out = compare_dense_pool(gen, x, w, b, s, pen, pool,
                                                   acc_bound=True)
        err["dense_pool_stats"] = max(err["dense_pool_stats"], e_fwd)
        err["dense_pool_stats_bwd"] = max(err["dense_pool_stats_bwd"], e_bwd)
        C = w.shape[1]
        g_ps = torch.randn(fwd_out[0].shape, generator=gen, device=dev)
        g_s = torch.randn((C,), generator=gen, device=dev) / x.shape[1]
        times.append((
            cuda_ms(lambda: dense_pool_stats(x, w, b, s, pen, pool), iters=5),
            cuda_ms(lambda: dense_pool_stats_reference(x, w, b, s, pen, pool),
                    iters=2, warmup=1),
            cuda_ms(lambda: dense_pool_stats_bwd(x, w, b, s, fwd_out[1], g_ps, g_s,
                                                 g_s, pool), iters=5),
            *time_pool_bwd_parts(x, w, b, s, fwd_out[1], g_ps, g_s, pool),
            cuda_ms(pool_library_bwd(x, w, b, pool, g_ps, g_s), iters=2, warmup=1),
            pool_bwd_bound(x.shape[0], x.shape[1], x.shape[2], C, pool)[0],
            pool_bwd_plan(x.shape[0] * x.shape[1], x.shape[2], C, True, pool).route,
            pool_fwd_plan(x.shape[0] * x.shape[1], x.shape[2], C, True, pool).route,
            pool_fwd_bound(x, C, pool, pen)[0],
            cuda_ms(pool_library_fwd(x, w, b, pool), iters=2, warmup=1)))
        del fwd_out, g_ps
        torch.cuda.empty_cache()
    log("  dense_pool_stats at the six branches (R = S x pool rows a cloud, bf16; "
        "kernel fwd (route) | fwd bound | plain fwd | library fwd | kernel bwd (dx + dw, "
        "device time traced) | library bwd | bwd bound, ms): " + "; ".join(
            f"pool {c[-1]} Cin={c[0].shape[2]} C={c[1].shape[1]} R={c[0].shape[1]}: "
            f"{t[0]:.3f} ({t[8]}) | {t[9]:.4f} | {t[1]:.3f} | {t[10]:.3f} | {t[2]:.3f} "
            f"({t[3]:.3f} + {t[4]:.3f}, {t[7]}) | {t[5]:.3f} | {t[6]:.4f}"
            for c, t in zip(captured, times)))
    del captured
    torch.cuda.empty_cache()
    return {"counts": tr["counts"]}


def card_vs_cpu_msg(seed, x_raw):
    """The fp32 MSG autoencoder on the card and on the CPU from the same
    weights, at B=2 clouds of 1024 points (MSG_CVC_START): FPS indices and
    every branch's idx and valid equal; eval outputs 1e-4, loss 1e-5; the
    first train step's loss 1e-5 relative, and, as for PointMLP (this
    encoder's fp32 gradients at B=2 are ill-conditioned in the input itself:
    tests/test_torch_pointnet2_msg_conditioning.py), its gradients within
    2e-2 of the model's largest entry and its first update within 2 lr, 1e-3
    relative wherever the gradient is above 1% of its tensor's largest entry
    and 3e-2 of the model's. The bf16 model's eval loss within 5% of fp32's.
    Both devices test membership with the same rounded formula, so no radius
    margin is needed; the smallest float64 margin of each of the six radii
    is printed."""
    import copy
    import dataclasses

    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import farthest_point_sample, group_gather
    from pointcloud_tpu_torch.train import (
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    cfg.precision = "fp32"
    try:
        cpu = msg_spec("cpu", seed)
    finally:
        cfg.precision = "bf16-mixed"
    init = copy.deepcopy(cpu.model)

    start = MSG_CVC_START
    xs = x_raw[start:start + 2, :1024].contiguous()
    specs = [dataclasses.replace(cpu, model=copy.deepcopy(init).cuda()),
             dataclasses.replace(cpu, model=copy.deepcopy(init))]

    # the groupings: FPS indices, then every branch's idx and valid
    sel, margins = [], []
    for sp, d in zip(specs, ("cuda", "cpu")):
        bb = sp.model.encoder.backbone
        xyz = sp.in_transform(xs.to(d))[0][..., :3].contiguous()
        got = []
        for sa in (bb.SetAbstractionMsg_0, bb.SetAbstractionMsg_1):
            fidx = farthest_point_sample(xyz, sa.npoint)
            new_xyz = torch.gather(xyz, 1, fidx.long()[..., None].expand(-1, -1, 3))
            got.append(fidx)
            for r, k in zip(sa.radius_list, sa.nsample_list):
                got.extend(group_gather(xyz, None, new_xyz, None, k, r, False)[2:])
                if d == "cpu":
                    dd = ((new_xyz[:, :, None].double() - xyz[:, None].double()) ** 2
                          ).sum(-1)
                    margins.append(float((dd / (r * r) - 1).abs().min()))
            xyz = new_xyz
        sel.append(got)
    if len(sel[0]) != 14 or not all(torch.equal(a.cpu(), b) for a, b in zip(*sel)):
        raise AssertionError("MSG FPS indices or ball groupings differ, card vs CPU")

    (l_gpu, _, o_gpu), (l_cpu, _, o_cpu) = (
        make_eval_step(sp)(xs.to(d), xs.to(d)) for sp, d in zip(specs, ("cuda", "cpu")))
    e_out = float((o_gpu.cpu() - o_cpu).abs().max())
    e_loss = abs(float(l_gpu) - float(l_cpu))
    bf = msg_spec("cuda", seed)
    l_bf = float(make_eval_step(bf)(xs, xs)[0])
    bf_loss = abs(l_bf - float(l_gpu)) / float(l_gpu)
    del bf
    if e_out > 1e-4 or e_loss > 1e-5:
        raise AssertionError(f"fp32 MSG eval on the card disagrees with the CPU: "
                             f"out {e_out:.2e}, loss {e_loss:.2e}")
    if bf_loss > 0.05:
        raise AssertionError("bf16 MSG eval loss is > 5% off the fp32 one")

    res = []
    for sp, d in zip(specs, ("cuda", "cpu")):
        before = {k: p.detach().cpu().clone() for k, p in sp.model.named_parameters()}
        loss, _ = make_train_step(sp, make_optimizer(sp))(xs.to(d), xs.to(d))
        res.append((float(loss), {k: p.grad.detach().cpu() for k, p in
                                  sp.model.named_parameters()},
                    {k: p.detach().cpu() - before[k] for k, p in
                     sp.model.named_parameters()}))
    (tl_gpu, g_gpu, u_gpu), (tl_cpu, g_cpu, u_cpu) = res
    top = max(float(g.abs().max()) for g in g_cpu.values())
    worst_g = max(float((g_gpu[k] - g).abs().max()) for k, g in g_cpu.items()) / top
    worst_u, n_sig = 0.0, 0
    for k, g in g_cpu.items():
        du = (u_gpu[k] - u_cpu[k]).abs()
        sig = (g.abs() > 1e-2 * g.abs().max()) & (g.abs() > 3e-2 * top)
        n_sig += int(sig.sum())
        if float(du.max()) > 2 * cfg.vision_lr + 1e-6 or bool(
                (du[sig] > 1e-3 * u_cpu[k].abs()[sig]).any()):
            raise AssertionError(f"MSG card vs CPU first update of {k} differs")
        if bool(sig.any()):
            worst_u = max(worst_u, float((du[sig] / u_cpu[k].abs()[sig]).max()))
    log(f"  MSG fp32, card vs CPU, B=2 (clouds {start}, {start + 1}; smallest "
        f"float64 radius margins {', '.join(f'{m:.1e}' for m in margins)}): FPS "
        f"indices and the six groupings' idx and valid equal; "
        f"eval max |out err| {e_out:.2e}, |loss err| {e_loss:.2e}, bf16 loss rel "
        f"diff {bf_loss:.2e}; first train loss {tl_gpu:.7f} vs {tl_cpu:.7f}; "
        f"gradients max err {worst_g:.2e} of the largest entry; first update "
        f"{worst_u:.2e} rel on the {n_sig} entries above the noise")
    if abs(tl_gpu - tl_cpu) > 1e-5 * tl_cpu or worst_g > 2e-2 or n_sig == 0:
        raise AssertionError("fp32 MSG train step on the card disagrees with the CPU")


def loss_spread(seeds, steps, orders):
    """Phase 4's train path (the PointNet autoencoder with Chamfer, B_TRAIN x
    2048 x 6, bf16, Adam) from each seed's weights and clouds, drawn at once
    from a generator of the seed (so seed 0's clouds are not phase 4's): the
    warm-up loss, `steps` chained losses and the first chained step below the
    warm-up loss, one line a (order, seed). Each order re-sums the dense-pool
    backward's fp32 dw partials over other chunk boundaries, an equally exact
    summation: the wgmma route plans as for a card of that many SMs; a port
    whose backward has only the tile route (no `pool_bwd_plan`) cuts its dw
    into that many chunks. Order 0 is the port's own plan."""
    from pointcloud_tpu_torch.ops import dense_bn_pool as tdp
    from pointcloud_tpu_torch.train import create_model, make_optimizer, make_train_step

    dev = torch.device("cuda")
    tiled = not hasattr(tdp, "pool_bwd_plan")
    own = tdp._DW_CHUNKS if tiled else tdp.sm_count
    for order in orders:
        if tiled:
            tdp._DW_CHUNKS = order or own
        else:
            tdp.sm_count = (lambda index, n=order: n) if order else own
        for seed in seeds:
            spec = create_model("Autoencoder", "PointNet", "Cube",
                                loss_override="chamfer", device=dev, seed=seed)
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = raw_batch(gen, spec.scene, B_TRAIN, spec.scene.sample_points, dev)
            tr = drive_train(make_train_step(spec, make_optimizer(spec)), x, x, steps)
            below = next((i + 1 for i, v in enumerate(tr["losses"])
                          if v < tr["first_loss"]), None)
            log(json.dumps({"order": order, "seed": seed, "warm_up": tr["first_loss"],
                            "losses": tr["losses"], "first_below": below}))
            del spec, tr, x
            torch.cuda.empty_cache()


# (label, B, N, K) of every fps launch shape a driven path makes: PointNet2's
# two SA levels at bench.py's batch, the MSG levels and PointMLP's (and
# Elite's) four stages at the PointMLP batch, and `encode` on one cloud
# (PointNet2's and MSG's two levels, then PointMLP's four stages)
FPS_DRIVEN = (("PointNet2 SA1", B_PN2, 2048, 512), ("PointNet2 SA2", B_PN2, 512, 128),
              ("MSG level 1", 32, 2048, 512), ("MSG level 2", 32, 512, 128),
              ("PointMLP stage 1", 32, 2048, 1024), ("PointMLP stage 2", 32, 1024, 512),
              ("PointMLP stage 3", 32, 512, 256), ("PointMLP stage 4", 32, 256, 128),
              ("encode SA1 / MSG level 1", 1, 2048, 512),
              ("encode SA2 / MSG level 2", 1, 512, 128),
              ("encode PointMLP stage 1", 1, 2048, 1024),
              ("encode PointMLP stage 2", 1, 1024, 512),
              ("encode PointMLP stage 3", 1, 512, 256),
              ("encode PointMLP stage 4", 1, 256, 128))


def fps_driven_times(gen):
    """fps at every FPS_DRIVEN shape on unit-cube clouds: indices equal to
    the plain version's, then the kernel's mean device time over 10 calls,
    the time a serial step (ms / (K - 1)) and the bound. Returns
    {label: (ms, plain ms, bound)}; the plain version is timed only at SA1."""
    from pointcloud_tpu_torch.ops import farthest_point_sample, fps_plan, fps_reference

    out = {}
    for label, B, N, K in FPS_DRIVEN:
        xyz = torch.rand((B, N, 3), generator=gen, device="cuda")
        got = farthest_point_sample(xyz, K)
        if not torch.equal(got, fps_reference(xyz, K)):
            raise AssertionError(f"fps differs from the plain version at {label}")
        ms = cuda_ms(lambda: farthest_point_sample(xyz, K), iters=10)
        plain = (cuda_ms(lambda: fps_reference(xyz, K), iters=2, warmup=1)
                 if label == "PointNet2 SA1" else None)
        bnd = fps_bound(B, N, K)
        p = fps_plan(B, N)
        geometry = ", ".join(f"{f} {getattr(p, f)}" for f in p._fields
                             if f in ("route", "threads", "slots"))
        out[label] = (ms, plain, bnd)
        log(f"  fps {label}: B={B} N={N} K={K} ({geometry}): kernel {ms:.4f} ms, "
            f"{1e3 * ms / (K - 1):.3f} us a step | bound {bnd[0]:.4f} ms ({bnd[1]})"
            + ("" if plain is None else f" | plain {plain:.3f} ms"))
    return out


def nn_sweep_costs(x, y):
    """Every pair's raw expansion cost as the nn_sweep kernel forms it
    (before the clamp), through the library's diagnostic entry
    nn_sweep_costs_launch: (cost_x (B, N, M), cost_y (B, M, N)) fp32 of
    contiguous fp32 CUDA clouds, no masks. Counts no launch."""
    import ctypes

    from pointcloud_tpu_torch.ops import _build, nn_plan

    fn = _build.load("nn_sweep").nn_sweep_costs_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    (B, N, C), M = x.shape, y.shape[1]
    plan = nn_plan(B, N, M, C, torch.cuda.get_device_properties(x.device).multi_processor_count)
    outs = [torch.empty(shape, dtype=dt, device=x.device)
            for shape, dt in (((B, N), torch.float32), ((B, N), torch.int32),
                              ((B, M), torch.float32), ((B, M), torch.int32),
                              ((B, N, M), torch.float32), ((B, M, N), torch.float32))]
    err = fn(x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in outs[:4]), B, N, M, C,
             plan.chunk, plan.splits, plan.smem, outs[4].data_ptr(), outs[5].data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nn_sweep_costs_launch failed: CUDA error {err}")
    return outs[4], outs[5]


def nn_expansion_error(x, y, label, group=16):
    """The kernel's expansion costs (nn_sweep_costs) against direct fp32
    differences over every pair of x (B, N, C) and y (B, M, C), `group`
    clouds at a time: the largest |expansion - direct| of each direction,
    and the count of indices nn_sweep returns that differ from the direct
    differences' first argmin, with the largest direct-cost gap such a
    query's choice leaves. Returns (largest error, differing indices)."""
    from pointcloud_tpu_torch.ops import nn_sweep

    err, flips, gap = 0.0, 0, 0.0
    for i in range(0, x.shape[0], group):
        xs, ys = x[i:i + group], y[i:i + group]
        cx, cy = nn_sweep_costs(xs, ys)
        d = torch.zeros_like(cx)
        for c in range(x.shape[-1]):
            diff = xs[:, :, None, c] - ys[:, None, :, c]
            d += diff * diff
        err = max(err, float((cx - d).abs().max()),
                  float((cy - d.transpose(1, 2)).abs().max()))
        del cx, cy
        _, ax, _, ay = nn_sweep(xs, ys)
        for got, dd in ((ax, d), (ay, d.transpose(1, 2))):
            best, arg = torch.min(dd, dim=2)
            off = got.long() != arg
            flips += int(off.sum())
            if bool(off.any()):
                chosen = torch.gather(dd, 2, got.long()[..., None])[..., 0]
                gap = max(gap, float((chosen - best)[off].max()))
        del d
    log(f"  nn_sweep expansion vs direct differences, {label}: largest |cost "
        f"error| {err:.3e} over {2 * x.shape[0] * x.shape[1] * y.shape[1]} "
        f"pair-directions; {flips} indices differ from the direct argmin (largest "
        f"direct-cost gap of such a choice {gap:.3e})")
    return err, flips


def wgmma_warnings(source):
    """ptxas's notes that it serialized wgmma products (C7511 / C7514 /
    C7518) in the build of csrc/<source>.cu this process made."""
    from pointcloud_tpu_torch.ops import _build

    return [ln.strip() for ln in _build._logs.get(source, "").splitlines()
            if any(code in ln for code in ("C7511", "C7514", "C7518"))]


def ptxas_notes(sources):
    """Print each kernel's registers and spills from the build's ptxas
    report, and the build's wgmma serialization warnings, of the named
    csrc/ sources (nothing if the build was reused)."""
    from pointcloud_tpu_torch.ops import _build

    for source in sources:
        for kernel, regs, st, ld in _build.ptxas_report(source):
            log(f"  ptxas {source}: {kernel[:90]}: {regs} registers, spills {st} B "
                f"stored / {ld} B loaded")
        notes = wgmma_warnings(source)
        log(f"  ptxas {source}: {len(notes)} wgmma serialization warnings"
            + "".join(f"\n    {n[:160]}" for n in notes[:4]))


def fps_block_launch(xyz, K, threads, slots):
    """fps's block route at a geometry of the caller's (threads x slots >=
    N), through the library's C entry: int32 (B, K) of a contiguous fp32
    CUDA cloud, no mask. Counts no launch."""
    from pointcloud_tpu_torch.ops import fps as tfps

    B, N, C = xyz.shape
    out = torch.empty((B, K), dtype=torch.int32, device=xyz.device)
    err = tfps._library().fps_launch(
        xyz.data_ptr(), C, None, B, N, K, 0, threads, slots, 1, N, None, out.data_ptr(),
        torch.cuda.current_stream(xyz.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fps block route {threads} x {slots}: CUDA error {err}")
    return out


def fps_geometries(gen):
    """The block route at every block size (64-512 threads, slots a multiple
    of 4 up to 24) beside the plan's, at PointNet2's SA1 and SA2 (B=256),
    PointMLP's four stages (B=32) and `encode` (B=1, N=2048 and 512):
    indices equal, mean device time of 10 calls each."""
    from pointcloud_tpu_torch.ops import fps_plan, fps_reference
    from pointcloud_tpu_torch.ops import fps as tfps

    for B, N, K in ((B_PN2, 2048, 512), (B_PN2, 512, 128), (32, 2048, 1024),
                    (32, 1024, 512), (32, 512, 256), (32, 256, 128), (1, 2048, 512),
                    (1, 512, 128)):
        xyz = torch.rand((B, N, 3), generator=gen, device="cuda")
        want = fps_reference(xyz, K)
        row = []
        for threads in tfps._BLOCK_THREADS:
            slots = -(-N // (4 * threads)) * 4
            if slots > tfps._MAX_SLOTS:
                continue
            if not torch.equal(fps_block_launch(xyz, K, threads, slots), want):
                raise AssertionError(f"fps block route {threads} x {slots} differs")
            ms = cuda_ms(lambda: fps_block_launch(xyz, K, threads, slots), iters=10)
            row.append(f"{threads} x {slots}: {ms:.4f} ms ({1e3 * ms / (K - 1):.3f} us "
                       f"a step)")
        log(f"  fps block geometries B={B} N={N} K={K} (plan "
            f"{fps_plan(B, N).threads} x {fps_plan(B, N).slots}): " + "; ".join(row))


def kernel_split(fn, calls=5):
    """Device time a call of each CUDA kernel that fn() launches, from a
    torch.profiler trace of `calls` calls after one warm-up: {kernel: ms}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and not e.is_user_annotation:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ")
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / calls
    return out


def scatter_cases(seed):
    """(label, g, idx, n, init) of scatter_rows at every shape a driven path
    launches it at, the indices those of the path's own grouping on its own
    clouds (random weights and clouds from `seed`), the rows random in the
    path's dtype: PointNet2's SA2 grouping gradient (B=256, C=131),
    PointMLP's four stages (B=32, C=64-512) and MSG level 2's three branches
    (B=32, C=320), bf16. Also MSG level 2's (xyz, feats, centroids) and
    branches, for group_gather."""
    from pointcloud_tpu_torch.ops import ball_group, group_gather, knn_group
    from pointcloud_tpu_torch.train import create_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []

    def rows(B, R, C):
        return torch.randn((B, R, C), generator=gen, device=dev).to(torch.bfloat16)

    spec = create_model("Autoencoder", "PointNet2", "Cube", loss_override="chamfer",
                        device=dev, seed=seed)
    xn = spec.in_transform(raw_batch(gen, spec.scene, B_PN2, 2048, dev))[0]
    (_, _, _), (xyz, feats, cents) = sa_level_inputs(spec.model.encoder.backbone, xn)
    sa2 = spec.model.encoder.backbone.SetAbstraction_1
    with torch.inference_mode():
        idx = ball_group(xyz, feats, cents, None, sa2.nsample, sa2.radius)[1]
    B, S, k = idx.shape
    cases.append(("PointNet2 SA2", rows(B, S * k, 3 + feats.shape[2]),
                  idx.reshape(B, S * k), xyz.shape[1], None))
    spec = create_model("Autoencoder", "PointMLP", "Cube", loss_override="chamfer",
                        device=dev, seed=seed)
    xn = spec.in_transform(raw_batch(gen, spec.scene, B_MLP, 2048, dev))[0]
    for i, (xyz, feats, cents) in enumerate(
            pointmlp_stage_inputs(spec.model.encoder.backbone, xn)):
        with torch.inference_mode():
            idx = knn_group(xyz, None, cents, None, K_MLP)[2]
        B, S, k = idx.shape
        cases.append((f"PointMLP stage {i + 1}", rows(B, S * k, feats.shape[2]),
                      idx.reshape(B, S * k), xyz.shape[1], None))
    spec = msg_spec(dev, seed)
    bb = spec.model.encoder.backbone
    xn = spec.in_transform(raw_batch(gen, spec.scene, B_MSG, 2048, dev))[0]
    with torch.inference_mode():
        level2 = msg_level_inputs(bb, xn)[1]
    xyz, feats, cents = (t.clone() for t in level2)
    branches = [(r, k) for lv, r, k in msg_branches(bb) if lv == 1]
    for r, k in branches:
        with torch.inference_mode():
            idx = group_gather(xyz, None, cents, None, k, r)[2]
        B, S, _ = idx.shape
        cases.append((f"MSG level 2, r={r} k={k}", rows(B, S * k, feats.shape[2]),
                      idx.reshape(B, S * k), xyz.shape[1], None))
    return cases, (xyz, feats, cents, branches)


def sa_level_inputs(bb, xn):
    """(xyz, feats, centroids) of PointNet2's SA1 and SA2 ball groupings in
    one eval forward of the backbone `bb` on normalised clouds xn, the
    features bf16 as the path's."""
    from pointcloud_tpu_torch.ops import ball_group, farthest_point_sample, index_points

    xyz = xn[..., :3].contiguous()
    feats = xn[..., 3:].to(torch.bfloat16).contiguous()
    out = []
    with torch.inference_mode():
        for sa in (bb.SetAbstraction_0, bb.SetAbstraction_1):
            cents = index_points(xyz, farthest_point_sample(xyz, sa.npoint))
            out.append((xyz, feats, cents))
            grouped, _, valid = ball_group(xyz, feats, cents, None, sa.nsample,
                                           sa.radius)
            xyz, feats = cents, sa.pool(grouped, valid).contiguous()
    return [tuple(t.clone() for t in lv) for lv in out]


def scatter_times(cases):
    """scatter_rows at each case of scatter_cases: held against its plain
    version (1e-4 relative, two runs bit-equal), timed (10 calls after 2
    warm-ups) beside the library's index_add_ (atomics; timed here, never
    called by the port) and the bound, and the device time of each of its
    CUDA kernels from a trace (the sort / sum split where it has two).
    Returns {label: (ms, library ms, (bound ms, by))}."""
    from pointcloud_tpu_torch.ops import scatter_rows, scatter_rows_reference

    dev = torch.device("cuda")
    out = {}
    for label, g, idx, n, init in cases:
        got = twice_equal("scatter_rows", lambda: (scatter_rows(g, idx, n, init),))[0]
        want = scatter_rows_reference(g, idx, n, init)
        e = rel_err(got, want)
        if e > 1e-4:
            raise AssertionError(f"scatter_rows at {label} differs by {e:.2e} rel")
        B, R, C = g.shape
        off = (idx.long() + torch.arange(B, device=dev)[:, None] * n).reshape(-1)
        src = g.reshape(-1, C).float()
        base = (init.reshape(-1, C) if init is not None
                else torch.zeros((B * n, C), device=dev))
        ms = cuda_ms(lambda: scatter_rows(g, idx, n, init), iters=10)
        lib = cuda_ms(lambda: base.clone().index_add_(0, off, src), iters=10)
        bnd = bound(B * R * C, B * R * (C * g.element_size() + 4)
                    + B * n * C * 4 * (1 if init is None else 2), PEAK_FP32_FLOPS)
        split = kernel_split(lambda: scatter_rows(g, idx, n, init))
        lens = torch.zeros(B * n, dtype=torch.int64, device=dev).index_add_(
            0, off, torch.ones_like(off))
        out[label] = (ms, lib, bnd)
        log(f"  scatter_rows {label}: B={B} R={R} -> n={n} C={C} "
            f"{str(g.dtype)[6:]}{' + init' if init is not None else ''} (buckets: "
            f"mean {R / n:.1f}, largest {int(lens.max())}): rel err {e:.2e}, two "
            f"runs bit-equal; kernel {ms:.4f} ms (device time by kernel, trace: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f") | library index_add_ {lib:.4f} ms | bound {bnd[0]:.4f} ms "
            f"({bnd[1]})")
        del got, want, off, src, base, lens
    torch.cuda.empty_cache()
    return out


# the selection of the ball grouping as the first version ran it (16 warps a
# block, a warp a centroid, the cloud staged by every block, the slots in
# global memory), built alone to time the selection without the write
BALL_SELECT_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "ball_select.cuh"
namespace {
constexpr int kWarps = 16;
__global__ void __launch_bounds__(kWarps * 32)
    select_kernel(const float* __restrict__ xyz, const float* __restrict__ cents,
                  int n, int s_count, int k, float r2, int* idx) {
  __shared__ float4 pts[ball_select::kMaxSharedPoints];
  const int64_t b = blockIdx.y;
  const float* xb = xyz + b * n * 3;
  ball_select::stage_points(pts, xb, nullptr, n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= s_count) return;
  const int64_t row = b * s_count + s;
  ball_select::select_first_k<true>(pts, xb, nullptr, n, cents[3 * row],
                                    cents[3 * row + 1], cents[3 * row + 2], r2, k,
                                    idx + row * k, lane);
}
}  // namespace
extern "C" int select_launch(const float* xyz, const float* cents, int b, int n,
                             int s_count, int k, float r2, int* idx, void* stream) {
  const dim3 grid((s_count + kWarps - 1) / kWarps, b);
  select_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, cents, n, s_count, k, r2, idx);
  return static_cast<int>(cudaGetLastError());
}
"""


def ball_select_only(xyz, feats, cents, k, radius):
    """A callable that runs the ball grouping's staging and selection alone
    on these inputs (no grouped rows written): the library's diagnostic
    entry `ball_group_select_launch` on the launch `ball_group_plan` gives
    the whole call, where the library has one, else a build of
    BALL_SELECT_PROBE (the first version's selection)."""
    import ctypes
    import hashlib

    from pointcloud_tpu_torch import ops
    from pointcloud_tpu_torch.ops import _build

    B, N, _ = xyz.shape
    S = cents.shape[1]
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))
    idx = torch.empty((B, S, k), dtype=torch.int32, device=xyz.device)
    valid = torch.empty((B, S, k), dtype=torch.bool, device=xyz.device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load("ball_group")
    if hasattr(lib, "ball_group_select_launch"):
        p = ops.ball_group_plan(B, N, S, k, feats.shape[2], feats.dtype)
        try:  # a port whose plan refuses k = 781 (a parent) has no idx_slots
            ops.ball_group_plan(1, 1, 1, 781, 0, torch.float32)
            idx_slots = [int(p.route.endswith("-idx"))]
        except ValueError:
            idx_slots = []
        fn = lib.ball_group_select_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * (4 + len(idx_slots))
                       + [ctypes.c_void_p])
        return lambda: fn(xyz.data_ptr(), cents.data_ptr(), None, B, N, S, k, r2,
                          idx.data_ptr(), valid.data_ptr(), p.per_block, p.tile,
                          int(p.route.startswith("shared")), *idx_slots, p.smem, stream)
    src = _build.BUILD_DIR / "probe_ball_select.cu"
    digest = hashlib.sha256(BALL_SELECT_PROBE.encode() + (
        _build.CSRC_DIR / "ball_select.cuh").read_bytes()).hexdigest()[:12]
    so = _build.BUILD_DIR / f"libprobe_ball_select-{digest}.so"
    if not so.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(BALL_SELECT_PROBE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                        "-o", str(so), str(src)], check=True, capture_output=True,
                       timeout=300)
    fn = ctypes.CDLL(str(so)).select_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 2)
    return lambda: fn(xyz.data_ptr(), cents.data_ptr(), B, N, S, k, r2,
                      idx.data_ptr(), stream)


def ball_times(seed):
    """ball_group at PointNet2's SA1 and SA2 (B=256, bf16) on the path's own
    inputs (random weights and clouds from `seed`): equal to the plain
    version, timed (10 calls) beside its staging + selection alone (the
    rest is the write of the grouped rows), the cdist yardstick and the
    bound; the mean number of points each centroid tests (up to its k-th
    in-ball point, else all N). Returns {level: (ms, library ms, bound)}."""
    from pointcloud_tpu_torch.ops import ball_group, ball_group_reference
    from pointcloud_tpu_torch.train import create_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = create_model("Autoencoder", "PointNet2", "Cube", loss_override="chamfer",
                        device=dev, seed=seed)
    bb = spec.model.encoder.backbone
    xn = spec.in_transform(raw_batch(gen, spec.scene, B_PN2, 2048, dev))[0]
    out = {}
    for lvl, sa, (xyz, feats, cents) in zip(
            ("SA1", "SA2"), (bb.SetAbstraction_0, bb.SetAbstraction_1),
            sa_level_inputs(bb, xn)):
        args = (xyz, feats, cents, None, sa.nsample, sa.radius)
        got = twice_equal("ball_group", lambda: ball_group(*args))
        want = ball_group_reference(*args)
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            raise AssertionError(f"ball_group differs from the plain version at {lvl}")
        B, N, F = feats.shape
        S, k = cents.shape[1], sa.nsample
        scanned = torch.where(got[2][..., -1], got[1][..., -1].long() + 1, N)
        bnd = ball_bound(B, N, S, k, F, feats.element_size(), got[1], got[2])
        ms = cuda_ms(lambda: ball_group(*args), iters=10)
        sel = cuda_ms(ball_select_only(xyz, feats, cents, k, sa.radius), iters=10)
        lib = cuda_ms(lambda: ball_library(xyz, feats, cents, k, sa.radius), iters=3,
                      warmup=1)
        out[lvl] = (ms, lib, bnd)
        log(f"  ball_group {lvl}: B={B} N={N} S={S} k={k} F={F} bf16 r={sa.radius}: "
            f"equal to the plain version; {float(scanned.float().mean()):.1f} points "
            f"tested a centroid (mean), {float(got[2].float().mean()):.3f} of the "
            f"slots in a ball; kernel {ms:.4f} ms = staging + selection "
            f"{sel:.4f} ms + the rest {ms - sel:.4f} ms | library cdist + topk + "
            f"gather {lib:.3f} ms | bound {bnd[0]:.4f} ms ({bnd[1]})")
        del got, want
    torch.cuda.empty_cache()
    return out


def grouping_cases(seed):
    """The inputs of knn_group and group_gather at every launch of their
    driven paths, the paths' own (random weights and clouds from `seed`):
    PointMLP's and PointMLP-Elite's four stages at B=32, as (label, xyz,
    feats, centroids), and the MSG autoencoder's six branches at B=32, as
    (label, xyz, feats, centroids, k, radius)."""
    from pointcloud_tpu_torch.train import create_model

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    knn = []
    for backbone in ("PointMLP", "PointMLPE"):
        spec = create_model("Autoencoder", backbone, "Cube", loss_override="chamfer",
                            device=dev, seed=seed)
        xn = spec.in_transform(raw_batch(gen, spec.scene, B_MLP, 2048, dev))[0]
        for i, lv in enumerate(pointmlp_stage_inputs(spec.model.encoder.backbone, xn)):
            knn.append((f"{backbone} stage {i + 1}", *(t.clone() for t in lv)))
        del spec, xn
    spec = msg_spec(dev, seed)
    bb = spec.model.encoder.backbone
    xn = spec.in_transform(raw_batch(gen, spec.scene, B_MSG, 2048, dev))[0]
    with torch.inference_mode():
        levels = msg_level_inputs(bb, xn)
    levels = [tuple(t.clone() for t in lv) for lv in levels]
    ball = [(f"MSG level {lv + 1}, r={r} k={k}", *levels[lv], k, r)
            for lv, r, k in msg_branches(bb)]
    del spec, xn
    torch.cuda.empty_cache()
    return knn, ball


def _module(name):
    """The port's ops module `name` (ops/__init__ binds the wrapper of the
    same name over it)."""
    import importlib

    return importlib.import_module(f"pointcloud_tpu_torch.ops.{name}")


def knn_direct(xyz, feats, cents, k, rows=True):
    """A callable that launches knn_group's kernel on these inputs through
    the library's C entry, into outputs made once: no wrapper checks,
    allocations or counts, so a call's host time stays under the card's and
    CUDA events read the device time. rows=False: the same launch (the plan
    of the whole call) without features or xyz, the staging and selection
    alone. A first version without a plan (a parent commit) launches the
    same geometry whatever the rows."""
    kg = _module("knn_group")
    B, N, _ = xyz.shape
    S, F = cents.shape[1], feats.shape[2]
    esize = feats.element_size()
    idx = torch.empty((B, S, k), dtype=torch.int32, device=xyz.device)
    gf = torch.empty((B, S, k, F), dtype=feats.dtype, device=xyz.device)
    stream = torch.cuda.current_stream().cuda_stream
    fp, f, gp = (feats.data_ptr(), F, gf.data_ptr()) if rows else (None, 0, None)
    word = next(w for w in (16, 8, 4, 2) if (F * esize) % w == 0
                and feats.data_ptr() % w == 0 and gf.data_ptr() % w == 0)
    if hasattr(kg, "knn_group_plan"):
        tail = (word, *kg.plan_args(kg.knn_group_plan(B, N, S, k, F, feats.dtype, word)),
                stream)
        args = (xyz.data_ptr(), fp, esize, cents.data_ptr(), None, B, N, S, k, f,
                idx.data_ptr(), None, gp, *tail)
    else:
        args = (xyz.data_ptr(), fp, esize, cents.data_ptr(), None, B, N, S, k, f,
                int(rows and word == 16), idx.data_ptr(), None, gp, stream)
    fn = kg._launcher()
    return lambda: fn(*args)


def group_gather_direct(xyz, feats, cents, k, radius, rows=True):
    """As knn_direct, for group_gather (idx, valid and the grouped xyz
    written; rows=False: idx and valid alone)."""
    gg = _module("group_gather")
    B, N, _ = xyz.shape
    S = cents.shape[1]
    row = feats.shape[2] * feats.element_size()
    word = gg._word_bytes(row, feats)
    dev = xyz.device
    idx = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    valid = torch.empty((B, S, k), dtype=torch.bool, device=dev)
    gx = torch.empty((B, S, k, 3), dtype=torch.float32, device=dev)
    gf = torch.empty((B, S, k, feats.shape[2]), dtype=feats.dtype, device=dev)
    r2 = float(torch.tensor(radius * radius, dtype=torch.float32))
    stream = torch.cuda.current_stream().cuda_stream
    fp, gxp, gfp = ((feats.data_ptr(), gx.data_ptr(), gf.data_ptr()) if rows
                    else (None, None, None))
    if hasattr(gg, "group_gather_plan"):
        plan = gg.plan_args(gg.group_gather_plan(B, N, S, k, row, word))
        args = (xyz.data_ptr(), fp, word, row if rows else 0, cents.data_ptr(), None, B,
                N, S, k, r2, gxp, gfp, idx.data_ptr(), valid.data_ptr(), *plan, stream)
    else:
        args = (xyz.data_ptr(), fp, word, row // word if rows else 0, cents.data_ptr(),
                None, B, N, S, k, r2, gxp, gfp, idx.data_ptr(), valid.data_ptr(), stream)
    fn = gg._launcher()
    return lambda: fn(*args)


def knn_times(cases):
    """knn_group at each case of grouping_cases: equal to the plain version,
    timed (CUDA events over 20 launches through the C entry, knn_direct)
    beside its staging + selection alone (the rest is the write of the
    rows), the plain version, the library yardstick and the bound. Returns
    {label: (ms, plain ms, library ms, bound)}."""
    from pointcloud_tpu_torch.ops import knn_group, knn_group_reference

    out = {}
    with torch.inference_mode():
        for label, sx, sf, sc in cases:
            args = (sx, sf, sc, None, K_MLP)
            got = twice_equal("knn_group", lambda: knn_group(*args)[1:])
            want = knn_group_reference(*args)[1:]
            if not all(torch.equal(a, w) for a, w in zip(got, want)):
                raise AssertionError(f"knn_group differs from the plain version at "
                                     f"{label}'s own inputs")
            del got, want
            B, N, F = sf.shape
            S = sc.shape[1]
            bnd = knn_bound(B, N, S, K_MLP, F, sf.element_size())
            ms = cuda_ms(knn_direct(sx, sf, sc, K_MLP), iters=20)
            sel = cuda_ms(knn_direct(sx, sf, sc, K_MLP, rows=False), iters=20)
            plain = cuda_ms(lambda: knn_group_reference(*args), iters=2, warmup=1)
            lib = cuda_ms(lambda: knn_library(sx, sf, sc, K_MLP), iters=3, warmup=1)
            torch.cuda.empty_cache()
            out[label] = (ms, plain, lib, bnd)
            log(f"  knn_group {label}: B={B} N={N} S={S} k={K_MLP} F={F} "
                f"{str(sf.dtype)[6:]}: equal to the plain version; kernel {ms:.4f} ms "
                f"= staging + selection {sel:.4f} ms + the rest {ms - sel:.4f} ms | "
                f"plain {plain:.3f} ms | library cdist + topk + gather {lib:.3f} ms | "
                f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    log(f"  knn_group, a PointMLP forward's 4 launches: kernel "
        f"{sum(out[f'PointMLP stage {i}'][0] for i in range(1, 5)):.4f} ms; "
        f"Elite's {sum(out[f'PointMLPE stage {i}'][0] for i in range(1, 5)):.4f} ms")
    return out


def group_gather_times(cases):
    """group_gather at each case of grouping_cases, as knn_times: equal to
    the plain version, timed (group_gather_direct) beside its selection
    alone, the plain version, the library yardstick and the bound (with the
    points each centroid tests). Returns {label: (ms, plain ms, library ms,
    bound)}."""
    from pointcloud_tpu_torch.ops import group_gather, group_gather_reference

    out = {}
    with torch.inference_mode():
        for label, gx, gf, gc, k, r in cases:
            args = (gx, gf, gc, None, k, r)
            got = twice_equal("group_gather", lambda: group_gather(*args))
            want = group_gather_reference(*args)
            if not all(torch.equal(a, w) for a, w in zip(got, want)):
                raise AssertionError(f"group_gather differs from the plain version at "
                                     f"{label}'s own inputs")
            B, N, F = gf.shape
            S = gc.shape[1]
            bnd = group_gather_bound(B, N, S, k, F, gf.element_size(), got[2], got[3])
            scanned = float(torch.where(got[3][..., -1], got[2][..., -1].long() + 1,
                                        N).float().mean())
            fill = float(got[3].float().mean())
            del got, want
            ms = cuda_ms(group_gather_direct(gx, gf, gc, k, r), iters=20)
            sel = cuda_ms(group_gather_direct(gx, gf, gc, k, r, rows=False), iters=20)
            plain = cuda_ms(lambda: group_gather_reference(*args), iters=2, warmup=1)
            lib = cuda_ms(lambda: group_gather_library(gx, gf, gc, k, r), iters=3,
                          warmup=1)
            torch.cuda.empty_cache()
            out[label] = (ms, plain, lib, bnd)
            log(f"  group_gather {label}: B={B} N={N} S={S} F={F} "
                f"{str(gf.dtype)[6:]}: equal to the plain version; {scanned:.1f} "
                f"points tested a centroid (mean), {fill:.3f} of the slots in a ball; "
                f"kernel {ms:.4f} ms = staging + selection {sel:.4f} ms + the rest "
                f"{ms - sel:.4f} ms | plain {plain:.3f} ms | library cdist + first-k "
                f"+ gather {lib:.3f} ms | bound {bnd[0]:.4f} ms ({bnd[1]})")
    log(f"  group_gather, an MSG forward's 6 launches: kernel "
        f"{sum(t[0] for t in out.values()):.4f} ms | bound "
        f"{sum(t[3][0] for t in out.values()):.4f} ms")
    return out


def grouping_times(seed):
    """The grouping kernels alone at every driven shape: ball_group
    (ball_times), scatter_rows (scatter_times), knn_group at PointMLP's and
    Elite's four stages (knn_times), group_gather at the MSG autoencoder's
    six branches (group_gather_times)."""
    ball_times(seed)
    cases, _ = scatter_cases(seed)
    scatter_times(cases)
    del cases
    knn, ball = grouping_cases(seed)
    knn_times(knn)
    group_gather_times(ball)
    del knn, ball
    torch.cuda.empty_cache()


def chamfer_times(seed):
    """chamfer_bwd alone (time_chamfer_bwd) at the train steps' shapes
    (PointNet and PointNet2 at B=256, PointMLP, Elite and MSG at B=32, N=M=
    2048, C=6), at the route check's B=4 x 4096, and on collapsed y clouds
    (every y point within 1e-3 of x point 5: one bucket of every y row) at
    B=256 x 2048 and B=4 x 4096; beside it the segment-sum route that
    Chamfer's backward took above the JAX package's switch before the fused
    kernel took every size (gathers, then two scatter_rows, which cut long
    buckets into pieces of 128), by CUDA events."""
    from pointcloud_tpu_torch.ops import nn_sweep, scatter_rows
    from pointcloud_tpu_torch.ops.chamfer_bwd import nn_terms

    def segment_sum_route(x, y, gx, gy, ax, ay):
        tx, ty = nn_terms(x, y, gx, gy, ax, ay)
        return (scatter_rows(-ty, ay, x.shape[1], init=tx),
                scatter_rows(-tx, ax, y.shape[1], init=ty))

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    for label, B, N, collapsed in (("the PointNet train step's shape", B_TRAIN, 2048, False),
                                   ("the B=32 train steps' shape", 32, 2048, False),
                                   ("the route check", B_ROUTE, P_ROUTE, False),
                                   ("a collapsed cloud", B_TRAIN, 2048, True),
                                   ("a collapsed cloud", B_ROUTE, P_ROUTE, True)):
        args = nn_inputs(gen, B, N, N, 6, masked=False)
        if collapsed:
            x, y = args[0], args[0][:, 5:6] + 1e-3 * args[1]
            _, ax, _, ay = nn_sweep(x, y)
            args = (x, y, args[2], args[3], ax, ay)
        compare_chamfer_bwd(args, label)
        time_chamfer_bwd(args, label)
        log(f"  the segment-sum route at {label}: "
            f"{cuda_ms(lambda: segment_sum_route(*args), iters=10):.4f} ms (events)")
        del args
    torch.cuda.empty_cache()


def kernel_times(seed):
    """Kernels' times alone, on clouds drawn from `seed`: fps at every
    driven shape and at the sensor's (a cluster of 16), nn_sweep at the eval
    step's B=512 x 2048 x 6 (values held against the plain version on the
    first 8 clouds), then the grouping kernels (grouping_times), chamfer_bwd
    (chamfer_times) and bn_pool (bn_pool_times) at every driven shape."""
    from pointcloud_tpu_torch.ops import (
        _build,
        farthest_point_sample,
        nn_sweep,
        nn_sweep_reference,
    )
    from pointcloud_tpu_torch.ops import fps as tfps

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[kernel times] {smi}")
    ptxas_notes(("nn_sweep", "fps", "knn_group", "group_gather"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fps_driven_times(gen)
    # a port before the register block route (to time a parent commit beside
    # this one) has no block geometries to compare
    if hasattr(tfps, "_BLOCK_THREADS"):
        fps_geometries(gen)
    s_xyz = torch.rand((1, 196608, 3), generator=gen, device="cuda")
    s_mask = torch.rand((1, 196608), generator=gen, device="cuda") > 0.5
    s_ms = cuda_ms(lambda: farthest_point_sample(s_xyz, 2048, s_mask), iters=5)
    log(f"  fps sensor: B=1 N=196608 K=2048: kernel {s_ms:.4f} ms, "
        f"{1e3 * s_ms / 2047:.3f} us a step")
    x = torch.rand((B_MAIN, 2048, 6), generator=gen, device="cuda")
    y = torch.rand((B_MAIN, 2048, 6), generator=gen, device="cuda")
    got, want = nn_sweep(x[:8], y[:8]), nn_sweep_reference(x[:8], y[:8])
    e = max(float((got[j] - want[j]).abs().max()) for j in (0, 2))
    if e > 1e-5:
        raise AssertionError(f"nn_sweep differs from the plain version by {e}")
    ms = cuda_ms(lambda: nn_sweep(x, y), iters=10)
    log(f"  nn_sweep B={B_MAIN} N=M=2048 C=6: kernel {ms:.4f} ms | max |value err| "
        f"on 8 clouds {e:.2e}")
    # every query's nearest target is itself, at a cost within rounding of 0
    _, ax, _, _ = nn_sweep(x[:8], x[:8])
    if not torch.equal(ax.long(), torch.arange(2048, device="cuda").expand(8, -1)):
        raise AssertionError("nn_sweep of a cloud against itself must find each point")
    ms = cuda_ms(lambda: nn_sweep(x, x), iters=10)
    log(f"  nn_sweep B={B_MAIN} N=M=2048 C=6, each cloud against itself: kernel {ms:.4f} ms")
    # the tensor-core kernel's diagnostic entry (a parent's library may lack it)
    if hasattr(_build.load("nn_sweep"), "nn_sweep_costs_launch"):
        nn_expansion_error(x, y, f"unit-cube clouds B={B_MAIN} x 2048 x 6")
    del x, y
    torch.cuda.empty_cache()
    grouping_times(seed)
    chamfer_times(seed)
    bn_pool_times()


def step_times(seed):
    """The steps the redesigned kernels serve, alone, through the public
    entry points (weights and clouds from `seed`): the PointNet and PointNet2
    autoencoders' eval steps at bench.py's B=512 and 256, their train steps
    at B=256, the PointMLP, PointMLP-Elite and MSG eval steps at B=32,
    all with Chamfer and bf16; 20 chained eval steps (10 train steps after a
    warm-up) each, host clock to a synchronize, and the median
    event-to-event step."""
    from pointcloud_tpu_torch.train import (
        create_model,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    log("[step times]")
    for backbone, B, train in (("PointNet", B_MAIN, False), ("PointNet", B_TRAIN, True),
                               ("PointNet2", B_PN2, False),
                               ("PointNet2", B_PN2, True), ("PointMLP", B_MLP, False),
                               ("PointMLPE", B_MLP, False), ("PointNet2MSG", B_MSG, False)):
        spec = (msg_spec(dev, seed) if backbone == "PointNet2MSG" else
                create_model("Autoencoder", backbone, "Cube", loss_override="chamfer",
                             device=dev, seed=seed))
        x = raw_batch(gen, spec.scene, B, spec.scene.sample_points, dev)
        if train:
            r = drive_train(make_train_step(spec, make_optimizer(spec)), x, x, TRAIN_ITERS)
        else:
            r = drive_eval(make_eval_step(spec), x, ITERS)
        per = r["per_iter"]
        log(f"  {backbone} {'train' if train else 'eval'} step B={B}: {r['ms']:.3f} "
            f"ms/step on the host clock, event-to-event median {per[len(per) // 2]:.3f} "
            f"ms; launches {r['counts']}")
        del spec, x, r
        torch.cuda.empty_cache()



B_LOOP = 25  # cfg.vision_batch_size, the CLI's default batch
LOOP_TRAIN, LOOP_VAL = 100, 30  # frames: 4 train steps an epoch, val batches 25 + 5


def write_frames(root, sc, frames, points, seed):
    """`frames` npz files of the generate_pc contract in `root`: points in
    the scene's bbox, rgb in [0, 1], a class label a point, the bbox, and
    the `ground_truth` (state name, value) pairs of the scene's states
    (positions in the bbox, the other states normal draws), which
    PointCloudGTDataset reads."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    bbox = np.asarray(sc.bbox, np.float32)
    os.makedirs(root, exist_ok=True)
    for i in range(frames):
        xyz = bbox[:, 0] + rng.random((points, 3), dtype=np.float32) * (
            bbox[:, 1] - bbox[:, 0])
        gt = [(name, bbox[:, 0] + rng.random(3, dtype=np.float32) * (bbox[:, 1] - bbox[:, 0])
               if d == 3 else rng.standard_normal(d).astype(np.float32))
              for name, d in zip(sc.states, sc.state_dim) if name]
        ground_truth = np.empty(len(gt), dtype=object)
        ground_truth[:] = gt
        np.savez(os.path.join(root, f"{i}.npz"), points=xyz,
                 rgb=rng.random((points, 3), dtype=np.float32),
                 segmentation=rng.integers(0, len(sc.classes), points).astype(np.int32),
                 boundingbox=bbox, ground_truth=ground_truth)


class StepCounts:
    """The kernels' launches of every optimizer step (read and set to 0 by a
    global post-step hook: a train step launches all of its kernels before
    Adam's step) and of each epoch's validation (read and set to 0 by
    train()'s on_epoch callback, which runs after it)."""

    def __init__(self):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        self.steps, self.vals, self.epochs = [], [], []
        self._hook = register_optimizer_step_post_hook(self._step)

    def _step(self, *_):
        self.steps.append(read_counts())
        zero_counts()

    def on_epoch(self, stats):
        self.vals.append(read_counts())
        zero_counts()
        self.epochs.append(stats)

    def close(self):
        self._hook.remove()


def loop_counts_alone(loss_override, dev, seed, model_type="Autoencoder"):
    """The launches of one make_train_step call at B_LOOP and of one eval
    step at B_LOOP and at the ragged val batch, each driven alone."""
    from pointcloud_tpu_torch.train import (
        create_model,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    spec = create_model(model_type, "PointNet2", "Cube", loss_override=loss_override,
                        device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = spec.scene.sample_points
    x = raw_batch(gen, spec.scene, B_LOOP, P, dev)
    y = head_target(gen, spec, x)
    step = make_train_step(spec, make_optimizer(spec))
    zero_counts()
    step(x, y)
    torch.cuda.synchronize()
    train = read_counts()
    estep = make_eval_step(spec)
    val = {name: 0 for name in train}
    for B in (B_LOOP, LOOP_VAL % B_LOOP):
        zero_counts()
        estep(x[:B], first_rows(y, B))
        torch.cuda.synchronize()
        for name, n in read_counts().items():
            val[name] += n
    return train, val


def check_loop_counts(label, counts, train, val, epochs):
    """Every optimizer step of the loop launched exactly what one
    make_train_step call does alone, and every epoch's validation what the
    eval step does alone at the val batches."""
    steps = epochs * (LOOP_TRAIN // B_LOOP)
    if len(counts.steps) != steps or len(counts.vals) != epochs:
        raise AssertionError(f"{label}: {len(counts.steps)} optimizer steps and "
                             f"{len(counts.vals)} epochs, expected {steps} and {epochs}")
    for i, got in enumerate(counts.steps):
        if got != train:
            raise AssertionError(f"{label}: step {i} launched {got}, make_train_step "
                                 f"alone {train}")
    for i, got in enumerate(counts.vals):
        if got != val:
            raise AssertionError(f"{label}: epoch {i}'s validation launched {got}, "
                                 f"the eval steps alone {val}")


def encoder_only_encode(model_type, last, ck, seed):
    """create_model(model_type, "PointNet2", "Cube", load_dir=last,
    encoder_only=True) on the card: every key under a `decoder*` module
    equal to a fresh init's, every other key to the checkpoint payload
    `ck`'s; then `encode` on one cloud, finite. Returns the encoding (its
    per-class parts concatenated)."""
    from pointcloud_tpu_torch.train import create_model

    dev = torch.device("cuda")
    spec = create_model(model_type, "PointNet2", "Cube", device=dev, seed=seed + 1,
                        load_dir=last, encoder_only=True)
    fresh = create_model(model_type, "PointNet2", "Cube", device="cpu",
                         seed=seed + 1).model.state_dict()
    for key, value in spec.model.state_dict().items():
        want = fresh[key] if key.startswith("decoder") else ck["model"][key]
        if not torch.equal(value.cpu(), want):
            raise AssertionError(f"{model_type} encoder_only load: {key} differs")
    sc = spec.scene
    cloud = raw_batch(torch.Generator(device=dev).manual_seed(seed), sc, 1,
                      sc.sample_points, dev)
    with torch.inference_mode():
        z = spec.model.encode(spec.in_transform(cloud)[0])
    z = torch.cat(list(z.values()), -1) if isinstance(z, dict) else z
    if not bool(torch.isfinite(z).all()):
        raise AssertionError(f"{model_type}: encode after an encoder_only load")
    return z


def train_loop_path(seed, smi):
    """Phase 15: train() over npz frames on the card (see the module
    docstring)."""
    import os
    import shutil
    import tempfile

    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.data.native_loader import NativeCloudPairLoader
    from pointcloud_tpu_torch.data.native_loader import build as build_loader
    from pointcloud_tpu_torch.ops import _build
    from pointcloud_tpu_torch.train import create_model, make_optimizer, make_train_step
    from pointcloud_tpu_torch.train.harness import (
        checkpoint_payload,
        latest_checkpoint,
        load_checkpoint_raw,
        save_checkpoint,
        train,
    )

    dev = torch.device("cuda")
    log(f"[train() loop] Autoencoder / PointNet2, scene Cube, {LOOP_TRAIN} train and "
        f"{LOOP_VAL} val npz frames, B={B_LOOP}, bf16")
    if not cfg.use_native_loader:
        raise AssertionError("cfg.use_native_loader is off: the loop would not "
                             "read through the native loader")
    t0 = time.perf_counter()
    lib = build_loader()
    log(f"  native loader library {lib.name} ({time.perf_counter() - t0:.1f} s, "
        f"built or reused in {lib.parent})")
    work = tempfile.mkdtemp(prefix="train_loop-", dir=_build.BUILD_DIR)
    try:
        sc = create_model("Autoencoder", "PointNet2", "Cube", device="cpu").scene
        P = sc.sample_points
        data = os.path.join(work, "input", "Cube")
        t0 = time.perf_counter()
        write_frames(os.path.join(data, "train"), sc, LOOP_TRAIN, P, seed)
        write_frames(os.path.join(data, "val"), sc, LOOP_VAL, P, seed + 1)
        log(f"  wrote {LOOP_TRAIN} + {LOOP_VAL} frames of {P} points in "
            f"{time.perf_counter() - t0:.1f} s")

        # the native loader alone: 3 epochs of shuffled train batches
        loader = NativeCloudPairLoader(os.path.join(data, "train"), batch_size=B_LOOP,
                                       seed=seed, threads=cfg.loader_threads,
                                       prefetch=cfg.prefetch_batches)
        t0 = time.perf_counter()
        n = sum(1 for _ in range(3) for _ in loader)
        loader_bps = n / (time.perf_counter() - t0)
        log(f"  native loader: {n} batches of {B_LOOP} x {P} x 6 in 3 epochs, "
            f"{loader_bps:.1f} batches/s ({loader_bps * B_LOOP:.0f} clouds/s; "
            f"{cfg.loader_threads} threads, host clock)")
        del loader

        emd_train, emd_val = loop_counts_alone(None, dev, seed)
        expect_counts("the EMD train step alone", emd_train, fps=2, ball_group=2,
                      mm_stats=3, bnact_mm_stats=6, bn_pool=3, chain_bwd_pass=9,
                      scatter_rows=1, sinkhorn=1)
        expect_counts("the EMD eval steps alone", emd_val, fps=4, ball_group=4,
                      sinkhorn=2)
        ch_train, ch_val = loop_counts_alone("chamfer", dev, seed)
        expect_counts("the Chamfer train step alone", ch_train, fps=2, ball_group=2,
                      mm_stats=3, bnact_mm_stats=6, bn_pool=3, chain_bwd_pass=9,
                      scatter_rows=1, nn_sweep=1, chamfer_bwd=1)
        expect_counts("the Chamfer eval steps alone", ch_val, fps=4, ball_group=4,
                      nn_sweep=2)
        log(f"  make_train_step alone, a step: EMD {emd_train}; Chamfer {ch_train}")

        out = os.path.join(work, "output")
        kw = dict(scene="Cube", batch_size=B_LOOP, input_root=os.path.join(work, "input"),
                  output_root=out, seed=seed, device="cuda")
        runs = {}
        for label, extra, epochs in (
                ("EMD, 2 epochs", {}, 2),
                ("EMD, resumed for a third", {"ckpt_path": "step_1"}, 3),
                ("Chamfer, 1 epoch, profiled", {"loss_override": "chamfer",
                                                "profile": True}, 1)):
            if "ckpt_path" in extra:
                extra = dict(extra, ckpt_path=os.path.join(runs["EMD, 2 epochs"][1],
                                                           extra["ckpt_path"]))
            counts = StepCounts()
            zero_counts()
            t0 = time.perf_counter()
            try:
                loss, ckpt_dir = train("Autoencoder", "PointNet2", epochs=epochs,
                                       on_epoch=counts.on_epoch, **kw, **extra)
            finally:
                counts.close()
            wall = time.perf_counter() - t0
            runs[label] = (loss, ckpt_dir, counts, wall)
            chamfer = "loss_override" in extra
            check_loop_counts(label, counts, ch_train if chamfer else emd_train,
                              ch_val if chamfer else emd_val, len(counts.epochs))
            for e in counts.epochs:
                log(f"  {label}: epoch {e['epoch']} train_loss {e['train_loss']:.6f} "
                    f"val_loss {e['val_loss']:.6f} (val batches {B_LOOP} + "
                    f"{LOOP_VAL % B_LOOP}); {e['steps']} steps in {e['seconds']:.3f} s "
                    f"-> {e['clouds_per_s']:.1f} clouds/s, loader wait "
                    f"{e['loader_wait_s'] * 1e3:.1f} ms, validation "
                    f"{e['val_seconds'] * 1e3:.1f} ms, checkpoint snapshot "
                    f"{e['checkpoint_s'] * 1e3:.1f} ms ({'saved' if e['checkpoint'] else 'none'})")
                if not all(map(math.isfinite, (e["train_loss"], e["val_loss"]))):
                    raise AssertionError(f"{label}: non-finite loss in {e}")
            log(f"  {label}: train() {wall:.2f} s in all; returned loss {loss:.6f}, "
                f"{os.path.relpath(ckpt_dir, out)}; every step's launches equal "
                f"make_train_step's alone, every validation's the eval steps' alone")

        loss2, dir2 = runs["EMD, 2 epochs"][:2]
        loss3, dir3 = runs["EMD, resumed for a third"][:2]
        _, dir_ch = runs["Chamfer, 1 epoch, profiled"][:2]
        if not dir2.endswith(os.path.join("version_0", "checkpoints")) or dir3 != dir2:
            raise AssertionError(f"version dirs {dir2}, resumed {dir3}")
        if not dir_ch.endswith(os.path.join("version_1", "checkpoints")):
            raise AssertionError(f"the Chamfer run's dir {dir_ch}, expected version_1")
        if [e["epoch"] for e in runs["EMD, resumed for a third"][2].epochs] != [2]:
            raise AssertionError("the resumed run did not take epoch 2 alone")
        last = latest_checkpoint(dir3)
        if not last.endswith("step_2") or sorted(os.listdir(dir3)) != [
                "step_0", "step_1", "step_2"]:
            raise AssertionError(f"checkpoints {sorted(os.listdir(dir3))}, latest {last}")
        ck = load_checkpoint_raw(last)
        steps = {float(s["step"]) for s in ck["optimizer"]["state"].values()}
        if steps != {3.0 * LOOP_TRAIN // B_LOOP} or ck["epoch"] != 2:
            raise AssertionError(f"step_2 holds Adam steps {steps}, epoch {ck['epoch']}")
        trace = os.path.join(os.path.dirname(dir_ch), "profile", "trace.json")
        if not os.path.isfile(trace):
            raise AssertionError(f"profile=True wrote no {trace}")
        run_files = os.listdir(os.path.dirname(dir2))
        import importlib.util
        writer = ("SummaryWriter" if importlib.util.find_spec("tensorboard")
                  else "the null writer (tensorboard is not installed)")
        events = [f for f in run_files if f.startswith("events.out.tfevents")]
        if (writer == "SummaryWriter") != bool(events):
            raise AssertionError(f"writer {writer} but event files {events}")
        log(f"  checkpoints {sorted(os.listdir(dir3))} in version_0 (resumed in place, "
            f"Adam's step {steps.pop():.0f} carried over, epoch {ck['epoch']}); the Chamfer "
            f"run in version_1 with a trace ({os.path.getsize(trace)} bytes); writer: "
            f"{writer} ({len(events)} event files)")

        # the encoder of the resumed run's last checkpoint into a fresh model
        z = encoder_only_encode("Autoencoder", last, ck, seed)
        if z.shape != (1, sum(sc.class_latent_dim)):
            raise AssertionError(f"encode after an encoder_only load: {tuple(z.shape)}")
        log(f"  create_model(load_dir=step_2, encoder_only=True): encoder keys equal "
            f"the checkpoint's, decoder keys the fresh init's; encode(1 cloud) -> "
            f"{tuple(z.shape)}")

        # the same step chained on one batch, and a checkpoint written alone
        spec = create_model("Autoencoder", "PointNet2", "Cube", device=dev, seed=seed)
        opt = make_optimizer(spec)
        x = raw_batch(torch.Generator(device=dev).manual_seed(seed + 2), sc, B_LOOP,
                      P, dev)
        tr = drive_train(make_train_step(spec, opt), x, x, 10)
        payload = checkpoint_payload(spec, opt, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(work, "alone"), 0, payload)
        ckpt_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()  # its parts: the copy to the host, the write
        host = [t.cpu() for t in payload["model"].values()] + [
            t.cpu() for s in payload["optimizer"]["state"].values() for t in s.values()]
        copy_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        torch.save(host, os.path.join(work, "alone", "parts.pt"))
        write_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(os.path.join(work, "alone", "step_0", "checkpoint.pt"))
        # the resumed run's epoch has no checkpoint write behind it; epoch 1
        # of the first run has epoch 0's
        loop = runs["EMD, resumed for a third"][2].epochs[0]
        behind = runs["EMD, 2 epochs"][2].epochs[1]
        log(f"  the loop's steady epoch (EMD, the resumed epoch 2): "
            f"{loop['clouds_per_s']:.1f} clouds/s ({loop['seconds'] / loop['steps'] * 1e3:.3f} "
            f"ms a step, loader wait {loop['loader_wait_s'] * 1e3:.1f} ms, the epoch's "
            f"final synchronize included); the epoch behind a checkpoint write (epoch 1) "
            f"{behind['clouds_per_s']:.1f} clouds/s | the same step chained on one batch: "
            f"{tr['ms']:.3f} ms/step -> {B_LOOP / tr['ms'] * 1e3:.1f} clouds/s, host "
            f"enqueue {tr['enqueue_ms']:.3f} ms | native loader {loader_bps:.1f} batches/s | "
            f"save_checkpoint alone {ckpt_ms:.1f} ms ({size / 2**20:.1f} MiB; apart: "
            f"copy to the host {copy_ms:.1f} ms, torch.save {write_ms:.1f} ms), "
            f"snapshot in the loop {loop['checkpoint_s'] * 1e3:.1f} ms | {smi}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


B_HEADS = 64  # benchmarks/config_step_bench.py's MultiSegmenter and StatePredictor batch


def head_target(gen, spec, x, drop=()):
    """The target a model type's step takes for the clouds x: the clouds
    themselves (Autoencoder); xyz and a random class label a point
    (Segmenter, MultiSegmenter), where `drop` lists (cloud, label) pairs
    whose label that cloud then lacks (its points take the next class); or
    a dict of the scene's states (StatePredictor: positions in the bbox,
    the other states normal draws)."""
    sc, (B, P) = spec.scene, x.shape[:2]
    if spec.model_type == "Autoencoder":
        return x
    if spec.model_type == "StatePredictor":
        bbox = torch.tensor(sc.bbox, dtype=torch.float32, device=x.device)
        return {name: (bbox[:, 0] + torch.rand((B, 3), generator=gen, device=x.device)
                       * (bbox[:, 1] - bbox[:, 0])) if d == 3
                else torch.randn((B, d), generator=gen, device=x.device)
                for name, d in zip(sc.states, sc.state_dim) if d > 0}
    C = len(sc.classes)
    labels = torch.randint(0, C, (B, P), generator=gen, device=x.device)
    for cloud, label in drop:
        row = labels[cloud]
        labels[cloud] = torch.where(row == label, (label + 1) % C, row)
    return torch.cat([x[..., :3], labels[..., None].float()], dim=-1)


def first_rows(y, B):
    """The first B clouds of a target (a tensor or a dict of them)."""
    if isinstance(y, dict):
        return {k: v[:B] for k, v in y.items()}
    return y[:B]


def segmenting_loss_kernels(spec, x, y, label, err):
    """The segmenting Chamfer's kernels at a MultiSegmenter step's own
    inputs: one train-mode forward, the loss and its backward (to the
    decoders' outputs only; the model is not updated) with `nn_sweep` and
    `chamfer_bwd` recorded, then each held against its plain version on what
    it was handed (chamfer_bwd at the kernel's own argmins) and timed; the
    loss against the plain version's on the CPU, relative to its size (an
    absent class puts ~1e10 into it). Returns the timings of both."""
    from pointcloud_tpu_torch.ops import chamfer as tchamfer

    xn = spec.in_transform(x)[0]
    yn = spec.out_transform(y)[0]
    with torch.no_grad():
        pred = spec.model(xn, train=True)
    pred = {k: v.detach().requires_grad_() for k, v in pred.items()}
    zero_counts()
    with recording(tchamfer, "nn_sweep") as nn_calls, \
            recording(tchamfer, "chamfer_bwd") as bwd_calls:
        loss = spec.loss(pred, yn)
        loss.backward()
        torch.cuda.synchronize()
        # read inside: leaving `recording` hands the stand-ins' attributes back
        counts = read_counts()
    expect_counts(f"the segmenting loss at {label}", counts, nn_sweep=1, chamfer_bwd=1)
    cpu = float(spec.loss({k: v.detach().cpu() for k, v in pred.items()}, yn.cpu()))
    card = float(loss.detach())
    if abs(card - cpu) > 1e-5 * abs(cpu):
        raise AssertionError(f"segmenting loss at {label}: card {card} vs plain {cpu}")
    px, ty, pm, tm = (t.detach() for t in nn_calls[0][0])
    err["nn_sweep"] = max(err["nn_sweep"], compare_nn_sweep(px, ty, pm, tm, label)[0])
    args = bwd_calls[0][0]
    err["chamfer_bwd"] = max(err["chamfer_bwd"], compare_chamfer_bwd(args, label))
    log(f"  segmenting loss at {label}: card {card:.7g}, plain version (CPU) {cpu:.7g}, "
        f"rel diff {abs(card - cpu) / abs(cpu):.2e}; one nn_sweep and one chamfer_bwd "
        f"launch over the (C*B, Nmax, 3) stack {tuple(px.shape)} against "
        f"{tuple(ty.shape)}")
    return time_nn_sweep(px, ty, pm, tm, label), time_chamfer_bwd(args, label)


def card_vs_cpu_head_models(seed, x_raw):
    """The fp32 MultiSegmenter and StatePredictor on the card and on the
    CPU from the same weights: eval outputs 1e-4 and the eval loss 1e-5
    relative on two distinct clouds; on one cloud repeated (B=2: the STN
    heads' batch variance is then 0 on both sides) the first train step's
    loss 1e-5 relative, its gradients 1e-3 relative plus 3e-3 of each
    tensor's largest entry (zero-gradient biases round-off), and the first
    update 1e-3 relative where the gradient is above noise (1% of its
    tensor's largest entry and 1e-6), every entry within 2 lr. The
    gradients follow nn_sweep's nearest neighbours: the gate holds where the
    card picks the CPU's (the count that differ is logged)."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import chamfer as tchamfer
    from pointcloud_tpu_torch.ops import nn_sweep_reference
    from pointcloud_tpu_torch.train import (
        create_model,
        make_eval_step,
        make_optimizer,
        make_train_step,
        zero_gradient_biases,
    )

    for model_type in ("MultiSegmenter", "StatePredictor"):
        cfg.precision = "fp32"
        try:
            specs = [create_model(model_type, "PointNet", "Cube", device=d, seed=seed)
                     for d in ("cuda", "cpu")]
        finally:
            cfg.precision = "bf16-mixed"
        gen = torch.Generator(device="cuda").manual_seed(seed + 21)
        x2 = x_raw[:2].contiguous()
        y2 = head_target(gen, specs[0], x2)
        xs = x_raw[:1].repeat(2, 1, 1)
        ys = {k: v[:1].repeat(2, 1) for k, v in y2.items()} if isinstance(y2, dict) \
            else y2[:1].repeat(2, 1, 1)
        evals, losses, grads, updates = [], [], [], []
        for spec in specs:
            dev = next(spec.model.parameters()).device
            to = (lambda t: {k: v.to(dev) for k, v in t.items()}
                  if isinstance(t, dict) else t.to(dev))
            loss, _, out = make_eval_step(spec)(x2.to(dev), to(y2))
            evals.append((float(loss), {k: v.float().cpu() for k, v in out.items()}))
            step = make_train_step(spec, make_optimizer(spec))
            before = {k: p.detach().cpu().clone() for k, p in spec.model.named_parameters()}
            with recording(tchamfer, "nn_sweep") as nn_calls:
                losses.append(float(step(xs.to(dev), to(ys))[0]))
            grads.append({k: p.grad.detach().float().cpu()
                          for k, p in spec.model.named_parameters()})
            updates.append({k: p.detach().cpu() - before[k]
                            for k, p in spec.model.named_parameters()})
            if nn_calls and dev.type == "cuda":
                nn_args = [t.detach() for t in nn_calls[0][0]]
        (l_gpu, o_gpu), (l_cpu, o_cpu) = evals
        e_out = max(float((o_gpu[k] - o_cpu[k]).abs().max()) for k in o_cpu)
        if e_out > 1e-4 or abs(l_gpu - l_cpu) > 1e-5 * abs(l_cpu):
            raise AssertionError(f"{model_type} fp32 eval card vs CPU: out err {e_out}, "
                                 f"loss {l_gpu} vs {l_cpu}")
        flips = 0
        if model_type == "MultiSegmenter":  # the card's first train step's sweep
            from pointcloud_tpu_torch.ops import nn_sweep

            card = nn_sweep(*nn_args)
            plain = nn_sweep_reference(*(t.cpu() for t in nn_args))
            flips = sum(int((card[j].cpu() != plain[j]).sum()) for j in (1, 3))
        zero = zero_gradient_biases(specs[1].model)
        worst = check_card_grads(model_type, grads[0], grads[1], zero)
        for k, want in grads[1].items():
            if k in zero:
                continue
            ut, uc = updates[0][k], updates[1][k]
            if float((ut - uc).abs().max()) > 2 * cfg.vision_lr:
                raise AssertionError(f"{model_type} {k}: first updates > 2 lr apart")
            sig = (want.abs() > 1e-2 * want.abs().max()) & (want.abs() > 1e-6)
            if bool(((ut - uc).abs() > 1e-3 * uc.abs())[sig].any()):
                raise AssertionError(f"{model_type} {k}: first update differs")
        if abs(losses[0] - losses[1]) > 1e-5 * abs(losses[1]):
            raise AssertionError(f"{model_type} first train loss {losses}")
        log(f"  {model_type} fp32, card vs CPU, B=2: eval max |out err| {e_out:.2e}, "
            f"loss {l_gpu:.7g} vs {l_cpu:.7g}; first train loss {losses[0]:.7g} vs "
            f"{losses[1]:.7g}; gradients max rel err {worst:.2e}; first update held; "
            f"nearest-neighbour indices card vs CPU differing: {flips}")


def heads_paths(seed, smi, err):
    """Phase 16: the MultiSegmenter and the StatePredictor (see the module
    docstring). Returns {model type: drive_train result}."""
    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.models import MLPChainPool
    from pointcloud_tpu_torch.train import (
        create_model,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    pn_step = dict(dense_pool_stats=3, dense_pool_stats_bwd=3)
    results = {}
    for model_type in ("MultiSegmenter", "StatePredictor"):
        spec = create_model(model_type, "PointNet", "Cube", device=dev, seed=seed)
        sc = spec.scene
        x = raw_batch(gen, sc, B_HEADS, sc.sample_points, dev)
        y = head_target(gen, spec, x)
        seg = model_type == "MultiSegmenter"
        what = ("experts " + ", ".join(f"{n} {p} points / {d}-d"
                                       for n, p, d in spec.model.name_points_dims)
                if seg else "heads " + ", ".join(f"{n} {d}-d" for n, d in
                                                 spec.model.state_dims.items()))
        log(f"[{model_type}] {model_type} / PointNet, scene Cube ({what}), "
            f"B={B_HEADS} x {sc.sample_points} x 6, bf16")
        ev = drive_eval(make_eval_step(spec), x, TRAIN_ITERS, y0=y)
        expect_counts(f"{model_type} eval path", ev["counts"],
                      nn_sweep=(TRAIN_ITERS + 1) if seg else 0)
        out = ev["out"]
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        want = ({n: (B_HEADS, p, 3) for n, p, _ in spec.model.name_points_dims} if seg
                else {n: (B_HEADS, d) for n, d in spec.model.state_dims.items()})
        if shapes != want or not bool(torch.isfinite(ev["loss"])) or not all(
                bool(torch.isfinite(v).all()) and float(v.min()) >= 0
                and float(v.max()) <= 1 for v in out.values()):
            raise AssertionError(f"{model_type} eval: loss {ev['loss']}, out {shapes}")
        log(f"  eval step B={B_HEADS}: first call {ev['first_s']:.3f} s; "
            f"{TRAIN_ITERS} chained steps {ev['ms']:.3f} ms/step on the host clock -> "
            f"{B_HEADS / (ev['ms'] / 1e3):.1f} clouds/s; event-to-event median "
            f"{ev['per_iter'][TRAIN_ITERS // 2]:.3f} ms; peak memory "
            f"{ev['peak']:.2f} GiB | {smi}")
        log(f"  loss {float(ev['loss']):.6f}; outputs {shapes} in [0, 1]; launches "
            f"{ev['counts']}")
        with torch.inference_mode():
            one = spec.in_transform(x[:1])[0]
            z = (spec.model.encode_flat(one) if seg else spec.model.encode(one))
        if z.shape != (1, sum(sc.class_latent_dim) if seg else sum(
                spec.model.state_dims.values())) or not bool(torch.isfinite(z).all()):
            raise AssertionError(f"{model_type} encode: {tuple(z.shape)}")
        log(f"  {'encode_flat' if seg else 'encode'}(1 cloud) -> {tuple(z.shape)}")

        opt = make_optimizer(spec)
        tstep = make_train_step(spec, opt)
        tr = drive_train(tstep, x, y, TRAIN_ITERS)
        expect_counts(f"{model_type} train path", tr["counts"],
                      **{k: v * TRAIN_ITERS for k, v in pn_step.items()},
                      **(dict(nn_sweep=TRAIN_ITERS, chamfer_bwd=TRAIN_ITERS) if seg
                         else {}))
        report_train(f"{model_type} train path", B_HEADS, tr, set(), smi)
        trace_steps(tstep, x, y, tr["ms"], f"{model_type} train step, B={B_HEADS}",
                    tr["enqueue_ms"])
        results[model_type] = tr
        if seg:
            fwd_ms, bwd_ms, opt_ms = step_parts(spec, opt, x, y)
            log(f"  train step parts (median of 3, CUDA events): forward + loss "
                f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, Adam {opt_ms:.3f} ms")
            results["times"] = segmenting_loss_kernels(
                spec, x, y, f"the B={B_HEADS} MultiSegmenter step's own inputs", err)
            # one cloud without the cube, one without the gripper
            labels = spec.loss.class_labels
            ya = head_target(gen, spec, x, drop=((0, labels["cube"]),
                                                 (1, labels["gripper"])))
            results["absent"] = segmenting_loss_kernels(
                spec, x, ya, "a batch whose cloud 0 lacks the cube and cloud 1 the "
                "gripper", err)
        del spec, opt, tstep, ev, out
        torch.cuda.empty_cache()

    log(f"[MultiSegmenter / PointNet2] B={B_HEADS} x 2048, bf16: one eval and one "
        f"train step")
    spec = create_model("MultiSegmenter", "PointNet2", "Cube", device=dev, seed=seed)
    x = raw_batch(gen, spec.scene, B_HEADS, spec.scene.sample_points, dev)
    y = head_target(gen, spec, x)
    zero_counts()
    loss, _, out = make_eval_step(spec)(x, y)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("MultiSegmenter / PointNet2 eval step", counts, fps=2, ball_group=2,
                  nn_sweep=1)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"MultiSegmenter / PointNet2 eval: loss {loss}")
    log(f"  eval step: loss {float(loss):.6f}; launches {counts}")
    tstep = make_train_step(spec, make_optimizer(spec))
    zero_counts()
    loss, _ = tstep(x, y)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("MultiSegmenter / PointNet2 train step", counts, fps=2, ball_group=2,
                  mm_stats=3, bnact_mm_stats=6, bn_pool=3, chain_bwd_pass=9,
                  scatter_rows=1, nn_sweep=1, chamfer_bwd=1)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"MultiSegmenter / PointNet2 train: loss {loss}")
    log(f"  train step: loss {float(loss):.6f}; launches {counts}")
    del spec, tstep, out
    torch.cuda.empty_cache()

    log("[MLPChainPool] the chain's four passes with one group of N rows a cloud "
        "(pool = N) against their plain versions")
    gen_chain = torch.Generator(device=dev).manual_seed(seed + 22)
    layout = [(6, 64), (64, 128), (128, 1024)]  # PointNet's widths as one chain
    for R, dtype, final_relu in ((2048, torch.bfloat16, False), (2048, torch.bfloat16, True),
                                 (2000, torch.bfloat16, True), (2048, torch.float32, False),
                                 (2000, torch.float32, True)):
        check_chain(gen_chain, 8, R, layout, R, dtype, True, final_relu, err)
    chain = MLPChainPool(6, [c for _, c in layout], final_relu=True,
                         dtype=cfg.compute_dtype(dev))
    from pointcloud_tpu_torch.models.layers import init_flax_

    init_flax_(chain, torch.Generator().manual_seed(seed))
    chain = chain.to(dev)
    xc = raw_batch(gen, sc, B_HEADS, 2048, dev)
    mc = torch.rand((B_HEADS, 2048), generator=gen, device=dev) > 0.1
    mc[0] = False  # a cloud without a valid point
    zero_counts()
    outc = chain(xc, train=True, mask=mc)
    outc.float().square().sum().backward()
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("MLPChainPool train forward + backward", counts, mm_stats=1,
                  bnact_mm_stats=2, bn_pool=1, chain_bwd_pass=3)
    # the sentinel -1e9 in bf16 (-999817216)
    if outc.shape != (B_HEADS, 1024) or not bool((outc[0].float() < -5e8).all()) \
            or not bool(torch.isfinite(outc[1:].float()).all()):
        raise AssertionError(f"MLPChainPool: out {tuple(outc.shape)}")
    ms = cuda_ms(lambda: chain(xc, train=True, mask=mc).float().sum().backward(), iters=5)
    log(f"  MLPChainPool(6 -> 64 -> 128 -> 1024, final_relu) train forward + backward "
        f"at B={B_HEADS} x 2048, a cloud fully masked: launches {counts}; {ms:.3f} ms "
        f"| {smi}")
    del chain, xc, mc, outc
    torch.cuda.empty_cache()
    return results


def heads_loop(seed, smi):
    """Phase 16's loop: train() of each of the two model types (PointNet2,
    the CLI's default backbone) for one epoch over phase 15's frames, every
    optimizer step's launches equal to one make_train_step call's alone and
    every validation the eval steps' alone, then the checkpoint's encoder
    (bottlenecks or heads) loaded with encoder_only and `encode` on one
    cloud."""
    import os
    import shutil
    import tempfile

    from pointcloud_tpu_torch.envs.scenes import scene_config
    from pointcloud_tpu_torch.ops import _build
    from pointcloud_tpu_torch.train.harness import (
        latest_checkpoint,
        load_checkpoint_raw,
        train,
    )

    dev = torch.device("cuda")
    log(f"[train() loop, MultiSegmenter and StatePredictor] PointNet2, scene Cube, "
        f"{LOOP_TRAIN} train and {LOOP_VAL} val npz frames, B={B_LOOP}, bf16")
    work = tempfile.mkdtemp(prefix="heads_loop-", dir=_build.BUILD_DIR)
    try:
        sc = scene_config("Cube")
        P = sc.sample_points
        data = os.path.join(work, "input", "Cube")
        write_frames(os.path.join(data, "train"), sc, LOOP_TRAIN, P, seed)
        write_frames(os.path.join(data, "val"), sc, LOOP_VAL, P, seed + 1)
        for model_type in ("MultiSegmenter", "StatePredictor"):
            train_counts, val_counts = loop_counts_alone(None, dev, seed, model_type)
            counts = StepCounts()
            zero_counts()
            t0 = time.perf_counter()
            try:
                _, ckpt_dir = train(model_type, "PointNet2", "Cube", epochs=1,
                                    batch_size=B_LOOP, seed=seed, device="cuda",
                                    input_root=os.path.join(work, "input"),
                                    output_root=os.path.join(work, "output"),
                                    on_epoch=counts.on_epoch)
            finally:
                counts.close()
            wall = time.perf_counter() - t0
            check_loop_counts(model_type, counts, train_counts, val_counts, 1)
            e = counts.epochs[0]
            if not all(map(math.isfinite, (e["train_loss"], e["val_loss"]))):
                raise AssertionError(f"{model_type}: non-finite loss in {e}")
            last = latest_checkpoint(ckpt_dir)
            ck = load_checkpoint_raw(last)
            if ck["config"]["model_type"] != model_type or not last.endswith("step_0"):
                raise AssertionError(f"{model_type}: checkpoint {last}, {ck['config']}")
            flat = encoder_only_encode(model_type, last, ck, seed)
            log(f"  {model_type}: train() 1 epoch in {wall:.2f} s, train_loss "
                f"{e['train_loss']:.6f} val_loss {e['val_loss']:.6f} ({e['steps']} steps, "
                f"{e['clouds_per_s']:.1f} clouds/s); every step's launches {train_counts}, "
                f"validation's {val_counts}; step_0 written; encoder_only load + encode "
                f"-> {tuple(flat.shape)} | {smi}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def heads_phase(seed, smi, err, x2):
    """Phase 16 in full: the paths, the fp32 models card vs CPU on the two
    clouds x2, the loop."""
    heads_paths(seed, smi, err)
    log("[card vs CPU, MultiSegmenter and StatePredictor]")
    card_vs_cpu_head_models(seed, x2)
    heads_loop(seed, smi)


############################ 17. the sensor -> encoder -> GoalEnv bridge ############################

BRIDGE_STEPS = 20  # env steps of each Vision env
# the registered Vision envs driven: (id, task, encoder, model type, scene)
BRIDGE_ENVS = (
    ("VisionReach-v0", "RoboReach", "GlobalAEEncoder", "Autoencoder", "Table"),
    ("VisionPushSeg-v0", "RoboPush", "GlobalSegmenterEncoder", "Segmenter", "Cube"),
    ("VisionPush-v0", "RoboPush", "MultiSegmenterEncoder", "MultiSegmenter", "Cube"),
    ("VisionPushGT-v0", "RoboPush", "StatePredictor", "StatePredictor", "Cube"),
    ("VisionPegInHole-v0", "RoboPegInHole", "StatePredictor", "StatePredictor", "PegInHole"),
)


class HostTimed:
    """A callable's host ms a call (the env layer's calls return numpy, so
    each ends synchronised with the card) and its last result."""

    def __init__(self, fn):
        self.fn, self.ms, self.out = fn, [], []

    def __call__(self, *a, **k):
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.out.append(out)
        return out


def write_bridge_checkpoints(root, seed):
    """Random PointNet2 weights (randomize_) of each model the Vision envs
    read, in the port's checkpoint format under
    root/<scene>/<Model>_PointNet2/version_0/checkpoints/step_0."""
    import os

    from pointcloud_tpu_torch.train.harness import (
        checkpoint_payload,
        create_model,
        make_optimizer,
        save_checkpoint,
    )

    gen = torch.Generator().manual_seed(seed + 30)
    for model_type, scene in sorted({(m, s) for _, _, _, m, s in BRIDGE_ENVS}):
        spec = create_model(model_type, "PointNet2", scene, device="cpu", seed=seed)
        randomize_(spec.model, gen)
        save_checkpoint(os.path.join(root, scene, f"{model_type}_PointNet2", "version_0",
                                     "checkpoints"), 0,
                        checkpoint_payload(spec, make_optimizer(spec), 0))


def plain_sensed(raw, bbox, K):
    """The plain chain on the card: FilterBBox, then fps_reference (the
    plain FPS, launched here op by op on the card) over the raw clouds
    `raw` (R, N, C) at once, and the gather: (R, K, C)."""
    from pointcloud_tpu_torch.ops import fps_reference
    from pointcloud_tpu_torch.ops.geometry import index_points
    from pointcloud_tpu_torch.transforms import FilterBBox

    _, mask = FilterBBox(bbox)(raw)
    idx = fps_reference(raw[..., :3].contiguous(), K, mask)
    return index_points(raw, idx)


def encoder_shim(env, device):
    """What an encoder reads of its env, on another device."""
    import types

    return types.SimpleNamespace(
        scene=env.scene, classes=env.classes, class_latent_dim=env.class_latent_dim,
        states=env.states, state_dim=env.state_dim, bbox=env.bbox, device=device,
        visual_goal=env.visual_goal)


def card_vs_cpu_encodings(env, sensed, label):
    """The env's encoder class rebuilt at fp32 on the card and on the CPU:
    __call__ on each sensed observation, every output within 1e-4 of its
    largest entry. Returns the largest relative error."""
    from pointcloud_tpu_torch import cfg

    cls, keys = type(env.encoder), (env.encoder.obs_keys, env.encoder.goal_keys)
    before = cfg.precision
    cfg.precision = "fp32"
    try:
        card = cls(encoder_shim(env, torch.device("cuda")), *keys)
        cpu = cls(encoder_shim(env, torch.device("cpu")), *keys)
        worst = 0.0
        for obs in sensed:
            for got, want in zip(card(obs), cpu(obs)):
                err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
                if got.shape != want.shape or not err <= 1e-4:
                    raise AssertionError(f"{label}: fp32 encoding card vs CPU {err:.3e} "
                                         f"of the largest entry")
                worst = max(worst, err)
    finally:
        cfg.precision = before
    return worst


def bridge_env(env_id, task, encoder, seed, smi):
    """One Vision env through its classes on the card: reset and
    BRIDGE_STEPS steps with exact fps / ball_group launches each, every
    sensed cloud against the plain chain on the card, the step split into
    sensor, encode and the rest, and the encoder at fp32 card vs CPU.
    Returns (env, {part: sorted step ms})."""
    from pointcloud_tpu_torch.envs import envs as tenvs
    from pointcloud_tpu_torch.vision import pc_encoder as tenc
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

    extra = {"simulate_goal": True} if env_id == "VisionReach-v0" else {}
    t0 = time.perf_counter()
    env = getattr(tenvs, task)(sensor=PointCloudSensor, encoder=getattr(tenc, encoder),
                               device="cuda", **extra)
    build_s = time.perf_counter() - t0
    env.backend.capture_pointcloud = capture = HostTimed(env.backend.capture_pointcloud)
    env.sensor.observe = sensor = HostTimed(env.sensor.observe)
    env._encode_current = current = HostTimed(env._encode_current)
    passthrough = getattr(env.encoder, "passthrough_goal", False)
    zero_counts()
    env.reset(seed=seed)
    counts = read_counts()
    expect_counts(f"{env_id} reset", counts, fps=4 if passthrough else 6,
                  ball_group=2 if passthrough else 4)
    rng = np.random.default_rng(seed)
    step_ms = []
    for t in range(BRIDGE_STEPS):
        action = rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
        zero_counts()
        t1 = time.perf_counter()
        obs, reward, _, _, _ = env.step(action)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        expect_counts(f"{env_id} step {t}", read_counts(), fps=3, ball_group=2)
        if reward not in (-1, 0) or not all(np.isfinite(v).all() for v in obs.values()):
            raise AssertionError(f"{env_id} step {t}: reward {reward}, obs {obs}")
    K = env.sample_points
    raw = np.stack([np.concatenate([pts, feats["rgb"]], 1) for pts, feats in capture.out])
    want = plain_sensed(torch.from_numpy(raw).cuda(), env.bbox, K).cpu().numpy()
    got = np.stack([np.concatenate([o["points"], o["rgb"]], 1) for o in sensor.out])
    if got.shape != (2 + BRIDGE_STEPS, K, 6) or not np.array_equal(got, want):
        raise AssertionError(f"{env_id}: a sensed cloud differs from the plain chain's")
    # the steps' own calls (the reset made 2 sensor calls and 1 _encode_current):
    # rendering the raw cloud, the sensor's chain, the encoder, the rest
    render = capture.ms[2:]
    chain = [s - r for s, r in zip(sensor.ms[2:], render)]
    enc = [c - s for c, s in zip(current.ms[1:], sensor.ms[2:])]
    parts = {"step": sorted(step_ms), "render": sorted(render), "sensor": sorted(chain),
             "encode": sorted(enc),
             "rest": sorted(a - c for a, c in zip(step_ms, current.ms[1:]))}
    err = card_vs_cpu_encodings(env, [o for o in sensor.out[-3:]], env_id)
    med = {k: v[len(v) // 2] for k, v in parts.items()}
    log(f"  {env_id} ({task} + {encoder} on PointNet2, {K} points, bf16): built in "
        f"{build_s:.2f} s; {BRIDGE_STEPS} steps, each launching fps 3 (sensor 1, SA1, "
        f"SA2) and ball_group 2; {len(raw)} sensed clouds bit-equal to the plain chain "
        f"on the card; fp32 encodings card vs CPU within {err:.2e} of the largest entry")
    log(f"    step median {med['step']:.3f} ms, max {parts['step'][-1]:.3f} | render "
        f"(numpy) {med['render']:.3f} / {parts['render'][-1]:.3f} | sensor chain "
        f"{med['sensor']:.3f} / {parts['sensor'][-1]:.3f} | encode {med['encode']:.3f} / "
        f"{parts['encode'][-1]:.3f} | rest of the host's work {med['rest']:.3f} / "
        f"{parts['rest'][-1]:.3f} (host clock, median / max) | {smi}")
    return env, parts


class ProportionalReach:
    """A ground-truth Reach policy: action = clip(12 (desired - achieved))."""

    def predict(self, obs, deterministic=True):
        delta = obs["desired_goal"] - obs["achieved_goal"]
        return np.concatenate([np.clip(12.0 * delta, -1, 1), [0.0]]).astype(np.float32), None


def same_frames(a, b, label):
    import os

    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        raise AssertionError(f"{label}: frames {names} against {sorted(os.listdir(b))}")
    for name in names:
        x = np.load(os.path.join(a, name), allow_pickle=True)
        y = np.load(os.path.join(b, name), allow_pickle=True)
        for k in y.files:
            if y[k].dtype == object:
                same = all(nx == ny and np.array_equal(vx, vy)
                           for (nx, vx), (ny, vy) in zip(x[k], y[k]))
            else:
                same = x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            if not same:
                raise AssertionError(f"{label}: {name} {k} differs card vs CPU")
    return len(names)


def encode_kernel_times(env, smi):
    """fps and ball_group at SA1 and SA2 of one `encode` (B=1) on the env's
    last sensed cloud, with the env's PointNet2 backbone: each equal to its
    plain version, timed (CUDA events) beside its plain version, the
    library yardstick (ball_group) and the bound. Returns {level: (fps ms,
    fps bound, ball ms, ball plain ms, ball library ms, ball bound)}."""
    from pointcloud_tpu_torch.ops import (
        ball_group,
        ball_group_reference,
        farthest_point_sample,
        fps_reference,
    )
    from pointcloud_tpu_torch.vision.pc_encoder import _normalize_pc

    model = env.encoder.model
    bb = getattr(model, "preencoder", None) or model.encoder.backbone
    xn = torch.from_numpy(_normalize_pc(env.observation, ["rgb"])[None]).cuda()
    out = {}
    for lvl, sa, (xyz, feats, cents) in zip(
            ("SA1", "SA2"), (bb.SetAbstraction_0, bb.SetAbstraction_1),
            sa_level_inputs(bb, xn)):
        if not torch.equal(farthest_point_sample(xyz, sa.npoint),
                           fps_reference(xyz, sa.npoint)):
            raise AssertionError(f"encode {lvl}: fps differs from the plain version")
        args = (xyz, feats, cents, None, sa.nsample, sa.radius)
        got, want = ball_group(*args), ball_group_reference(*args)
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            raise AssertionError(f"encode {lvl}: ball_group differs from the plain version")
        B, N, F = feats.shape
        S, k = cents.shape[1], sa.nsample
        f_ms = cuda_ms(lambda: farthest_point_sample(xyz, S), iters=20)
        f_bnd = fps_bound(B, N, S)
        b_ms = cuda_ms(lambda: ball_group(*args), iters=20)
        b_plain = cuda_ms(lambda: ball_group_reference(*args), iters=3, warmup=1)
        b_lib = cuda_ms(lambda: ball_library(xyz, feats, cents, k, sa.radius), iters=3,
                        warmup=1)
        b_bnd = ball_bound(B, N, S, k, F, feats.element_size(), got[1], got[2])
        out[lvl] = (f_ms, f_bnd, b_ms, b_plain, b_lib, b_bnd)
        log(f"  encode {lvl} (B=1, N={N}, S={S}, k={k}, F={F} bf16): fps {f_ms:.4f} ms "
            f"(bound {f_bnd[0]:.5f}, {f_bnd[1]}); ball_group {b_ms:.4f} ms, plain "
            f"{b_plain:.3f}, library cdist + topk + gather {b_lib:.3f}, bound "
            f"{b_bnd[0]:.5f} ({b_bnd[1]}); both equal to their plain versions | {smi}")
    return out


def bridge_phase(seed, smi):
    """Phase 17 (see the module docstring). Returns its numbers."""
    import os
    import shutil
    import tempfile

    from pointcloud_tpu_torch.data.generate import generate_pc
    from pointcloud_tpu_torch.envs import envs as tenvs
    from pointcloud_tpu_torch.envs.synthetic import SyntheticScene, generate_dataset
    from pointcloud_tpu_torch.ops import _build, farthest_point_sample, fps_plan, fps_reference
    from pointcloud_tpu_torch.train.calibrate import latent_distributions
    from pointcloud_tpu_torch.transforms import FilterBBox, sensor_chain
    from pointcloud_tpu_torch.vision import pc_encoder as tenc
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

    log("[bridge] the Vision GoalEnvs on the card: synthetic backend -> PointCloudSensor "
        "(FilterBBox + fps, 16,384 -> 2,048 points) -> PointNet2 encoder zoo")
    work = tempfile.mkdtemp(prefix="bridge-", dir=_build.BUILD_DIR)
    before_root = tenc.OUTPUT_ROOT
    out = {}
    try:
        tenc.OUTPUT_ROOT = os.path.join(work, "output")
        write_bridge_checkpoints(tenc.OUTPUT_ROOT, seed)
        envs = {}
        for env_id, task, encoder, _, _ in BRIDGE_ENVS:
            env, parts = bridge_env(env_id, task, encoder, seed, smi)
            out[env_id] = parts
            envs[env_id] = env
        out["encode"] = encode_kernel_times(envs["VisionPush-v0"], smi)

        # the sensor chain alone at the synthetic scene's shape
        sim = SyntheticScene("Cube", seed=seed, device="cuda")
        points, rgb, labels = sim.render_points()
        pc = torch.from_numpy(np.concatenate([points, rgb], 1)).cuda()
        bbox, K = sim.cfg["bbox"], sim.cfg["sample_points"]
        chain = sensor_chain(bbox, K, "FPS", 0, "cuda")
        zero_counts()
        chain(pc)
        torch.cuda.synchronize()
        expect_counts("sensor chain", read_counts(), fps=1)
        chain_ms = host_ms(lambda: chain(pc), 20, 3)
        xyz = pc[None, :, :3].contiguous()
        mask = FilterBBox(bbox)(pc)[1][None].contiguous()
        fps_ms = cuda_ms(lambda: farthest_point_sample(xyz, K, mask), 20)
        plain_ms = cuda_ms(lambda: fps_reference(xyz, K, mask), 1, warmup=1)
        if not torch.equal(farthest_point_sample(xyz, K, mask), fps_reference(xyz, K, mask)):
            raise AssertionError("fps at the sensor's synthetic shape differs from plain")
        plan = fps_plan(1, pc.shape[0])
        bnd = fps_bound(1, pc.shape[0], K)
        out["sensor"] = (chain_ms[len(chain_ms) // 2], fps_ms, plain_ms, bnd)
        log(f"  sensor chain on one {pc.shape[0]}-point synthetic Cube cloud "
            f"({int(mask.sum())} in the bbox) -> {K}: median {chain_ms[len(chain_ms) // 2]:.3f}"
            f" ms, max {chain_ms[-1]:.3f} (host clock, synchronised); fps alone "
            f"{fps_ms:.3f} ms ({plan.route} route, {plan.cluster} blocks of "
            f"{plan.per_block} points) against its plain version {plain_ms:.1f} ms "
            f"and a bound of {bnd[0]:.4f} ms ({bnd[1]}) | {smi}")

        # generate_dataset on the card, frames/s; its first frames against the CPU's
        gen_dir = os.path.join(work, "frames")
        zero_counts()
        t0 = time.perf_counter()
        generate_dataset(os.path.join(gen_dir, "card"), scene="Cube", frames=20, seed=seed,
                         device="cuda")
        secs = time.perf_counter() - t0
        expect_counts("generate_dataset", read_counts(), fps=20)
        generate_dataset(os.path.join(gen_dir, "cpu"), scene="Cube", frames=3, seed=seed,
                         device="cpu")
        for i in range(3, 20):
            os.remove(os.path.join(gen_dir, "card", f"{i}.npz"))
        same_frames(os.path.join(gen_dir, "card"), os.path.join(gen_dir, "cpu"),
                    "generate_dataset")
        out["generate_dataset"] = 20 / secs
        log(f"  generate_dataset(Cube, 20 frames of {K} points): {20 / secs:.1f} frames/s "
            f"on the card (one fps launch a frame); its first 3 frames equal to the "
            f"CPU's | {smi}")
        zero_counts()
        generate_pc(os.path.join(gen_dir, "pc_card"), tenvs.RoboPush, horizon=3, runs=1,
                    seed=seed, device="cuda")
        expect_counts("generate_pc", read_counts(), fps=5)
        generate_pc(os.path.join(gen_dir, "pc_cpu"), tenvs.RoboPush, horizon=3, runs=1,
                    seed=seed, device="cpu")
        n = same_frames(os.path.join(gen_dir, "pc_card"), os.path.join(gen_dir, "pc_cpu"),
                        "generate_pc")
        log(f"  generate_pc(RoboPush, 3 frames, segmentation): {n} frames equal to the "
            f"CPU's; fps 5 launches (the reset's goal and current observations, 3 steps)")

        # one short calibration of VisionReach's encoder, and its sidecar read back
        reach = envs["VisionReach-v0"]
        threshold, before, during = latent_distributions(
            "VisionReach-v0", ProportionalReach(), horizon=15, runs=2, env=reach, save=True)
        if threshold is None or threshold.shape != (3,) or not np.isfinite(threshold).all():
            raise AssertionError(f"calibration: threshold {threshold}")
        again = tenvs.RoboReach(sensor=PointCloudSensor, encoder=tenc.GlobalAEEncoder,
                                device="cuda")
        if not np.array_equal(again.encoder.latent_threshold, threshold):
            raise AssertionError("calibration: the saved threshold does not read back")
        log(f"  latent_distributions(VisionReach, proportional GT policy, 2 runs x 15 "
            f"steps): threshold {np.array2string(threshold, precision=4)} from "
            f"{len(before)} + {len(during)} episodes, saved and read back by a new env")
        for env in list(envs.values()) + [again]:
            env.close()
    finally:
        tenc.OUTPUT_ROOT = before_root
        shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and clouds")
    ap.add_argument("--loss-spread", type=int, default=0, metavar="STEPS",
                    help="only build, then print phase 4's chained train "
                         "losses over STEPS steps for each of --seeds and "
                         "--orders (see loss_spread); prints no result lines")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--orders", type=int, nargs="+", default=[0])
    ap.add_argument("--kernel-times", action="store_true",
                    help="only build, then time fps at every driven shape, "
                         "nn_sweep at the eval shape (B=512 x 2048 x 6), "
                         "ball_group at SA1 / SA2, scatter_rows at every driven "
                         "shape and the route, knn_group and group_gather at "
                         "every driven launch, chamfer_bwd and bn_pool at every "
                         "driven shape (kernel_times); "
                         "prints no result lines")
    ap.add_argument("--train-loop", action="store_true",
                    help="only build, then run phase 15 (train() over npz "
                         "frames); prints no result lines")
    ap.add_argument("--heads", action="store_true",
                    help="only build, then run phase 16 (the MultiSegmenter and "
                         "the StatePredictor); prints no result lines")
    ap.add_argument("--bridge", action="store_true",
                    help="only build, then run phase 17 (the Vision GoalEnvs: "
                         "sensor, encoder zoo, generate, calibrate); prints no "
                         "result lines")
    ap.add_argument("--step-times", action="store_true",
                    help="only build, then time the steps the redesigned "
                         "kernels serve (step_times); with --kernel-times, "
                         "both; prints no result lines")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    if args.loss_spread:
        from pointcloud_tpu_torch.ops import _build
        log(f"[build] {_build.build():.1f} s")
        loss_spread(args.seeds, args.loss_spread, args.orders)
        return 0
    if args.train_loop:
        from pointcloud_tpu_torch.ops import _build
        log(f"[build] {_build.build():.1f} s")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        train_loop_path(args.seed, smi)
        return 0
    if args.heads:
        from pointcloud_tpu_torch.envs.scenes import scene_config
        from pointcloud_tpu_torch.ops import _build
        log(f"[build] {_build.build():.1f} s")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        sc = scene_config("Cube")
        x2 = raw_batch(torch.Generator(device="cuda").manual_seed(args.seed), sc, 2,
                       sc.sample_points, torch.device("cuda"))
        heads_phase(args.seed, smi, {"nn_sweep": 0.0, "chamfer_bwd": 0.0}, x2)
        return 0
    if args.bridge:
        from pointcloud_tpu_torch.ops import _build
        log(f"[build] {_build.build():.1f} s")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        bridge_phase(args.seed, smi)
        return 0
    if args.kernel_times or args.step_times:
        from pointcloud_tpu_torch.ops import _build
        log(f"[build] {_build.build():.1f} s")
        if args.kernel_times:
            kernel_times(args.seed)
        if args.step_times:
            step_times(args.seed)
        return 0

    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.ops import (
        _build,
        chamfer_distance,
        dense_pool_stats,
        dense_pool_stats_bwd,
        dense_pool_stats_reference,
        nn_sweep,
        nn_sweep_reference,
        pool_bwd_plan,
        pool_fwd_plan,
    )
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
    for source, names in (("mlp_chain", FWD_KERNELS + BWD_KERNELS),
                          ("fps", FPS_KERNELS), ("nn_sweep", NN_KERNELS),
                          ("dense_bn_pool", POOL_KERNELS),
                          ("sinkhorn", SINKHORN_KERNELS)):
        for kernel, regs, st, ld in _build.ptxas_report(source):
            name = next((k for k in names if k in kernel), None)
            if name:
                log(f"  ptxas {name} {kernel[kernel.index(name) + len(name):][:40]}: "
                    f"{regs} registers, spills {st} B stored / {ld} B loaded")

    log(f"  ptxas nn_sweep: {len(wgmma_warnings('nn_sweep'))} wgmma serialization "
        f"warnings")
    for threads, slots in ((256, 8), (128, 4), (64, 4)):
        st = fps_step_sass(threads, slots)
        log(f"  SASS of fps_block_kernel<{threads}, {slots}> (cuobjdump -sass): a step "
            f"issues {st['all']} instructions ({st['fp32']} fp32 compute or compare), "
            f"{st['REDUX']} redux.sync, {st['BAR']} barrier, {st['LDS']} shared loads, "
            f"{st['STS']} shared stores")
    n_ins, n_ex2 = sweep_sass_loop()
    log(f"  SASS of sinkhorn's sweep_kernel (cuobjdump -sass): its innermost loop "
        f"issues {n_ins} instructions for {n_ex2} ex2 on its common path, "
        f"{n_ins / n_ex2:.2f} a pair")
    ptxas_notes(("knn_group", "group_gather"))

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
    err["fps"] = max(check_fps(gen, 8, 2048, 512),
                     check_fps(gen, 8, 512, 128, masked=False),
                     check_fps(gen, 3, 700, 64, C=6),
                     check_fps(gen, 3, 100, 150),  # under-full: K > N
                     check_fps(gen, 2, 5000, 256),  # 512 threads x 12 slots
                     check_fps(gen, 2, 20000, 256))  # a cluster of 2
    # the cluster route, with a generator of its own (`gen` goes on to draw
    # the paths' clouds): the sensor's shape (a cluster of 16, half the
    # points valid, the copies 8 blocks apart), copies 2 blocks apart, 13
    # blocks of a ragged N; and the scratch route
    gen_fps = torch.Generator(device=dev).manual_seed(args.seed + 3)
    err["fps"] = max(err["fps"],
                     check_fps(gen_fps, 1, 196608, 2048, keep=0.5, mask_last=False),
                     check_fps(gen_fps, 2, 40000, 1024),
                     check_fps(gen_fps, 2, 150001, 256),
                     check_fps(gen_fps, 1, 200000, 64, mask_last=False))
    err["ball_group"] = max(
        check_ball_group(gen, 4, 2048, 512, 32, 3, torch.bfloat16, True, 0.2),
        check_ball_group(gen, 4, 512, 128, 64, 128, torch.bfloat16, False, 0.4),
        check_ball_group(gen, 4, 512, 128, 64, 128, torch.float32, True, 0.4),
        check_ball_group(gen, 3, 300, 40, 5, 7, torch.float32, True, 0.3),
        check_ball_group(gen, 2, 5000, 64, 24, 4, torch.bfloat16, True, 0.1),
        check_ball_group(gen, 2, 256, 16, 8, 0, torch.float32, False, 0.5))
    # SA2's odd width with a third of the rows on one target (long buckets
    # summed in pieces) and ball_group's global route, with a generator of
    # their own: `gen` goes on to draw the paths' clouds, and phase 5's
    # gradients follow nn_sweep's indices, which may pick another nearest
    # neighbour than the CPU at a near tie in other clouds
    gen_grp = torch.Generator(device=dev).manual_seed(args.seed + 8)
    err["scatter_rows"] = max(err["scatter_rows"],
                              check_scatter_rows(gen_grp, 4, 8192, 512, 131))
    err["ball_group"] = max(err["ball_group"], check_ball_group(
        gen_grp, 2, 15000, 64, 24, 4, torch.bfloat16, True, 0.05))
    # the groupings past their shared slots, Chamfer's backward on a
    # collapsed cloud and at the route check's shape, bn_pool at every
    # driven shape: generators of their own
    large_k_checks(torch.Generator(device=dev).manual_seed(args.seed + 11), err)
    gen_cb = torch.Generator(device=dev).manual_seed(args.seed + 12)
    err["chamfer_bwd"] = max(err["chamfer_bwd"],
                             check_chamfer_bwd_order(gen_cb, 4, 2048, 6, True),
                             check_chamfer_bwd_order(gen_cb, B_ROUTE, P_ROUTE, 6, False),
                             check_chamfer_bwd_order(gen_cb, B_ROUTE, P_ROUTE, 6, True))
    check_bn_pool_shapes(torch.Generator(device=dev).manual_seed(args.seed + 13), err)
    # knn_group's and group_gather's route boundaries, with a generator of
    # their own as well
    grouping_route_checks(torch.Generator(device=dev).manual_seed(args.seed + 10), err)
    err.update(mm_stats=0.0, bnact_mm_stats=0.0, bn_pool=0.0, chain_bwd_pass=0.0)
    bf, f32 = torch.bfloat16, torch.float32
    # a generator of their own: `gen` goes on to draw the paths' clouds
    gen_chain = torch.Generator(device=dev).manual_seed(args.seed + 1)
    check_chain(gen_chain, 2, 48, [(9, 16), (16, 16), (16, 24)], 4, f32, True, True, err)
    check_chain(gen_chain, 2, 48, [(9, 16), (16, 16), (16, 24)], 4, bf, True, False, err)
    check_chain(gen_chain, 4, 2048, [(6, 64), (64, 64), (64, 128)], 32, bf, True, True, err)
    check_chain(gen_chain, 3, 1280, [(131, 128), (128, 200), (200, 72)], 128, bf, True, True, err)
    check_chain(gen_chain, 3, 1280, [(131, 128), (128, 200), (200, 72)], 128, f32, False, False, err)
    check_chain(gen_chain, 4, 128, [(259, 256), (256, 512), (512, 1024)], 128, bf, False, True, err)
    check_chain(gen_chain, 2, 96, [(259, 40)], 32, f32, True, True, err)
    # (a ragged hidden width: 130 channels below a BatchNorm, w padded at 24 -> 130)
    check_chain(gen_chain, 2, 96, [(6, 24), (24, 130), (130, 40)], 4, bf, True, True, err)
    err["scatter_rows"] = max(
        err["scatter_rows"],
        check_ball_group_grad(gen_chain, 3, 512, 64, 16, 5, f32, 0.3),
        check_ball_group_grad(gen_chain, 3, 512, 64, 16, 128, bf, 0.3))

    # Sinkhorn matching, with a generator of its own. After a single
    # iteration ties are structural (every target whose nearest point is i
    # scores eps log(1/M) on row i up to round-off), so that case asks for 90%.
    err["sinkhorn"] = 0.0
    gen_emd = torch.Generator(device=dev).manual_seed(args.seed + 2)
    check_sinkhorn(gen_emd, 4, 128, 128, 3, 0.005, 50, None, err)
    check_sinkhorn(gen_emd, 4, 128, 128, 3, 0.01, 30, None, err)
    check_sinkhorn(gen_emd, 4, 64, 128, 3, 0.01, 30, None, err)
    check_sinkhorn(gen_emd, 3, 100, 77, 3, 0.002, 60, 0.1, err)
    check_sinkhorn(gen_emd, 3, 128, 128, 6, 0.002, 60, 0.1, err)
    check_sinkhorn(gen_emd, 2, 64, 64, 3, 0.002, 100, None, err, identical=True)
    check_sinkhorn(gen_emd, 2, 100, 100, 6, 0.002, 60, 0.1, err, identical=True)
    check_sinkhorn(gen_emd, 4, 128, 128, 3, 0.005, 1, None, err, share=0.9)
    check_sinkhorn(gen_emd, 2, 1500, 2500, 4, 0.005, 50, None, err)

    # nn_sweep's other depths and a ragged pair, with a generator of their
    # own: C = 1 (K = 16) and C = 7 (K = 48, no spare column), two target
    # chunks at C = 7, a query tile of one row and one 31-column product
    gen_nn = torch.Generator(device=dev).manual_seed(args.seed + 6)
    err["nn_sweep"] = max(err["nn_sweep"],
                          check_nn_sweep(gen_nn, 4, 2048, 2048, 1),
                          check_nn_sweep(gen_nn, 3, 1000, 2500, 7),
                          check_nn_sweep(gen_nn, 3, 2049, 31, 6),
                          check_nn_sweep(gen_nn, 4, 2048, 2048, 6, far_masked=True))

    # ---- 3. eval path at full width ----
    log("[eval path] Autoencoder / PointNet / Chamfer, scene Cube")
    spec = create_model("Autoencoder", "PointNet", "Cube",
                        loss_override="chamfer", device=dev, seed=args.seed)
    step = make_eval_step(spec)
    sc = spec.scene
    P = sc.sample_points
    x_raw = raw_batch(gen, sc, B_MAIN, P, dev)
    ev = drive_eval(step, x_raw, ITERS)
    loss, out, x, eval_counts = ev["loss"], ev["out"], ev["x"], ev["counts"]
    first_s, ms_iter, per_iter, peak_gib = (ev["first_s"], ev["ms"], ev["per_iter"],
                                            ev["peak"])
    expect_counts("eval path", eval_counts, nn_sweep=ITERS + 1)
    with torch.inference_mode():
        enc = spec.model.encode(spec.in_transform(x_raw[:1])[0])
    torch.cuda.synchronize()
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
    nn_bound = nn_sweep_bound(B_MAIN, P, P, a.shape[-1])
    log(f"  nn_sweep kernel {nn_ms:.3f} ms | plain version {nn_plain:.3f} ms | "
        f"library cdist().square() + min both ways {nn_lib:.3f} ms | bound "
        f"{nn_bound[0]:.3f} ms ({nn_bound[1]}; direct differences on the CUDA "
        f"cores: {nn_direct_bound(B_MAIN, P, P, a.shape[-1]):.3f} ms)")
    nn_expansion_error(a, b, f"the eval step's output and target, B={B_MAIN}")
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
    del spec, step, out, y, a, b, x, h, xn, ev
    torch.cuda.empty_cache()

    # ---- 4. train path at full width ----
    log(f"[train path] make_train_step, B={B_TRAIN} x {P} x 6, bf16, Adam "
        f"lr {cfg.vision_lr}")
    spec = create_model("Autoencoder", "PointNet", "Cube",
                        loss_override="chamfer", device=dev, seed=args.seed)
    opt = make_optimizer(spec)
    tstep = make_train_step(spec, opt)
    xt = x_raw[:B_TRAIN].contiguous()
    tr = drive_train(tstep, xt, xt, TRAIN_ITERS)
    train_counts, losses, first_loss = tr["counts"], tr["losses"], tr["first_loss"]
    train_first_s, ms_train, per_iter, train_peak = (tr["first_s"], tr["ms"],
                                                     tr["per_iter"], tr["peak"])
    expect_counts("train path", train_counts, nn_sweep=TRAIN_ITERS,
                  chamfer_bwd=TRAIN_ITERS, dense_pool_stats=3 * TRAIN_ITERS,
                  dense_pool_stats_bwd=3 * TRAIN_ITERS)
    log(f"  train step B={B_TRAIN}: warm-up step {train_first_s:.3f} s; "
        f"{TRAIN_ITERS} chained steps {ms_train:.3f} ms/step on the host clock "
        f"-> {B_TRAIN / (ms_train / 1e3):.1f} clouds/s; event-to-event median "
        f"{per_iter[TRAIN_ITERS // 2]:.3f} ms (min {per_iter[0]:.3f}, max "
        f"{per_iter[-1]:.3f}); peak memory {train_peak:.2f} GiB | {smi}")
    log(f"  losses: warm-up {float(first_loss):.6f}, then "
        f"{', '.join(f'{v:.6f}' for v in losses)}; launches {train_counts}")
    log(f"  the host alone enqueues a step in {tr['enqueue_ms']:.3f} ms")
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite train loss {losses}")
    # falling: the last of PN_TRAIN_ITERS chained steps below the warm-up
    # loss, on a second instance from the same seed and batch, so that the
    # trace, the parts and the yardsticks below see the weights of the
    # TRAIN_ITERS steps above
    gate = create_model("Autoencoder", "PointNet", "Cube", loss_override="chamfer",
                        device=dev, seed=args.seed)
    gt = drive_train(make_train_step(gate, make_optimizer(gate)), xt, xt,
                     PN_TRAIN_ITERS)
    fall = gt["losses"]
    log(f"  the loss gate: a second instance from the same seed, warm-up "
        f"{gt['first_loss']:.6f}, {PN_TRAIN_ITERS} chained steps: step "
        f"{TRAIN_ITERS} {fall[TRAIN_ITERS - 1]:.6f}, step {PN_TRAIN_ITERS} "
        f"{fall[-1]:.6f}")
    if not all(torch.isfinite(torch.tensor(fall))):
        raise AssertionError(f"non-finite train loss {fall}")
    if not fall[-1] < gt["first_loss"]:
        raise AssertionError("the train loss did not fall over the steps")
    del gate
    torch.cuda.empty_cache()
    trace_steps(tstep, xt, xt, ms_train, f"PointNet train step, B={B_TRAIN}",
                tr["enqueue_ms"])

    fwd_ms, bwd_ms, opt_ms = step_parts(spec, opt, xt, xt)
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
                                               None, Rt, acc_bound=True)
    err["dense_pool_stats"] = max(err["dense_pool_stats"], e_fwd)
    err["dense_pool_stats_bwd"] = max(err["dense_pool_stats_bwd"], e_bwd)
    torch.cuda.empty_cache()
    d_ms = cuda_ms(lambda: dense_pool_stats(dx_in, dw_in, db_in, ds_in, None, Rt),
                   iters=10)
    d_plain = cuda_ms(lambda: dense_pool_stats_reference(
        dx_in, dw_in, db_in, ds_in, None, Rt), iters=3, warmup=1)

    d_lib = cuda_ms(pool_library_fwd(dx_in, dw_in, db_in, Rt), iters=3, warmup=1)
    d_bound = pool_fwd_bound(dx_in, Cd, Rt, None)
    g_ps = torch.randn(fwd_out[0].shape, generator=gen, device=dev)
    g_s = torch.randn((Cd,), generator=gen, device=dev) / (Bt * Rt)
    b_ms = cuda_ms(lambda: dense_pool_stats_bwd(
        dx_in, dw_in, db_in, ds_in, fwd_out[1], g_ps, g_s, g_s, Rt), iters=5)
    bx_ms, bw_ms = time_pool_bwd_parts(dx_in, dw_in, db_in, ds_in, fwd_out[1], g_ps,
                                       g_s, Rt)
    xl = dx_in.detach().clone().requires_grad_()
    wl = dw_in.detach().clone().requires_grad_()
    bl = db_in.detach().clone().requires_grad_()

    def dense_plain_bwd():
        o = dense_pool_stats_reference(xl, wl, bl, ds_in, None, Rt)
        return torch.autograd.grad((o[0], o[2], o[3]), (xl, wl, bl),
                                   (g_ps.to(o[0].dtype), g_s, g_s))

    b_plain = cuda_ms(dense_plain_bwd, iters=2, warmup=1)
    b_lib = cuda_ms(pool_library_bwd(dx_in, dw_in, db_in, Rt, g_ps, g_s), iters=2,
                    warmup=1)
    b_bound = pool_bwd_bound(Bt, Rt, Cin, Cd, Rt)
    b_plan = pool_bwd_plan(Bt * Rt, Cin, Cd, True, Rt)
    f_plan = pool_fwd_plan(Bt * Rt, Cin, Cd, True, Rt)
    log(f"  dense_pool_stats fwd B={Bt} R={Rt} Cin={Cin} C={Cd} bf16 ({f_plan.route} "
        f"route; {f_plan.chunks} chunks of {f_plan.chunk_rows} rows x "
        f"{f_plan.col_blocks} channel blocks, {f_plan.smem} B shared memory): kernel "
        f"{d_ms:.3f} ms | plain {d_plain:.3f} ms | library matmul + aminmax + "
        f"sums {d_lib:.3f} ms | bound {d_bound[0]:.3f} ms ({d_bound[1]})")
    log(f"  dense_pool_stats bwd ({b_plan.route} route; dx {b_plan.dx_chunks} blocks "
        f"of {b_plan.dx_chunk_rows} rows, dw {b_plan.dw_chunks} chunks x "
        f"{-(-Cd // 128)} channel tiles): kernel {b_ms:.3f} ms (dx {bx_ms:.3f} + dw "
        f"and db {bw_ms:.3f}, device time traced) | plain (autograd) {b_plain:.3f} ms | "
        f"library (autograd through matmul + amax + sums) {b_lib:.3f} ms | bound "
        f"{b_bound[0]:.3f} ms ({b_bound[1]})")
    del xl, wl, bl, feats
    torch.cuda.empty_cache()

    # chamfer_bwd at the train step's shapes
    cargs = nn_inputs(gen, B_TRAIN, P, P, 6, masked=False)
    err["chamfer_bwd"] = max(err["chamfer_bwd"],
                             compare_chamfer_bwd(cargs, "train shape"))
    c_ms, c_plain, c_lib, c_bound = time_chamfer_bwd(cargs, "the train step's shape")
    del cargs, spec, opt, tstep
    torch.cuda.empty_cache()

    # ---- 5. the Chamfer backward past the JAX package's switch ----
    log(f"[Chamfer route] chamfer_distance(x, y).backward() at B={B_ROUTE}, "
        f"N=M={P_ROUTE}, C=6")
    rx = torch.rand((B_ROUTE, P_ROUTE, 6), generator=gen, device=dev)
    ry = torch.rand((B_ROUTE, P_ROUTE, 6), generator=gen, device=dev)
    xg = rx.clone().requires_grad_()
    yg = ry.clone().requires_grad_()
    zero_counts()
    chamfer_distance(xg, yg).backward()
    torch.cuda.synchronize()
    route_counts = read_counts()
    expect_counts("Chamfer route", route_counts, nn_sweep=1, chamfer_bwd=1)
    xc = rx.cpu().requires_grad_()
    yc = ry.cpu().requires_grad_()
    chamfer_distance(xc, yc).backward()
    e_route = max(rel_err(xg.grad.cpu(), xc.grad), rel_err(yg.grad.cpu(), yc.grad))
    # a gradient follows each point's nearest neighbour: the card's indices
    # against the CPU's direct differences
    card_nn = nn_sweep(rx, ry)
    cpu_nn = nn_sweep_reference(rx.cpu(), ry.cpu())
    nn_off = sum(int((card_nn[j].cpu() != cpu_nn[j]).sum()) for j in (1, 3))
    log(f"  launches {route_counts}; gradients vs the CPU's plain route: rel "
        f"err {e_route:.2e}; nearest-neighbour indices card vs CPU differing: "
        f"{nn_off}")
    if e_route > 1e-4:
        raise AssertionError("Chamfer route gradients differ from the CPU")
    sargs = nn_inputs(gen, B_ROUTE, P_ROUTE, P_ROUTE, 6, masked=False)
    err["chamfer_bwd"] = max(err["chamfer_bwd"], compare_chamfer_bwd(sargs, "route"))
    time_chamfer_bwd(sargs, "the route")
    del sargs

    # ---- 6. the PointNet2 eval path and the sensor chain ----
    pn2 = pointnet2_path(args.seed, gen, x_raw, smi, err)

    # ---- 7. fp32 models on the card vs the CPU ----
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
    card_vs_cpu_pointnet2(args.seed, x_raw)
    card_vs_cpu_pointnet2_train(args.seed, x_raw)

    # ---- 8. the PointNet2 train path ----
    pn2t = pointnet2_train_path(args.seed, gen_chain, x_raw, smi, err)

    # ---- 9. the Earth Mover's Distance paths ----
    emd = emd_paths(args.seed, gen_emd, x_raw, smi, err)
    log("[card vs CPU, EMD]")
    card_vs_cpu_train(args.seed, x_raw, loss_override=None, first_tol=1e-4,
                      steps_tol=1e-2)

    # ---- 10. the PointMLP eval paths ----
    log("[PointMLP: knn_group vs its plain version]")
    gen_mlp = torch.Generator(device=dev).manual_seed(args.seed + 3)
    pointmlp_kernel_checks(gen_mlp, err)
    mlp = pointmlp_paths(args.seed, gen_mlp, x_raw, smi)
    log("[card vs CPU, PointMLP]")
    card_vs_cpu_pointmlp(args.seed, x_raw, mlp.pop("spec"))

    # ---- 11. the PointMLP train paths ----
    log("[PointMLP train: the residual chain vs its plain versions]")
    gen_mlpt = torch.Generator(device=dev).manual_seed(args.seed + 4)
    pointmlp_train_kernel_checks(gen_mlpt, err)
    mlpt = pointmlp_train_paths(args.seed, gen_mlpt, x_raw, smi, err)
    log("[card vs CPU, PointMLP train]")
    card_vs_cpu_pointmlp_train(args.seed, x_raw)

    # ---- 12.-14. the multi-scale-grouping PointNet2 ----
    log("[MSG: group_gather vs its plain version]")
    gen_msg = torch.Generator(device=dev).manual_seed(args.seed + 5)
    msg_kernel_checks(gen_msg, err)
    msg = msg_eval_path(args.seed, x_raw, smi, err)
    msg_train_path(args.seed, gen_msg, x_raw, smi, err)
    log("[card vs CPU, MSG]")
    card_vs_cpu_msg(args.seed, x_raw)

    # ---- 15. the training loop ----
    train_loop_path(args.seed, smi)

    # ---- 16. the MultiSegmenter and the StatePredictor ----
    heads_phase(args.seed, smi, err, x_raw[:2])

    # ---- 17. the sensor -> encoder -> GoalEnv bridge ----
    bridge_phase(args.seed, smi)

    def chain_entry(name, line, layer):
        """The kernel's launch at SA1 (the most rows) on the given layer."""
        _, _, ms, plain, lib, bnd = next(
            r for r in pn2t["rows"]["SA1"] if r[0] == name and r[1] == layer)
        return entry(name, "mlp_chain.cu",
                     f"pointcloud_tpu/ops/preextract_fused.py:{line}",
                     pn2t["counts"][name], ms, plain, bnd, lib)

    def residual_entry(name, line, layer):
        """The residual pass at PointMLP's stage 1 (the most rows) on the
        given layer; launches of the PointMLP train path's counted steps."""
        _, _, ms, plain, lib, bnd = next(
            r for r in mlpt["PointMLP"]["rows"]["S1"] if r[0] == name and r[1] == layer)
        return entry(name + RES, "mlp_chain.cu",
                     f"pointcloud_tpu/ops/preextract_fused.py:{line}",
                     mlpt["PointMLP"]["counts"][name], ms, plain, bnd, lib)

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
        # SA2's grouping gradient of the PointNet2 train step
        entry("scatter_rows", "scatter_rows.cu",
              "pointcloud_tpu/ops/pallas_kernels.py:767",
              pn2t["counts"]["scatter_rows"], *pn2t["scatters"][0][1:3],
              pn2t["scatters"][0][4], pn2t["scatters"][0][3]),
        entry("dense_pool_stats", "dense_bn_pool.cu",
              "pointcloud_tpu/ops/dense_bn_pool.py:87",
              train_counts["dense_pool_stats"], d_ms, d_plain, d_bound, d_lib),
        entry("dense_pool_stats_bwd", "dense_bn_pool.cu",
              "pointcloud_tpu/ops/dense_bn_pool.py:162",
              train_counts["dense_pool_stats_bwd"], b_ms, b_plain, b_bound, b_lib),
        entry("fps", "fps.cu", "pointcloud_tpu/ops/pallas_kernels.py:1600",
              pn2["counts"]["fps"], *pn2["fps"], None),
        entry("ball_group", "ball_group.cu",
              "pointcloud_tpu/ops/pallas_kernels.py:969",
              pn2["counts"]["ball_group"], pn2["ball_group"][0],
              pn2["ball_group"][1], pn2["ball_group"][3], pn2["ball_group"][2]),
        chain_entry("mm_stats", 122, 0),
        chain_entry("bnact_mm_stats", 161, 2),
        chain_entry("bn_pool", 221, 2),
        chain_entry("chain_bwd_pass", 292, 2),
        entry("sinkhorn", "sinkhorn.cu", "pointcloud_tpu/ops/pallas_kernels.py:31",
              emd["counts"]["sinkhorn"], emd["sinkhorn"][0], emd["sinkhorn"][1],
              emd["sinkhorn"][2], emd["sinkhorn"][3]),
        entry("knn_group", "knn_group.cu", "pointcloud_tpu/ops/pallas_kernels.py:1220",
              mlp["PointMLP"]["knn_group"], mlp[("PointMLP", 1)][0],
              mlp[("PointMLP", 1)][1], mlp[("PointMLP", 1)][3],
              mlp[("PointMLP", 1)][2]),
        # the residual chain: layer 3 adds relu(BN0(h0)) and stores r_1, the
        # pool adds r_1, layer 3's backward pass takes the pooled skip share
        residual_entry("bnact_mm_stats", 161, 3),
        residual_entry("bn_pool", 221, 4),
        residual_entry("chain_bwd_pass", 292, 3),
        # level 2's widest branch (k = 128, 320 bf16 feature channels)
        entry("group_gather", "group_gather.cu",
              "pointcloud_tpu/ops/pallas_kernels.py:547", msg["counts"]["group_gather"],
              msg["rows"][(2, 0.8)][0], msg["rows"][(2, 0.8)][1],
              msg["rows"][(2, 0.8)][3], msg["rows"][(2, 0.8)][2]),
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
