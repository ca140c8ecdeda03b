"""Closed-loop training: the program's `make_train_step` on `create_model`'s
spec with `make_optimizer`, steps dispatched back to back, each on a
distinct batch cycled from a pool of synthetic Cube-scene clouds on the
device (target = input).

Set-up builds one step object, drives it through its first three steps
(batches 0-2 of the pool: every row differs) and hands that same object to
the window. The reference follows those three steps from the same weights
and batches; `correct` holds each step's loss, the first gradient as Adam
holds it (its first moment after one step over 1 - beta1) and the
parameters' change after the three steps, leaf by leaf, against it.

Traffic parameters: batch (clouds a step), pool_batches (distinct batches,
at least 8), warmup_steps (steps after the checked three, before the
window).
"""

from __future__ import annotations

import statistics

import numpy as np

# the program's entry points are looked up on their module at call time, so
# that a test can put a broken step in their place
import pointcloud_tpu_torch.train.harness as harness
import torch

from portbench import core, scene
from portbench import reference as R

CHECKED_STEPS = 3


def readings_of_program(losses, first_grads, before, after, running, initial):
    """(losses, gradient norms, change norms by leaf, first-step batch
    statistics): the statistics from the running ones after the first step,
    which hold MOMENTUM of their initial value and 1 - MOMENTUM of the
    batch's."""
    m = R.MOMENTUM
    return ([float(v) for v in losses],
            {k: float(v.norm()) for k, v in first_grads.items()},
            {k: float((after[k] - before[k]).norm()) for k in after},
            {k: (v - m * initial[k]) / (1 - m) for k, v in running.items()},
            first_grads)


def readings_of_reference(cfg, weights, batches, prec):
    losses, grads, after, stats = R.train_steps(cfg, weights, batches, prec)
    return ([float(v) for v in losses],
            {k: float(v.norm()) for k, v in grads.items()},
            {k: float((after[k] - weights[k]).norm()) for k in after},
            stats, grads)


def layer_stats_gaps(got: dict, want: dict) -> dict:
    """Each BatchNorm layer's gap between two sets of batch statistics, by
    the layer's mean: the larger of |mean - mean'| / |sqrt(var')| and
    |var - var'| / |var'| (norms over the layer's channels)."""
    gaps = {}
    for k in want:
        leaf = k.rsplit(".", 1)[1]
        if not leaf.startswith("mean"):
            continue
        v = k[: -len(leaf)] + "var" + leaf[4:]
        mean_gap = float((got[k] - want[k]).norm() / want[v].sqrt().norm())
        var_gap = float((got[v] - want[v]).norm() / want[v].norm())
        gaps[k] = max(mean_gap, var_gap)
    return gaps


def compare(got, want) -> dict:
    """Every number a train cell can compare; the cell's limits choose which
    decide `correct`: the loss gap of the worst step and of the first; the
    first-gradient and change norm gaps (core.leaf_gap) of the worst and of
    the median leaf, over the leaves whose reference gradient is not nought
    to rounding (core.nought_leaves); the first step's BatchNorm statistics
    (stats_gap)."""
    (lg, gg, dg, sg, vg), (lw, gw, dw, sw, vw) = got, want
    keep = [k for k in gw if k not in set(core.nought_leaves(gw))]
    gmed = statistics.median(gw[k] for k in keep)
    dmed = statistics.median(dw[k] for k in keep)
    diffs = [float((vg[k] - vw[k]).norm()) / max(gw[k], gmed) for k in keep]
    return {
        "grad_diff": max(diffs),
        "median_grad_diff": statistics.median(diffs),
        "loss_gap": max(core.rel_gap(a, b) for a, b in zip(lg, lw)),
        "first_loss_gap": core.rel_gap(lg[0], lw[0]),
        "grad_gap": core.leaf_gap(gg, gw, keep),
        "median_grad_gap": statistics.median(
            abs(gg[k] - gw[k]) / max(gw[k], gmed) for k in keep),
        "change_gap": core.leaf_gap(dg, dw, keep),
        "median_change_gap": statistics.median(
            abs(dg[k] - dw[k]) / max(dw[k], dmed) for k in keep),
        "stats_gap": max(layer_stats_gaps(sg, sw).values()),
        "median_stats_gap": statistics.median(layer_stats_gaps(sg, sw).values()),
    }


def make_pool(cfg, traffic, seed, device):
    """(pool_batches, batch, points, 6) raw clouds on the device. Each
    batch's clouds are ordered by their mean height: the order changes no
    result of a sound step, and a step that drops part of the batch then
    sees clouds unlike the rest."""
    rng = np.random.default_rng(seed)
    B, P = traffic["batch"], traffic["pool_batches"]
    clouds = scene.render(rng, B * P, cfg["points"]).reshape(P, B, cfg["points"], -1)
    order = np.argsort(clouds[..., 2].mean(axis=2), axis=1, kind="stable")
    clouds = np.take_along_axis(clouds, order[:, :, None, None], axis=1)
    return torch.from_numpy(np.ascontiguousarray(clouds)).to(device)


def setup(cell):
    """The program's step from the seed's weights, driven through its first
    CHECKED_STEPS steps and its warm-up. Returns the state the window and
    the check share."""
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    pool = make_pool(cfg, tr, cell.seed, dev)
    weights = R.make_weights(cfg, cell.seed, dev)
    spec = harness.create_model(cfg["model_type"], cfg["backbone"], cfg["scene"],
                                loss_override=cfg["loss_override"], device=dev)
    spec.model.load_state_dict(weights, strict=True)
    opt = harness.make_optimizer(spec)
    step = harness.make_train_step(spec, opt)
    names = {p: k for k, p in spec.model.named_parameters()}
    beta1 = opt.param_groups[0]["betas"][0]

    losses, first, running = [], None, None
    for i in range(CHECKED_STEPS):
        losses.append(step(pool[i], pool[i])[0])
        if first is None:
            first = {names[p]: s["exp_avg"] / (1 - beta1) for p, s in opt.state.items()}
            first = {k: v.clone() for k, v in first.items()}
            running = {k: b.clone() for k, b in spec.model.named_buffers()
                       if R.is_statistic(k)}
    after = {k: p.detach().clone() for k, p in spec.model.named_parameters()}
    for i in range(tr["warmup_steps"]):
        step(pool[(CHECKED_STEPS + i) % len(pool)], pool[(CHECKED_STEPS + i) % len(pool)])
    cell.sync()
    params = {k: weights[k] for k in after}
    return {"pool": pool, "weights": weights, "spec": spec, "opt": opt, "step": step,
            "program": (losses, first, params, after, running, weights),
            "next": CHECKED_STEPS + tr["warmup_steps"]}


def window(cell, state, seconds, trace):
    """Steps back to back for `seconds`, then a synchronize: clouds / s over
    all the window's steps and all its time."""
    pool, step = state["pool"], state["step"]
    i, n, B = state["next"], 0, pool.shape[1]
    with trace:
        t0 = core.now()
        while core.now() - t0 < seconds:
            x = pool[i % len(pool)]
            step(x, x)
            i, n = i + 1, n + 1
        cell.sync()
        t1 = core.now()
    return {"steps": n, "clouds": n * B, "window_s": t1 - t0,
            "metrics": {"train_clouds_per_s": n * B / (t1 - t0)}}


def release(state):
    """Free the program's state before the reference runs."""
    for key in ("spec", "opt", "step"):
        state.pop(key, None)
    state["pool"] = state["pool"][:CHECKED_STEPS].clone()


def check(cell, state, prec=R.FP32):
    """The readings of the program and of the reference (in `prec`)."""
    got = readings_of_program(*state["program"])
    want = readings_of_reference(cell.config, state["weights"],
                                 list(state["pool"][:CHECKED_STEPS]), prec)
    return got, want
