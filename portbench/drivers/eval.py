"""Closed-loop evaluation: the program's `make_eval_step` on `create_model`'s
spec, steps dispatched back to back, each on a distinct batch cycled from a
pool of synthetic Cube-scene clouds on the device (target = input).

The weights come from the seed, with every BatchNorm running statistic set
to the batch statistics of a seeded calibration batch (as a trained model
holds statistics of its data; the statistics at their initial values would
leave eval a plain stack whose output collapses). `correct` holds a sample of
the window's answers, drawn from the seed: each kept step's loss and output
clouds against the reference's eval of the same batch.

Traffic parameters: batch, pool_batches, warmup_steps, calibration_clouds,
sample_steps (answers kept), sample_stride (steps between kept answers).
"""

from __future__ import annotations

import numpy as np

import pointcloud_tpu_torch.train.harness as harness
import torch

from portbench import core, scene
from portbench import reference as R
from portbench.drivers.train import make_pool


def calibrated_weights(cfg, tr, seed, device):
    """The seed's weights with running statistics from a calibration batch
    rendered from the seed (apart from the pool's clouds)."""
    weights = R.make_weights(cfg, seed, device)
    rng = np.random.default_rng([seed, 1])
    calib = torch.from_numpy(scene.render(rng, tr["calibration_clouds"], cfg["points"]))
    return R.calibrate_statistics(cfg, weights, calib.to(device))


def setup(cell):
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    pool = make_pool(cfg, tr, cell.seed, dev)
    weights = calibrated_weights(cfg, tr, cell.seed, dev)
    spec = harness.create_model(cfg["model_type"], cfg["backbone"], cfg["scene"],
                                loss_override=cfg["loss_override"], device=dev)
    spec.model.load_state_dict(weights, strict=True)
    step = harness.make_eval_step(spec)
    for i in range(tr["warmup_steps"]):
        step(pool[i % len(pool)], pool[i % len(pool)])
    cell.sync()
    rng = np.random.default_rng([cell.seed, 2])
    return {"pool": pool, "weights": weights, "spec": spec, "step": step, "kept": {},
            "offset": int(rng.integers(tr["sample_stride"])), "next": tr["warmup_steps"]}


def window(cell, state, seconds, trace):
    """Steps back to back for `seconds`, then a synchronize; every
    sample_stride-th step's answer (loss, output) is kept for the check."""
    pool, step, tr = state["pool"], state["step"], cell.traffic
    kept, stride, off = state["kept"], tr["sample_stride"], state["offset"]
    i, n, B = state["next"], 0, pool.shape[1]
    with trace:
        t0 = core.now()
        while core.now() - t0 < seconds:
            b = i % len(pool)
            loss, _, out = step(pool[b], pool[b])
            if n % stride == off and len(kept) < tr["sample_steps"]:
                kept[n] = (b, loss, out)
            i, n = i + 1, n + 1
        cell.sync()
        t1 = core.now()
    return {"steps": n, "clouds": n * B, "window_s": t1 - t0,
            "metrics": {"eval_clouds_per_s": n * B / (t1 - t0)}}


def release(state):
    for key in ("spec", "step"):
        state.pop(key, None)
    batches = sorted({b for b, _, _ in state["kept"].values()})
    state["pool"] = {b: state["pool"][b].clone() for b in batches}


def readings_of_program(state):
    """{kept step: (batch, loss, output)} as floats and tensors."""
    return {n: (b, float(loss), out.float()) for n, (b, loss, out) in state["kept"].items()}


def readings_of_reference(cfg, weights, pool, kept_batches, prec):
    out = {}
    for b in sorted(set(kept_batches)):
        out[b] = R.eval_step(cfg, weights, pool[b], prec)
    return out


def check(cell, state, prec=R.FP32):
    got = readings_of_program(state)
    want = readings_of_reference(cell.config, state["weights"], state["pool"],
                                 [b for b, _, _ in got.values()], prec)
    return got, want


def compare(got, want) -> dict:
    """The worst kept step's loss gap, and the worst cloud's output gap: the
    root mean square of the difference of its points (coordinates in the
    unit cube), over the kept steps. No kept answer is a failure."""
    if not got:
        return {"answers_missing": 1.0}
    loss_gap, out_gap = 0.0, 0.0
    for b, loss, out in got.values():
        ref_loss, ref_out = want[b]
        loss_gap = max(loss_gap, core.rel_gap(loss, ref_loss))
        rms = (out - ref_out).square().mean(dim=(1, 2)).sqrt().max()
        out_gap = max(out_gap, float(rms))
    return {"loss_gap": loss_gap, "output_gap": out_gap}
