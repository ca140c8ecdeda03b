"""The readings that the limits of `correct` are set from, for one cell, in
one process: for each seed, the program's run (set-up, a short window, the
check against the reference) and, on the same inputs and weights, the
control (the reference in the precision below the configuration's, float8
products for bf16, put in the program's place) and the half-batch fault (the
reference put in the program's place with half of each batch left out, the
mean taken over the rest). The benchmark's own runs do not run this.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 --seconds 2

One JSON line a seed on standard output. Eval and observe cells keep their
answers from the first steps of the window (sample stride 1) so that a
short window compares as many as a run does.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import core  # noqa: E402

core.cache_env()


def control_and_fault(cell, driver, state, want, details=False):
    """{'control': numbers, 'half': numbers} against the reference's own
    readings `want`."""
    from portbench import reference as R

    low = R.Precision(True)
    cfg, kind = cell.config, cell.workload["driver"]
    if kind == "train":
        batches = list(state["pool"][:driver.CHECKED_STEPS])
        ctrl = driver.readings_of_reference(cfg, state["weights"], batches, low)
        B = batches[0].shape[0]
        half = driver.readings_of_reference(cfg, state["weights"],
                                            [b[:B // 2] for b in batches], R.FP32)
        out = {"control": driver.compare(ctrl, want), "half": driver.compare(half, want)}
        if details:
            out["control_details"] = train_details(driver, ctrl, want)
            out["half_details"] = train_details(driver, half, want)
        return out
    if kind == "eval":
        ctrl, half = {}, {}
        for b, x in state["pool"].items():
            loss, out = R.eval_step(cfg, state["weights"], x, low)
            ctrl[b] = (b, loss, out)
            B = x.shape[0]
            loss, out = R.eval_step(cfg, state["weights"], x[:B // 2], R.FP32)
            half[b] = (b, loss, out.repeat(2, 1, 1))
        return {"control": driver.compare(ctrl, want), "half": driver.compare(half, want)}
    clouds = sorted(want)
    ctrl = driver.readings_of_reference(cfg, state["weights"], state["pool"], clouds,
                                        cell.device, low)
    got = {c: (c, want[c][0], ctrl[c][1]) for c in clouds}
    return {"control": driver.compare(got, want)}


def train_details(driver, got, want) -> dict:
    """Where a train cell's gaps come from: each step's loss gap, and for the
    first gradient and the change the median leaf's gap and the three worst
    leaves (gap, the reference's norm of the leaf)."""
    (lg, gg, dg, sg, _), (lw, gw, dw, sw, _) = got, want
    keep = [k for k in gw if k not in set(core.nought_leaves(gw))]
    out = {"loss_gaps": [core.rel_gap(a, b) for a, b in zip(lg, lw)], "kept": len(keep),
           "leaves": len(gw)}
    for label, g, w in (("grad", gg, gw), ("change", dg, dw)):
        med = statistics.median(w[k] for k in keep)
        gaps = sorted(((abs(g[k] - w[k]) / max(w[k], med), k, w[k], g[k]) for k in keep),
                      reverse=True)
        out[label] = {"median_leaf": statistics.median(x[0] for x in gaps),
                      "median_norm": med, "worst": gaps[:3]}
    layers = driver.layer_stats_gaps(sg, sw)
    out["stats"] = {"median_layer": statistics.median(layers.values()),
                    "worst": sorted(((v, k) for k, v in layers.items()), reverse=True)[:3]}
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--details", action="store_true",
                    help="train cells: where the gaps come from, leaf by leaf")
    ap.add_argument("--program-precision", default=None, choices=("fp32", "bf16-mixed"),
                    help="run the program at this precision (a witness beside the "
                         "configuration's own)")
    args = ap.parse_args(argv)
    workload = core.load_json("workloads", args.workload)
    config = core.load_json("configs", workload["config"])
    driver = core.load_module(core.ROOT / "drivers" / f"{workload['driver']}.py")
    traffic = dict(workload["traffic_params"])
    if "sample_stride" in traffic:
        traffic["sample_stride"] = 1
    if args.program_precision:
        from pointcloud_tpu_torch import cfg as program_cfg

        program_cfg.precision = args.program_precision
    dev = torch.device(args.device)
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        from pointcloud_tpu_torch.ops import _build

        _build.build()
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = SimpleNamespace(name=args.workload, workload=workload, config=config,
                               traffic=traffic, seed=seed, device=dev, sync=sync)
        state = driver.setup(cell)
        t1 = time.perf_counter()
        driver.window(cell, state, args.seconds, core.Trace(False))
        driver.release(state)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t2 = time.perf_counter()
        got, want = driver.check(cell, state)
        t3 = time.perf_counter()
        line = {"seed": seed, "sound": driver.compare(got, want),
                **control_and_fault(cell, driver, state, want,
                                    args.details and workload["driver"] == "train"),
                "setup_s": t1 - t0, "check_s": t3 - t2}
        if args.details and workload["driver"] == "train":
            line["details"] = train_details(driver, got, want)
        print(json.dumps(line), flush=True)
        del state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
