"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's files are found by name:
portbench/workloads/<cell>.json (its configuration, driver, traffic
parameters and the limits of its comparisons), portbench/configs/<config>.json,
portbench/drivers/<driver>.py and, with --trace 1, portbench/metrics/<metric>.py
for each per-layer metric that BENCHMARK.json gives the cell.

A run: set-up (imports, the program's CUDA libraries built or loaded, inputs
and weights from the seed, the cell's shapes warmed up), `--seconds` of
measured window, the device's peak memory, then the program's state freed
and the check of what the window produced against the plain reference
(portbench/reference). The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 a breakdown, and
last the numbers compared, each beside its limit, which also close standard
error. The traced run traces the device alone over the window, then a 2 s
window more with the host's activity too, whose idle gaps the breakdown
labels. Without a CUDA device, or with fewer than the cell needs, it exits
with 2 and prints no result; if the process holds JAX or the JAX package
after the window, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import core  # noqa: E402

core.cache_env()

LABEL_SECONDS = 2.0  # the host-traced window that labels the idle gaps


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that apply to
    the cell: those whose `workloads` list it, or that have no such list
    and (per-layer) move one of the cell's end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return e2e, per


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = core.ROOT, bench: dict | None = None, t_start: float | None = None):
    """One run of the cell -> (exit code, result dict or None). `device`,
    `root` (where the cell's workload and configuration files are found) and
    `bench` are for the tests, which run the harness on the CPU at small
    sizes from files of their own."""
    import torch

    t_start = T_START if t_start is None else t_start
    if bench is None:
        with open(core.CHECKOUT / "BENCHMARK.json") as f:
            bench = json.load(f)
    workload = core.load_json("workloads", name, root)
    config = core.load_json("configs", workload["config"], root)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == name), 1)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: {name} needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                  f"available", file=sys.stderr)
            return 2, None
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    torch.set_num_threads(4)
    driver = core.load_module(core.ROOT / "drivers" / f"{workload['driver']}.py")
    cell = SimpleNamespace(
        name=name, workload=workload, config=config, traffic=workload["traffic_params"],
        seed=seed, device=dev,
        sync=(lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None))
    e2e, per = cell_metrics(bench, name)

    power = ""
    if dev.type == "cuda":
        from pointcloud_tpu_torch.ops import _build

        _build.build()  # every kernel library at once where missing, else none
        power = core.power_limit()
    state = driver.setup(cell)
    setup_s = core.now() - t_start

    tracer = core.Trace(trace and dev.type == "cuda")
    res = driver.window(cell, state, seconds, tracer)
    labels = None
    if tracer.on:
        # a short window more, traced with host activity, names what the host
        # was doing in the device's idle gaps; the metrics read the first
        labeller = core.Trace(True, host=True)
        driver.window(cell, state, LABEL_SECONDS, labeller)
        labels = labeller.reduce(LABEL_SECONDS)["idle_gaps"]
    found = core.forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)} after the window",
              file=sys.stderr)
        return 3, None
    info = (core.device_info(torch, chips) if dev.type == "cuda"
            else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    if power:
        info["power"] = power

    metrics, breakdown = {}, None
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        reduced = tracer.reduce(res["window_s"]) if tracer.on else {
            "kernels": [], "busy_s": 0.0, "device_ops": [], "idle_gaps": []}
        info["busy_s"], info["window_s"] = reduced["busy_s"], res["window_s"]
        breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": labels or []}
        run = SimpleNamespace(**res, kernels=reduced["kernels"], busy_s=reduced["busy_s"],
                              config=config, traffic=cell.traffic, workload=workload)
        for m in per:
            reader = core.load_module(core.ROOT / "metrics" / f"{m['name']}.py")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = dict(res["metrics"], setup_s=setup_s)
        for m in e2e:
            if m["name"] not in measured:
                raise KeyError(f"{name} does not measure {m['name']}")
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": units[m["name"]]}

    driver.release(state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got, want = driver.check(cell, state)
    checks = driver.compare(got, want)
    # the cell's limits choose the numbers that decide `correct`
    limits = workload["limits"] or dict.fromkeys(checks, 0.0)
    compared = {k: {"value": checks[k], "limit": v} for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())

    result = {"correct": correct, "attempted": res["steps"], "failed": 0,
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    return 0, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    code, result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return code
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
