"""Every configuration, cell, driver and per-layer metric is found by name,
and BENCHMARK.json lists exactly the files the benchmark has; a cell added as
a new file alone runs."""

from __future__ import annotations

import json
import time

from portbench import core
from portbench.core import ROOT


def test_benchmark_lists_every_file(benchmark_json):
    b = benchmark_json
    assert {c["name"] for c in b["configs"]} == {p.stem for p in (ROOT / "configs").glob("*.json")}
    assert {w["name"] for w in b["workloads"]} == {
        p.stem for p in (ROOT / "workloads").glob("*.json")}
    for c in b["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = core.load_json("configs", c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        wl = core.load_json("workloads", w["name"])
        assert (wl["config"], wl["traffic"], wl["why"]) == (w["config"], w["traffic"], w["why"])
        assert (ROOT / "drivers" / f"{wl['driver']}.py").is_file()
        assert wl["limits"], f"{w['name']} has no limits"
    for m in b["per_layer"]:
        assert callable(core.load_module(ROOT / "metrics" / f"{m['name']}.py").read)
    assert {p.name[:-3] for p in (ROOT / "metrics").glob("*.py")} == {
        m["name"] for m in b["per_layer"]}


def test_every_cell_reports_its_metrics(benchmark_json):
    from portbench.run import cell_metrics

    for w in benchmark_json["workloads"]:
        e2e, per = cell_metrics(benchmark_json, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per
        assert all(m["moves"] in names for m in per)


def test_a_new_cell_is_only_files(tiny_root, benchmark_json):
    """A cell written as one more workload file (and a BENCHMARK.json entry)
    runs through the harness unchanged."""
    from portbench.run import run_cell

    src = json.loads((tiny_root / "workloads" / "ae_pointnet2_chamfer.eval_b256.json").read_text())
    src.update(name="ae_pointnet2_chamfer.eval_b3", traffic="eval_b3")
    src["traffic_params"]["batch"] = 3
    (tiny_root / "workloads" / "ae_pointnet2_chamfer.eval_b3.json").write_text(json.dumps(src))
    bench = dict(benchmark_json)
    bench["workloads"] = bench["workloads"] + [{
        "name": "ae_pointnet2_chamfer.eval_b3", "config": "ae_pointnet2_chamfer",
        "traffic": "eval_b3", "chips": 1, "why": "a test cell"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ae_pointnet2_chamfer.eval_b256" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["ae_pointnet2_chamfer.eval_b3"]
    code, res = run_cell("ae_pointnet2_chamfer.eval_b3", 2**31 + 5, 0.5, False, device="cpu",
                         root=tiny_root, bench=bench, t_start=time.perf_counter())
    assert code == 0 and res["correct"], res
    assert set(res["metrics"]) == {"eval_clouds_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
