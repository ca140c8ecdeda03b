"""`correct` separates: a sound run of the harness on the CPU (the program's
float32 path) passes every limit; the control (the reference in float8
products put in the program's place) and each fault that a cell can have,
planted under the harness in the program's timed path, fail one or more.
The limits are the cells' own, set from readings on the card."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import core
from portbench import reference as R

TRAIN = ["ae_pointnet2_chamfer.train_b256", "ae_pointnet_emd.train_b128"]
ALL = TRAIN + ["ae_pointnet2_chamfer.eval_b256", "ae_pointnet2_chamfer.observe_b1"]


def run(name, root, bench):
    from portbench.run import run_cell

    code, res = run_cell(name, 2**31 + 11, 0.5, False, device="cpu", root=root, bench=bench,
                         t_start=time.perf_counter())
    assert code == 0
    return res


@pytest.mark.parametrize("name", ALL)
def test_sound_run_is_correct(name, tiny_root, benchmark_json):
    res = run(name, tiny_root, benchmark_json)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", ALL)
def test_control_fails(name, tiny_root):
    """The readings.py control at the test's size."""
    from types import SimpleNamespace

    from portbench.readings import control_and_fault

    workload = core.load_json("workloads", name, tiny_root)
    cfg = core.load_json("configs", workload["config"], tiny_root)
    driver = core.load_module(core.ROOT / "drivers" / f"{workload['driver']}.py")
    cell = SimpleNamespace(name=name, workload=workload, config=cfg,
                           traffic=workload["traffic_params"], seed=2**31 + 12,
                           device=torch.device("cpu"), sync=lambda: None)
    state = driver.setup(cell)
    driver.window(cell, state, 0.5, core.Trace(False))
    driver.release(state)
    _, want = driver.check(cell, state)
    got = control_and_fault(cell, driver, state, want)["control"]
    limits = core.load_json("workloads", name)["limits"]
    assert any(got[k] > v for k, v in limits.items()), got


def _stale(make):
    def make_broken(spec, opt):
        step = make(spec, opt)

        def broken(x, y):
            keep = [p.detach().clone() for p in spec.model.parameters()]
            out = step(x, y)
            with torch.no_grad():
                for p, k in zip(spec.model.parameters(), keep):
                    p.copy_(k)
            return out
        return broken
    return make_broken


def _half_train(make):
    def make_broken(spec, opt):
        step = make(spec, opt)
        return lambda x, y: step(x[: len(x) // 2], y[: len(y) // 2])
    return make_broken


def _half_eval(make):
    def make_broken(spec):
        step = make(spec)

        def broken(x, y):
            loss, logs, out = step(x[: len(x) // 2], y[: len(y) // 2])
            return loss, logs, out.repeat(2, 1, 1)
        return broken
    return make_broken


def _altered_eval(make):
    def make_broken(spec):
        step = make(spec)

        def broken(x, y):
            loss, logs, out = step(x, y)
            out = out.clone()
            out[-1, :, :3] = out[-1, :, :3] * 0.8
            return loss, logs, out
        return broken
    return make_broken


FAULTS = [
    ("ae_pointnet2_chamfer.train_b256", "make_train_step", _stale),
    ("ae_pointnet2_chamfer.train_b256", "make_train_step", _half_train),
    ("ae_pointnet_emd.train_b128", "make_train_step", _stale),
    ("ae_pointnet_emd.train_b128", "make_train_step", _half_train),
    ("ae_pointnet2_chamfer.eval_b256", "make_eval_step", _half_eval),
    ("ae_pointnet2_chamfer.eval_b256", "make_eval_step", _altered_eval),
]


@pytest.mark.parametrize("name,entry,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, _, f in FAULTS])
def test_fault_is_not_correct(name, entry, fault, tiny_root, benchmark_json, monkeypatch):
    import pointcloud_tpu_torch.train.harness as harness

    monkeypatch.setattr(harness, entry, fault(getattr(harness, entry)))
    res = run(name, tiny_root, benchmark_json)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("part", ["sensed", "latent"])
def test_observe_fault_is_not_correct(part, tiny_root, benchmark_json, monkeypatch):
    """An answer altered where it is produced: one sensed point moved, or the
    latent scaled by 1.5."""
    from pointcloud_tpu_torch.vision.pc_encoder import GlobalSceneEncoder
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

    if part == "sensed":
        orig = PointCloudSensor.observe

        def observe(self, state):
            obs = orig(self, state)
            obs["points"] = obs["points"].copy()
            obs["points"][0] += 0.01
            return obs
        monkeypatch.setattr(PointCloudSensor, "observe", observe)
    else:
        orig = GlobalSceneEncoder.encode_observation

        def encode(self, obs):
            return orig(self, obs) * 1.5
        monkeypatch.setattr(GlobalSceneEncoder, "encode_observation", encode)
    res = run("ae_pointnet2_chamfer.observe_b1", tiny_root, benchmark_json)
    assert not res["correct"], res["checks"]


def test_precision_control_rounds():
    """float8 e4m3 keeps 3 mantissa bits: each value within 2^-4 of itself
    (relative), and most values move."""
    a = torch.linspace(-3, 3, 101)
    low = R.Precision(True)._fp8(a)
    rel = (low - a).abs() / a.abs().clamp_min(1e-3)
    assert float(rel.max()) <= 2**-4 + 1e-6 and int((low != a).sum()) > 50
