"""The harness on and off the card: without one it fails and prints no result
(it never falls back to the CPU); with one, each cell runs briefly and is
correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.core import ROOT


def run(*args, timeout=1500):
    return subprocess.run([sys.executable, "portbench/run.py", *args], capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT.parent)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run("--workload", "ae_pointnet2_chamfer.train_b256", "--seed", "1",
              "--seconds", "1", "--trace", "0", timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == "", out.stderr[-2000:]
    assert "needs 1 CUDA device" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", [p.stem for p in sorted((ROOT / "workloads").glob("*.json"))])
def test_cell_on_the_card(name, card):
    out = run("--workload", name, "--seed", str(2**31 + 21), "--seconds", "2", "--trace", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
