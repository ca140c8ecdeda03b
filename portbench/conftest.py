"""Fixtures of the benchmark's own tests (portbench/test_portbench_*.py):

    python -m pytest portbench -q            # on the CPU; card tests skip
    python -m pytest portbench -q -m cuda    # on a machine with the card

`tiny_root` writes the benchmark's configurations and cells into a folder of
their own with the traffic cut to what a CPU test holds (two clouds a batch,
small camera clouds, one warm-up step, answers kept from the first steps);
the widths stay the configurations' own.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent))

TINY = {"batch": 2, "pool_batches": 4, "camera_points": 8192, "pool_clouds": 2,
        "calibration_clouds": 2, "sample_stride": 1, "warmup_steps": 1,
        "warmup_observations": 1, "sample_observations": 2, "sample_steps": 2}


def write_tiny(root: Path) -> Path:
    for kind in ("configs", "workloads"):
        (root / kind).mkdir(parents=True, exist_ok=True)
        for f in sorted((ROOT / kind).glob("*.json")):
            data = json.loads(f.read_text())
            if kind == "workloads":
                p = data["traffic_params"]
                p.update({k: v for k, v in TINY.items() if k in p})
            (root / kind / f.name).write_text(json.dumps(data))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny(tmp_path / "tiny")


@pytest.fixture
def benchmark_json():
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    """Skips without a CUDA device (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
