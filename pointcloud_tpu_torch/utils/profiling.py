"""Profiling hooks (port of pointcloud_tpu/utils/profiling.py).

- `trace(run_dir)`: context manager around `torch.profiler` that writes a
  Chrome trace of the host and the device (`trace.json` in `run_dir`),
  viewable in chrome://tracing or Perfetto. The train loop opens it for
  steps 2-5 under `profile=True`.
- `StepTimer`: steady-state step timing on the host clock with warmup
  discard, used by the train loop's epoch line.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(run_dir: str):
    """Trace what runs inside the block; writes run_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(run_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(run_dir, "trace.json"))


class StepTimer:
    """Steady-state step timing: discards `warmup` steps, tracks mean/p50."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0 = None
        self._seen = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def p50(self) -> float:
        if not self.times:
            return float("nan")
        s = sorted(self.times)
        return s[len(s) // 2]

    def summary(self, unit_per_step: float = 1.0, unit: str = "items"):
        if not self.times:
            return "no steady-state steps recorded"
        return (
            f"mean {self.mean*1e3:.2f} ms/step, p50 {self.p50*1e3:.2f} ms/step, "
            f"{unit_per_step/self.mean:,.0f} {unit}/s"
        )
