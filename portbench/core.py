"""The benchmark's shared machinery: finding a cell's files by name, the
cache directories, the device check, host spans, the traced window and its
reduction to busy time, idle gaps and kernel times, the comparisons that
decide `correct`, and the result line.

Nothing here imports the program or JAX; torch is imported by the caller
after `cache_env()` has fixed the cache directories.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import re
import statistics
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent  # the benchmark's folder
CHECKOUT = ROOT.parent  # the checkout the benchmark runs from
# top-level module names that no process of the benchmark may hold: JAX and
# the JAX package (compared whole: the program's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "pointcloud_tpu")


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program builds its CUDA libraries into <checkout>/build itself), and no
    library loading JAX on its own. Call before importing torch."""
    cache = CHECKOUT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that sys.modules holds."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """<root>/<kind>/<name>.json, the file of one configuration or cell."""
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    with open(path) as f:
        data = json.load(f)
    if data.get("name") != name:
        raise ValueError(f"{path} names itself {data.get('name')!r}, not {name!r}")
    return data


def load_module(path: Path):
    """A Python file of the benchmark (a driver or a metric reader) by path:
    their names may hold dots."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = "portbench_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spans:
    """Host-clock spans by name, in seconds, kept in memory."""

    def __init__(self):
        self.spans: dict[str, list[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


############################## the trace ##############################


class Trace:
    """torch.profiler over a window, reduced to the device's kernel
    intervals, their union (busy), the idle gaps labelled by the innermost
    host event that spans each gap's middle, and the kernels' times by name.
    With `host`, host activity is traced too (every operator: it slows a
    host-paced step by a third or more), else the device's alone. Off
    (`on=False`), it does nothing."""

    def __init__(self, on: bool, host: bool = False):
        self.on, self.host = on, host
        self.prof = None

    @contextmanager
    def region(self, name: str):
        """A host span that the trace shows (and labels gaps by)."""
        if not (self.on and self.host):
            yield
            return
        import torch

        with torch.profiler.record_function(name):
            yield

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host else [])
            self.prof = profile(activities=activities)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            import torch

            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        return False

    def reduce(self, window_s: float) -> dict:
        """{kernels: [(name, seconds)], busy_s, device_ops, idle_gaps}."""
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation():  # a host span's shadow, not a kernel
                    continue
                device.append((start, start + dur, e.name()))
            elif dur > 0:
                host.append((start, start + dur, e.name()))
        device.sort()
        busy_ns, gaps, end = 0, [], None
        for s, t, _ in device:
            if end is None or s > end:
                if end is not None:
                    gaps.append((s - end, end, s))
                busy_ns += t - s
                end = t
            elif t > end:
                busy_ns += t - end
                end = t
        by_name: dict[str, float] = {}
        for s, t, name in device:
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "kernels": [(name, (t - s) / 1e9) for s, t, name in device],
            "busy_s": busy_ns / 1e9,
            "window_s": window_s,
            "device_ops": [[_short(n), v] for n, v in ops],
            "idle_gaps": _label_gaps(gaps, host),
        }


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def _label_gaps(gaps, host, top: int = 2000):
    """The idle time of the `top` longest gaps, summed by the innermost host
    event spanning each gap's middle ('no host op traced' where none does);
    the ten largest sums."""
    host.sort()
    starts = [h[0] for h in host]
    # host events that are still open at a point are found among the last
    # ones that started before it: scan back over a bounded window
    longest = max((t - s for s, t, _ in host), default=0)
    sums: dict[str, float] = {}
    for dur, a, b in sorted(gaps, reverse=True)[:top]:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        j = i - 1
        while j >= 0 and starts[j] >= mid - longest:
            s, t, name = host[j]
            if t >= mid and (best is None or t - s < best[0]):
                best = (t - s, name)
            j -= 1
            if i - 1 - j > 4000:
                break
        label = best[1] if best else "no host op traced"
        sums[label] = sums.get(label, 0.0) + dur / 1e9
    return [[_short(n), v] for n, v in sorted(sums.items(), key=lambda kv: -kv[1])[:10]]


def kernel_seconds(run, pattern: str) -> float:
    """The device seconds of the traced window's kernels whose name matches
    the regular expression."""
    rx = re.compile(pattern)
    return sum(d for name, d in run.kernels if rx.search(name))


############################## correctness ##############################


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / abs(b)


def leaf_gap(got: dict, want: dict, keep) -> float:
    """The worst leaf's gap between two norms, |got - want|, measured against
    want's norm of that leaf or of the median kept leaf, whichever is
    larger."""
    med = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keep)


def nought_leaves(grads: dict, share: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient is nought to rounding: a norm under
    `share` of the median of the leaves whose norm is not zero (a Dense bias
    under a train-mode BatchNorm; an STN's layers below its zero-initialised
    head, whose first gradient is exactly zero)."""
    med = statistics.median(v for v in grads.values() if v > 0)
    return sorted(k for k, v in grads.items() if v < share * med)


############################## the result ##############################


def device_info(torch, chips: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips)),
    }


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them ('' where it
    cannot)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def now() -> float:
    return time.perf_counter()
