"""Profiling: the program's spans and counters, and the operator's trace.

The recorder. `span(name, device=False)` is a context manager around one
piece of the program's work and `count(name, n=1)` adds a count to the
innermost open span; `spans()`, `counts()` and `reset()` read and clear
what was recorded. A span keeps its name, its start and end in ns, the id
of its parent span and of its root (the request: one train or eval step,
one observation), the running sequence number of its root's name, its
counts and, with `device=True`, a pair of CUDA timing events. Spans stay in
memory until `reset()`.

Spans on the per-step path record only while a `torch.profiler` session is
active (torch.autograd.profiler._is_profiler_enabled): the benchmark's
traced window and `trace()` below turn them on, and with no session a span
costs a flag read and a branch. The set-up spans (`ALWAYS`) run once a
process and record always. While a session is active each span also enters
`torch.profiler.record_function(name)`, so the trace holds it, and its
start and end are read on the clock of the profiler's events
(`time.time_ns()`: kineto gives its events on the Unix epoch in ns), so a
span read from memory and a kernel read from the trace share one time line.

`device=True` (with CUDA initialised) records a CUDA timing event on the
current stream as the span opens and another as it closes. Their elapsed
time (`Span.device_ms()`, read only when the spans are read, after the
window's last synchronize; nothing in the window waits on them) runs from
the end of the work enqueued before the span to the end of the span's own
work: device idle time inside that interval is counted.

The spans and counters placed in the program:
- `sensor.observe` (root, `vision/pc_sensor.py` PointCloudSensor.observe):
  `sensor.capture` (the backend's camera), `sensor.pack` (concatenation,
  contiguous float32, `from_numpy`), `sensor.h2d` (`.to(device)`),
  `sensor.chain` (building and enqueueing FilterBBox and FPS), `sensor.d2h`
  (`.cpu()`: the host's wait for the chain and the copy back).
- `encode.observe` (root, `vision/pc_encoder.py`
  GlobalSceneEncoder.encode_observation), and in the shared helpers of every
  encoder class: `encode.normalize`, `encode.h2d`, `encode.forward` (the
  enqueue of the model's call), `encode.d2h` (the wait and the copy back).
- `step.train` (root, `train/harness.py` make_train_step): `step.transforms`,
  `step.forward`, `step.loss` (device), `step.backward`, `step.optimizer`
  (device). `step.eval` (root, make_eval_step): `step.transforms`,
  `step.forward`, `step.loss` (device).
- `encoder.<level>` (device, `models/pointnet2.py`): each SA level of
  PointNet2Encoder (`encoder.SetAbstraction_0..2`) and of
  PointNet2MSGEncoder (`encoder.SetAbstractionMsg_0..1`,
  `encoder.SetAbstraction_0`).
- `setup.kernels` (`ops/_build.py`: an nvcc build of missing libraries,
  counting `kernels_built`, and each library's first load) and
  `setup.create_model` (`train/harness.create_model`).
- Counter `host_sync`: each explicit host wait on the device, counted where
  it is written (`sensor.d2h`, `encode.d2h`, the host's reads of the loss in
  `train()`).

`trace(run_dir)`: the operator's `torch.profiler` export of the host and
the device (`trace.json` in `run_dir`, for chrome://tracing or Perfetto),
which holds the program's spans as user annotations. The train loop opens
it for steps 2-5 under `profile=True`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# spans that run once a process and record with no profiler session
ALWAYS = frozenset({"setup.kernels", "setup.create_model"})


class Span:
    """One recorded span; `end_ns` is None while it is open."""

    __slots__ = ("id", "name", "parent", "root", "seq", "start_ns", "end_ns",
                 "child_ns", "counts", "events")

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_seconds(self) -> float:
        """The duration less the part its child spans cover."""
        return (self.end_ns - self.start_ns - self.child_ns) / 1e9

    def device_ms(self) -> float | None:
        """The elapsed ms of the span's CUDA event pair (waits for the later
        event), or None where it recorded none."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


_OFF = contextlib.nullcontext()  # what `span` returns when it does not record


class _Open:
    """One span being recorded."""

    __slots__ = ("rec", "name", "device", "span", "rf", "stream")

    def __init__(self, rec: Recorder, name: str, device: bool):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self) -> Span:
        rec = self.rec
        stack = rec._stack()
        s = Span()
        s.id, s.name, s.child_ns, s.counts, s.events, s.end_ns = (
            next(rec._ids), self.name, 0, {}, None, None)
        if stack:
            parent = stack[-1]
            s.parent, s.root, s.seq = parent.id, parent.root, parent.seq
        else:
            s.parent, s.root = None, s.id
            with rec._lock:
                s.seq = rec._seq.get(self.name, 0)
                rec._seq[self.name] = s.seq + 1
        if self.device and torch.cuda.is_initialized():
            # read once: current_stream() costs as much as an event's record
            self.stream = torch.cuda.current_stream()
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record(self.stream)
        stack.append(s)
        rec._spans.append(s)
        self.span = s
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        s.start_ns = time.time_ns()  # beside the trace's own stamp
        return s

    def __exit__(self, *exc):
        s = self.span
        if s.events is not None:
            s.events[1].record(self.stream)
        s.end_ns = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = self.rec._stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += s.end_ns - s.start_ns
        return False


class Recorder:
    """Spans and counts of one process (the module's functions are those of
    its one recorder, `RECORDER`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()  # each thread's open spans
        self._ids = itertools.count()  # never reset: a span open across reset() keeps its id
        self.reset()

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, device: bool = False):
        """A context manager recording `name` while a profiler session is
        active (always for the names in ALWAYS); it yields the Span, or None
        where it does not record."""
        if _autograd_profiler._is_profiler_enabled or name in ALWAYS:
            return _Open(self, name, device)
        return _OFF

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the count `name` of the innermost open span of this
        thread; with no span open, to the recorder's own counts while a
        profiler session is active."""
        stack = getattr(self._local, "stack", None)
        if stack:
            counts = stack[-1].counts
        elif _autograd_profiler._is_profiler_enabled:
            counts = self._loose
        else:
            return
        counts[name] = counts.get(name, 0) + n

    def spans(self) -> list[Span]:
        """The closed spans, in the order they opened."""
        return [s for s in list(self._spans) if s.end_ns is not None]

    def counts(self) -> dict[str, int]:
        """Every count, summed over the spans and those made outside any."""
        total = dict(self._loose)
        for s in self.spans():
            for k, v in s.counts.items():
                total[k] = total.get(k, 0) + v
        return total

    def reset(self) -> None:
        """Forget every span, count and sequence number (spans still open
        are recorded no more)."""
        with self._lock:
            self._spans: list[Span] = []
            self._seq: dict[str, int] = {}
            self._loose: dict[str, int] = {}


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
spans = RECORDER.spans
counts = RECORDER.counts
reset = RECORDER.reset


@contextlib.contextmanager
def trace(run_dir: str):
    """Trace what runs inside the block; writes run_dir/trace.json, which
    holds the program's spans."""
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
