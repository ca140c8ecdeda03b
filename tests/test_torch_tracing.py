"""The program's recorder of spans and counters (utils/profiling.py), the
spans placed in the sensor, the encoder bridge, the steps and set-up, and
the benchmark's readers of them (portbench/metrics), on the CPU."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointcloud_tpu_torch.envs.scenes import scene_config
from pointcloud_tpu_torch.train.harness import (
    create_model,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from pointcloud_tpu_torch.utils import profiling
from pointcloud_tpu_torch.utils.profiling import count, span
from pointcloud_tpu_torch.vision.pc_encoder import GlobalSceneEncoder
from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor
from portbench import core

SENSOR = ["sensor.capture", "sensor.pack", "sensor.h2d", "sensor.chain", "sensor.d2h"]
ENCODE = ["encode.normalize", "encode.h2d", "encode.forward", "encode.d2h"]
LEVELS = [f"encoder.SetAbstraction_{i}" for i in range(3)]
RUNS = 3  # observations, eval steps and train steps in the recorded run


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def session():
    return profile(activities=[ProfilerActivity.CPU])


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_no_session_records_nothing():
    with span("step.train") as s:
        count("host_sync")
        with span("step.loss", device=True) as t:
            pass
    assert s is None and t is None
    assert profiling.spans() == [] and profiling.counts() == {}


def test_nested_spans_under_a_session():
    with session():
        for _ in range(2):
            with span("step.eval"):
                with span("step.forward"):
                    count("host_sync")
                    time.sleep(0.002)
                    with span("encoder.SetAbstraction_0", device=True):
                        time.sleep(0.001)
                with span("step.loss"):
                    count("host_sync", 2)
                time.sleep(0.001)
        count("host_sync")  # no span open: the recorder's own count
    spans = profiling.spans()
    assert [s.name for s in spans] == [
        "step.eval", "step.forward", "encoder.SetAbstraction_0", "step.loss"] * 2
    for k, (root, fwd, level, loss) in enumerate([spans[:4], spans[4:]]):
        assert root.parent is None and root.root == root.id and root.seq == k
        assert fwd.parent == root.id and loss.parent == root.id and level.parent == fwd.id
        assert all(s.root == root.id and s.seq == k for s in (fwd, level, loss))
        assert root.start_ns <= fwd.start_ns < fwd.end_ns <= loss.start_ns <= root.end_ns
        assert root.self_seconds == pytest.approx(
            root.seconds - fwd.seconds - loss.seconds, abs=1e-9)
        assert fwd.self_seconds == pytest.approx(fwd.seconds - level.seconds, abs=1e-9)
        assert root.self_seconds >= 0.001 and level.self_seconds == level.seconds
        assert (root.counts, fwd.counts, level.counts, loss.counts) == (
            {}, {"host_sync": 1}, {}, {"host_sync": 2})
        assert level.device_ms() is None  # no CUDA: no event pair
    assert profiling.counts() == {"host_sync": 7}


def test_spans_are_in_the_trace_on_its_clock():
    with session() as prof:
        with span("step.eval"):  # the process's first record_function pays a one-off cost
            pass
        profiling.reset()
        for _ in range(3):
            with span("step.eval"):
                with span("step.forward"):
                    time.sleep(0.001)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("step.eval", "step.forward")]
    spans = profiling.spans()
    assert len(spans) == 6 and len(events) == 7
    for s in spans:
        near = min((e for e in events if e.name() == s.name),
                   key=lambda e: abs(e.start_ns() - s.start_ns))
        assert abs(near.start_ns() - s.start_ns) < 1e6
        assert abs(near.start_ns() + near.duration_ns() - s.end_ns) < 1e6


def test_setup_spans_record_without_a_session():
    with span("setup.kernels") as s:
        count("kernels_built", 3)
    spec = create_model("Autoencoder", "PointNet", "Cube", loss_override="chamfer",
                        device="cpu")
    assert spec.model is not None and s is not None
    got = profiling.spans()
    assert [t.name for t in got] == ["setup.kernels", "setup.create_model"]
    assert got[0].counts == {"kernels_built": 3} and got[1].seconds > 0
    assert profiling.counts() == {"kernels_built": 3}


class CameraBackend:
    """A camera serving fixed clouds inside the Cube scene's bbox."""

    def __init__(self, bbox, points, seed):
        rng = np.random.default_rng(seed)
        lo, hi = bbox[:, 0], bbox[:, 1]
        self.xyz = (lo + (hi - lo) * rng.random((points, 3))).astype(np.float32)
        self.rgb = rng.random((points, 3)).astype(np.float32)

    def capture_pointcloud(self, features=("rgb",)):
        return self.xyz, {"rgb": self.rgb}


class FakeEvent:
    """A stand-in CUDA event whose elapsed time is given."""

    def __init__(self, ms=0.0):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.fixture(scope="module")
def recorded():
    """The spans of RUNS observations (sensor and encoder at B=1), RUNS
    PointNet2 eval steps and RUNS PointNet train steps under a CPU session,
    each device span given a stand-in event pair that reads its host
    duration in ms."""
    torch.manual_seed(0)
    sc = scene_config("Cube")
    bbox = np.asarray(sc.bbox, dtype=np.float32)
    ae = create_model("Autoencoder", "PointNet2", "Cube", loss_override="chamfer",
                      device="cpu")
    pn = create_model("Autoencoder", "PointNet", "Cube", loss_override="chamfer",
                      device="cpu")
    env = SimpleNamespace(device="cpu", bbox=bbox, sampler="FPS", sample_points=1024,
                          backend=CameraBackend(bbox, 4096, 0))
    sensor = PointCloudSensor(env)
    encoder = GlobalSceneEncoder.__new__(GlobalSceneEncoder)
    encoder.features, encoder.device, encoder.model = ["rgb"], torch.device("cpu"), ae.model
    eval_step = make_eval_step(ae)
    train_step = make_train_step(pn, make_optimizer(pn))
    x = torch.from_numpy(np.stack([CameraBackend(bbox, 1024, s).xyz for s in (1, 2)]))
    x = torch.cat([x, torch.rand(2, 1024, 3)], dim=2)
    profiling.reset()
    with session():
        for _ in range(RUNS):
            latent = encoder.encode_observation(sensor.observe({}))
            eval_step(x, x)
            train_step(x, x)
    assert latent.shape == (sum(sc.class_latent_dim),)
    spans = profiling.spans()
    for s in spans:
        if s.name.startswith("encoder.") or s.name in ("step.loss", "step.optimizer"):
            s.events = (FakeEvent(), FakeEvent(1e3 * s.seconds))
    profiling.reset()
    return spans


def test_program_spans_on_the_cpu(recorded):
    roots = [s for s in recorded if s.parent is None]
    assert [s.name for s in roots] == ["sensor.observe", "encode.observe", "step.eval",
                                       "step.train"] * RUNS
    assert [s.seq for s in roots] == [k for k in range(RUNS) for _ in range(4)]
    for root in roots:
        kids = children(recorded, root)
        under = [s for s in recorded if s.root == root.id]
        if root.name == "sensor.observe":
            assert [s.name for s in kids] == SENSOR and len(under) == 6
            assert sum(s.counts.get("host_sync", 0) for s in under) == 1
            assert kids[-1].counts == {"host_sync": 1}
        elif root.name == "encode.observe":
            assert [s.name for s in kids] == ENCODE
            assert [s.name for s in children(recorded, kids[2])] == LEVELS
            assert sum(s.counts.get("host_sync", 0) for s in under) == 1
        elif root.name == "step.eval":
            assert [s.name for s in kids] == ["step.transforms", "step.forward", "step.loss"]
            assert [s.name for s in children(recorded, kids[1])] == LEVELS
        else:
            assert [s.name for s in kids] == ["step.transforms", "step.forward", "step.loss",
                                              "step.backward", "step.optimizer"]
        assert all(s.seq == root.seq for s in under)
        assert root.self_seconds == pytest.approx(
            root.seconds - sum(s.seconds for s in kids), abs=1e-9)
    syncs = [sum(s.counts.get("host_sync", 0) for s in recorded
                 if s.root in {r.id for r in roots[4 * k:4 * k + 2]}) for k in range(RUNS)]
    assert syncs == [2] * RUNS


def _mean_ms(spans, root, names, n, device=False):
    roots = [s for s in spans if s.parent is None and s.name == root][:n]
    ids = {s.id for s in roots}
    got = [s for s in spans if s.root in ids and s.name in names]
    return sum(s.device_ms() if device else 1e3 * s.seconds for s in got) / len(roots)


def expected(spans, name, n):
    """Each metric as its definition reads it, over the first n roots."""
    if name == "sensor_copy_ms.observe":
        return _mean_ms(spans, "sensor.observe", ("sensor.pack", "sensor.h2d"), n)
    if name == "sensor_wait_ms.observe":
        return _mean_ms(spans, "sensor.observe", ("sensor.d2h",), n)
    if name == "encode_enqueue_ms.observe":
        return _mean_ms(spans, "encode.observe", ("encode.forward",), n)
    if name == "encode_wait_ms.observe":
        return _mean_ms(spans, "encode.observe", ("encode.d2h",), n)
    if name == "host_syncs.observe":
        return 2.0
    if name == "optimizer_device_ms.train":
        return _mean_ms(spans, "step.train", ("step.optimizer",), n, device=True)
    if name == "encoder_device_ms.eval":
        return _mean_ms(spans, "step.eval", tuple(LEVELS), n, device=True)
    setup = {"kernel_load_s.setup": "setup.kernels", "model_init_s.setup": "setup.create_model"}
    return sum(s.seconds for s in spans if s.name == setup[name])


METRICS = ["sensor_copy_ms.observe", "sensor_wait_ms.observe", "encode_enqueue_ms.observe",
           "encode_wait_ms.observe", "host_syncs.observe", "optimizer_device_ms.train",
           "encoder_device_ms.eval", "kernel_load_s.setup", "model_init_s.setup"]


def reader(name):
    return core.load_module(core.ROOT / "metrics" / f"{name}.py").read


@pytest.mark.parametrize("name", METRICS)
def test_metric_reads_the_first_roots_only(recorded, monkeypatch, name):
    """Over the first two of three recorded requests; the set-up readers sum
    every set-up span (two added here: the run recorded none)."""
    setup = [SimpleNamespace(name=n, parent=None, root=-1 - k, id=-1 - k, start_ns=0,
                             end_ns=(k + 1) * 10**9, counts={},
                             seconds=float(k + 1))
             for k, n in enumerate(("setup.kernels", "setup.create_model"))]
    spans = setup + recorded
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    for n in (2, RUNS):
        got = reader(name)(SimpleNamespace(observations=n, steps=n))
        assert got == pytest.approx(expected(spans, name, n), rel=1e-12)


@pytest.mark.parametrize("name", METRICS)
def test_metric_reads_none_from_an_empty_recorder(name):
    assert profiling.spans() == []
    assert reader(name)(SimpleNamespace(observations=5, steps=5)) is None

