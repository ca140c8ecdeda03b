"""The RL user's per-env-step path, closed loop with one client: each
observation is a raw camera cloud on the host (numpy, xyz + rgb) from a
seeded pool of synthetic Cube-scene clouds, handed to the program's
`PointCloudSensor.observe` (the move to the card, `transforms.sensor_chain`:
FilterBBox and FPS to the scene's 2,048 points, and back to numpy), whose
observation goes to `GlobalSceneEncoder.encode_observation` (the bbox
normalisation and `model.encode` at B=1, the latent back in numpy). Each
observation is timed from the hand-over of its raw cloud to its latent on
the host.

The sensor reads its cloud from a stand-in backend that serves the pool; the
encoder is the program's class with its model set from the seed's weights
(running statistics from a seeded calibration batch) instead of loaded from a
checkpoint on disk. `correct` holds a sample of the window's observations,
drawn from the seed: the sensed cloud exactly, and the latent, against the
reference's sensor chain and encoder on the same raw cloud.

Traffic parameters: camera_points (points a raw cloud), pool_clouds,
warmup_observations, calibration_clouds, sample_observations,
sample_stride.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

import pointcloud_tpu_torch.train.harness as harness
import torch
from pointcloud_tpu_torch.vision.pc_encoder import GlobalSceneEncoder
from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

from portbench import core, scene
from portbench import reference as R
from portbench.drivers.eval import calibrated_weights


class PoolBackend:
    """A stand-in simulator backend whose camera serves the pool's clouds."""

    def __init__(self, pool):
        self.pool, self.current = pool, 0

    def capture_pointcloud(self, features=("rgb",)):
        cloud = self.pool[self.current]
        return cloud[:, :3], {"rgb": cloud[:, 3:6]}


def setup(cell):
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    rng = np.random.default_rng(cell.seed)
    pool = scene.render(rng, tr["pool_clouds"], tr["camera_points"])
    weights = calibrated_weights(cfg, tr, cell.seed, dev)
    spec = harness.create_model(cfg["model_type"], cfg["backbone"], cfg["scene"],
                                loss_override=cfg["loss_override"], device=dev)
    spec.model.load_state_dict(weights, strict=True)
    backend = PoolBackend(pool)
    env = SimpleNamespace(device=dev, bbox=cfg["bbox"], sampler="FPS",
                          sample_points=cfg["points"], backend=backend)
    sensor = PointCloudSensor(env)
    encoder = GlobalSceneEncoder.__new__(GlobalSceneEncoder)
    encoder.features, encoder.device, encoder.model = ["rgb"], dev, spec.model.eval()
    state = {"pool": pool, "weights": weights, "spec": spec, "backend": backend,
             "sensor": sensor, "encoder": encoder, "kept": {},
             "offset": int(np.random.default_rng([cell.seed, 2]).integers(tr["sample_stride"]))}
    for i in range(tr["warmup_observations"]):
        observe(state, i, core.Spans(), core.Trace(False))
    cell.sync()
    state["next"] = tr["warmup_observations"]
    return state


def observe(state, i, spans, trace):
    """One observation of the pool's cloud i % pool: (sensed cloud, latent,
    seconds from hand-over to latent)."""
    state["backend"].current = i % len(state["pool"])
    t0 = core.now()
    with trace.region("portbench.sensor"):
        obs = state["sensor"].observe({})
    t1 = core.now()
    with trace.region("portbench.encode"):
        latent = state["encoder"].encode_observation(obs)
    t2 = core.now()
    spans.add("sensor", t1 - t0)
    spans.add("encode", t2 - t1)
    return obs, latent, t2 - t0


def window(cell, state, seconds, trace):
    tr = cell.traffic
    kept, stride, off = state["kept"], tr["sample_stride"], state["offset"]
    spans, lat = core.Spans(), []
    i, n = state["next"], 0
    with trace:
        t0 = core.now()
        while core.now() - t0 < seconds:
            obs, latent, dt = observe(state, i, spans, trace)
            lat.append(dt)
            if n % stride == off and len(kept) < tr["sample_observations"]:
                kept[n] = (i % len(state["pool"]),
                           np.concatenate([obs["points"], obs["rgb"]], axis=1), latent)
            i, n = i + 1, n + 1
        t1 = core.now()
    ms = np.asarray(lat) * 1e3
    return {"steps": n, "observations": n, "window_s": t1 - t0, "spans": spans.spans,
            "metrics": {"observe_ms_p50": float(np.percentile(ms, 50)),
                        "observe_ms_p95": float(np.percentile(ms, 95))}}


def release(state):
    for key in ("spec", "sensor", "encoder", "backend"):
        state.pop(key, None)


def check(cell, state, prec=R.FP32):
    got = {n: (c, sensed, latent) for n, (c, sensed, latent) in state["kept"].items()}
    want = readings_of_reference(cell.config, state["weights"], state["pool"],
                                 [c for c, _, _ in got.values()], cell.device, prec)
    return got, want


def readings_of_reference(cfg, weights, pool, clouds, device, prec):
    """{pool cloud: (sensed (K, 6), latent)} as numpy."""
    out = {}
    for c in sorted(set(clouds)):
        sensed = R.sense(torch.from_numpy(pool[c]).to(device), cfg["bbox"], cfg["points"])
        x = R.normalize(sensed, cfg["bbox"])[None]
        with torch.no_grad():
            latent = R.encode(weights, cfg, x, False, prec)[0]
        out[c] = (sensed.cpu().numpy(), latent.cpu().numpy())
    return out


def compare(got, want) -> dict:
    """The worst kept observation's sensed-cloud gap (largest absolute
    difference: the sensor's chain is exact) and latent gap (norm of the
    difference over the reference latent's norm)."""
    if not got:
        return {"answers_missing": 1.0}
    sensed_gap, latent_gap = 0.0, 0.0
    for c, sensed, latent in got.values():
        ref_sensed, ref_latent = want[c]
        sensed_gap = max(sensed_gap, float(np.abs(sensed - ref_sensed).max()))
        latent_gap = max(latent_gap, float(np.linalg.norm(latent - ref_latent)
                                           / np.linalg.norm(ref_latent)))
    return {"sensed_gap": sensed_gap, "latent_gap": latent_gap}
