"""The port's PointCloudSensor and the sensor chain at full size against the
JAX package's on the CPU: the synthetic scenes' 16,384-point raw cloud under
FilterBBox's mask, FPS to 2,048 points (the route `fps_plan` gives the card
at this shape), a mask with points outside the bbox, RS, and the numpy draw
each observation makes.

Tolerance: the same points in the same order, but at an exact fp32 tie.
Both FPS versions compute each squared distance as ((dx*dx + dy*dy) +
dz*dz), but XLA on the CPU contracts it into fused multiply-adds, so where
two candidates' running distances are equal in separately rounded fp32 the
JAX package may take the later one, and every later pick differs. The test
finds the first differing pick and holds: every earlier pick equal, the two
candidates' distances equal in separately rounded fp32, and the port's pick
the lower index (the TPU kernel's rule). The Cube scene's first frame at
seed 0 has such a tie at pick 1975 (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)

from pointcloud_tpu import transforms as jtf
from pointcloud_tpu.envs import envs as jenvs
from pointcloud_tpu.envs import synthetic as jsynthetic
from pointcloud_tpu.ops.fps import farthest_point_sample as jfps
from pointcloud_tpu.vision.pc_sensor import PointCloudSensor as JSensor
from pointcloud_tpu_torch import transforms as ttf
from pointcloud_tpu_torch.envs import envs as tenvs
from pointcloud_tpu_torch.ops.fps import fps_plan, fps_reference
from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor as TSensor

K = 2048


def running_distances(xyz, picks):
    """The running minimum squared distance to `picks` in separately rounded
    fp32, ((dx*dx + dy*dy) + dz*dz), as the port's FPS computes it."""
    x = xyz.astype(np.float32)
    mind = np.full(len(x), np.float32(1e10), np.float32)
    for p in picks:
        d = x - x[p]
        mind = np.minimum(mind, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
    return mind


def first_tie(xyz, mask, got, want):
    """Hold the port's picks `got` to the JAX package's `want` (see the
    module docstring); the index of the first differing pick, or None."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.nonzero(got != want)[0]
    if not len(diff):
        return None
    k = int(diff[0])
    mind = running_distances(xyz, got[:k])
    mind[~mask] = -1
    assert mind[got[k]] == mind[want[k]] == mind.max(), (k, mind[got[k]], mind[want[k]])
    assert got[k] < want[k]
    return k


def render(scene, seed):
    sim = (jsynthetic.SyntheticPegScene(seed=seed) if scene == "PegInHole"
           else jsynthetic.SyntheticScene(scene, seed=seed))
    points, rgb, labels = sim.render_points()
    return sim.cfg, np.concatenate([points, rgb, labels[:, None].astype(np.float32)], 1)


def bbox_mask(pc, bbox):
    bbox = np.asarray(bbox, np.float32)
    return ((pc[:, :3] >= bbox[:, 0]) & (pc[:, :3] <= bbox[:, 1])).all(1)


def test_fps_route_at_the_sensor_shape():
    """B=1 x 16,384 points: the cluster route over two blocks."""
    plan = fps_plan(1, 16384)
    assert plan.route == "cluster" and plan.cluster == 2 and plan.per_block == 8192


def test_cube_frame_tie_is_recorded():
    """The Cube scene's first frame at seed 0: picks 0-1974 equal, pick
    1975 an exact fp32 tie between points 6105 (the port's) and 13543 (the
    JAX package's), both at 0.00044790935."""
    cfg, pc = render("Cube", 0)
    mask = bbox_mask(pc, cfg["bbox"])
    got = fps_reference(torch.from_numpy(pc[None, :, :3]), K,
                        torch.from_numpy(mask[None]))[0].numpy()
    want = np.asarray(jfps(jnp.asarray(pc[None, :, :3]), K, mask=jnp.asarray(mask[None]),
                           impl="xla"))[0]
    assert first_tie(pc[:, :3], mask, got, want) == 1975
    assert (got[1975], want[1975]) == (6105, 13543)
    mind = running_distances(pc[:, :3], got[:1975])
    assert mind[6105] == mind[13543] == np.float32(0.00044790935)


@pytest.mark.parametrize("scene,seed,outside", [("Cube", 1, 0.0), ("Table", 2, 0.3),
                                                ("PegInHole", 3, 0.1)])
def test_sensor_chain_at_full_size(scene, seed, outside):
    """FilterBBox -> SampleFurthestPoints(2048) on a 16,384-point raw cloud,
    a share of its points moved outside the bbox: the chain's cloud against
    the JAX package's chain; every pick inside the bbox."""
    cfg, pc = render(scene, seed)
    rng = np.random.default_rng(seed)
    out = rng.random(len(pc)) < outside
    pc[out, rng.integers(0, 3, out.sum())] += 10.0
    mask = bbox_mask(pc, cfg["bbox"])
    assert mask.sum() == len(pc) - out.sum()
    tchain = ttf.sensor_chain(cfg["bbox"], K, "FPS", 0, "cpu")
    got, got_mask = tchain(torch.from_numpy(pc))
    jchain = jtf.Compose([jtf.FilterBBox(cfg["bbox"]), jtf.SampleFurthestPoints(K)])
    want, _ = jax.jit(lambda x: jchain(x, key=jax.random.PRNGKey(0)))(jnp.asarray(pc))
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == (K, 7) and bool(got_mask.all())
    assert bbox_mask(got, cfg["bbox"]).all()
    rows = {r.tobytes(): i for i, r in enumerate(pc)}
    gi = np.array([rows[r.tobytes()] for r in got])
    wi = np.array([rows[r.tobytes()] for r in want])
    k = first_tie(pc[:, :3], mask, gi, wi)
    assert k is None or k > K // 2  # ties come late, at small distances


def test_sensor_random_sampling():
    """RS: every draw a valid row, the classes drawn in the shares the valid
    rows hold (as the JAX package's categorical draws them), one seed one
    draw."""
    cfg, pc = render("Cube", 4)
    pc[:4000, 0] += 10.0  # outside the bbox
    mask = bbox_mask(pc, cfg["bbox"])
    n = 8192
    got = ttf.sensor_chain(cfg["bbox"], n, "RS", 11, "cpu")(torch.from_numpy(pc))[0].numpy()
    again = ttf.sensor_chain(cfg["bbox"], n, "RS", 11, "cpu")(torch.from_numpy(pc))[0].numpy()
    other = ttf.sensor_chain(cfg["bbox"], n, "RS", 12, "cpu")(torch.from_numpy(pc))[0].numpy()
    jchain = jtf.Compose([jtf.FilterBBox(cfg["bbox"]), jtf.SampleRandomPoints(n)])
    want = np.asarray(jchain(jnp.asarray(pc), key=jax.random.PRNGKey(11))[0])
    np.testing.assert_array_equal(got, again)
    assert not np.array_equal(got, other)
    valid = {r.tobytes() for r in pc[mask]}
    assert all(r.tobytes() in valid for r in got)
    assert all(r.tobytes() in valid for r in want)
    shares = np.bincount(pc[mask, 6].astype(int), minlength=5) / mask.sum()
    for drawn in (got, want):
        np.testing.assert_allclose(np.bincount(drawn[:, 6].astype(int), minlength=5) / n,
                                   shares, atol=0.02)


def test_env_sensor_observations_at_full_size():
    """RoboPush with the PointCloudSensor (2,048 points, segmentation),
    reset and 2 steps: the raw clouds bit-equal, each sensed cloud held by
    the tie rule against the JAX sensor's, and one draw of the sensor's
    numpy generator per observation."""
    jenv = jenvs.RoboPush(sensor=JSensor, require_segmentation=True)
    tenv = tenvs.RoboPush(sensor=TSensor, require_segmentation=True, device="cpu")
    raw = {}

    def record(env, name):
        capture = env.backend.capture_pointcloud

        def wrapped(features=("rgb",)):
            pts, feats = capture(features=features)
            raw.setdefault(name, []).append(np.concatenate(
                [pts] + [feats[f] for f in features], 1))
            return pts, feats
        env.backend.capture_pointcloud = wrapped

    record(jenv, "jax")
    record(tenv, "port")
    sensed = {"jax": [], "port": []}
    for name, env in (("jax", jenv), ("port", tenv)):
        env.reset(seed=4)
        sensed[name].append(env.observation)
        for _ in range(2):
            env.step(np.full(4, 0.5, np.float32))
            sensed[name].append(env.observation)
    assert len(raw["port"]) == len(raw["jax"]) == 4  # goal, reset, 2 steps
    for a, b in zip(raw["port"], raw["jax"]):
        np.testing.assert_array_equal(a, b)
    bbox = tenv.bbox
    for pc, got, want in zip(raw["port"][1:], sensed["port"], sensed["jax"]):
        assert got["points"].shape == (K, 3) and got["segmentation"].shape == (K, 1)
        rows = {r.tobytes(): i for i, r in enumerate(pc)}

        def picks(obs):
            cols = np.concatenate([obs["points"], obs["rgb"], obs["segmentation"]], 1)
            return np.array([rows[r.astype(np.float32).tobytes()] for r in cols])

        first_tie(pc[:, :3], bbox_mask(pc, bbox), picks(got), picks(want))
        np.testing.assert_array_equal(got["cube_pos"], want["cube_pos"])
    rng = np.random.default_rng(0)
    for _ in range(4):
        rng.integers(0, 2**31)
    assert tenv.sensor._rng.bit_generator.state == rng.bit_generator.state
    assert jenv.sensor._rng.bit_generator.state == rng.bit_generator.state
