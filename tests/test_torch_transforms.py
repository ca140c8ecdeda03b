"""The port's sensor transforms (FilterBBox, SampleFurthestPoints, Compose)
against pointcloud_tpu.transforms on the CPU. The JAX transforms act on one
cloud and are mapped over a batch with jax.vmap; the port's act on any
leading dims.

Tolerance: none. Filtering is a comparison and sampling a gather at equal
FPS indices (tests/test_torch_fps.py), so clouds and masks are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu import transforms as jtf
from pointcloud_tpu.envs import scenes as jscenes
from pointcloud_tpu_torch import transforms as ttf

BBOX = jscenes.cfg_scene["Cube"]["bbox"]


def sensor_clouds(seed, B, N):
    """xyz + rgb drawn in a box 1.3x the scene's bbox, so that ~half of the
    points fall outside it."""
    rng = np.random.default_rng(seed)
    bbox = np.asarray(BBOX, np.float32)
    mid, half = bbox.mean(1), (bbox[:, 1] - bbox[:, 0]) / 2 * 1.3
    xyz = mid + (2 * rng.random((B, N, 3), dtype=np.float32) - 1) * half
    return np.concatenate([xyz, rng.random((B, N, 3), dtype=np.float32)], -1)


def test_filter_bbox():
    pc = sensor_clouds(0, 2, 300)
    pc[0, 0, :3] = np.asarray(BBOX, np.float32)[:, 0]  # on the faces: inside
    pc[0, 1, :3] = np.asarray(BBOX, np.float32)[:, 1]
    m = np.random.default_rng(1).random((2, 300)) > 0.1
    want_pc, want_m = jax.vmap(lambda p, q: jtf.FilterBBox(BBOX)(p, q))(
        jnp.asarray(pc), jnp.asarray(m))
    got_pc, got_m = ttf.FilterBBox(BBOX)(torch.from_numpy(pc), torch.from_numpy(m))
    np.testing.assert_array_equal(to_np(got_pc), np.asarray(want_pc))
    np.testing.assert_array_equal(to_np(got_m), np.asarray(want_m))
    assert 0.2 < to_np(got_m).mean() < 0.8 and bool(got_m[0, 0] & got_m[0, 1]) == bool(m[0, 0] & m[0, 1])


@pytest.mark.parametrize("lead", [(), (2,), (2, 2)])
def test_sample_furthest_points_over_leading_dims(lead):
    n = int(np.prod(lead)) if lead else 1
    pc = sensor_clouds(2, n, 400)
    m = np.random.default_rng(3).random((n, 400)) > 0.3
    want = [jtf.SampleFurthestPoints(64)(jnp.asarray(pc[i]), jnp.asarray(m[i]))
            for i in range(n)]
    got_pc, got_m = ttf.SampleFurthestPoints(64)(
        torch.from_numpy(pc.reshape(*lead, 400, 6)),
        torch.from_numpy(m.reshape(*lead, 400)))
    assert got_pc.shape == (*lead, 64, 6) and bool(got_m.all())
    np.testing.assert_array_equal(to_np(got_pc).reshape(n, 64, 6),
                                  np.stack([np.asarray(w[0]) for w in want]))


def test_the_sensor_chain():
    """Compose([FilterBBox, SampleFurthestPoints]) on one cloud, as the
    sensor runs it each env step (scaled down from 196,608 to 4,096 points
    and from 2,048 to 256 samples)."""
    pc = sensor_clouds(4, 1, 4096)[0]
    jchain = jtf.Compose([jtf.FilterBBox(BBOX), jtf.SampleFurthestPoints(256)])
    tchain = ttf.Compose([ttf.FilterBBox(BBOX), ttf.SampleFurthestPoints(256)])
    want, want_m = jchain(jnp.asarray(pc))
    got, got_m = tchain(torch.from_numpy(pc))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(to_np(got_m), np.asarray(want_m))
    inside = ttf.FilterBBox(BBOX)(got)[1]
    assert bool(inside.all())  # every sample passed the filter
