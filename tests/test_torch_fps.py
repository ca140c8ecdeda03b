"""The port's farthest-point sampling (its plain version, which CPU tensors
take) against pointcloud_tpu's two paths on the CPU: the XLA loop
(`farthest_point_sample(impl="xla")`) and the Pallas kernel in interpret
mode (`farthest_point_sample_pallas(..., interpret=True)`).

Tolerance: none. Both sides compute the same rounded fp32 operations in the
same order, and FPS is chaotic, so the indices must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import to_np

from pointcloud_tpu.ops.fps import farthest_point_sample as jfps
from pointcloud_tpu.ops.pallas_kernels import farthest_point_sample_pallas
from pointcloud_tpu_torch.ops.fps import (
    farthest_point_sample,
    farthest_point_sample_xyz,
    fps_reference,
)


def both_jax(xyz, k, mask=None):
    m = None if mask is None else jnp.asarray(mask)
    x = jnp.asarray(xyz)
    return (np.asarray(jfps(x[..., :3], k, mask=m, impl="xla")),
            np.asarray(farthest_point_sample_pallas(x, k, mask=m, interpret=True)))


def port(xyz, k, mask=None):
    return to_np(farthest_point_sample(
        torch.from_numpy(xyz), k, None if mask is None else torch.from_numpy(mask)))


@pytest.mark.parametrize("shape,k", [((3, 128, 3), 32), ((2, 300, 3), 64),
                                     ((1, 1000, 3), 100), ((2, 97, 6), 20)])
def test_matches_both_jax_paths(shape, k):
    """Random clouds; 6-dim input: only xyz drives the distances."""
    xyz = np.random.default_rng(k).random(shape, dtype=np.float32)
    got = port(xyz, k)
    xla, pallas = both_jax(xyz, k)
    assert got.dtype == np.int32 and got.shape == (shape[0], k)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


def test_masks_and_an_invalid_first_point():
    rng = np.random.default_rng(1)
    xyz = rng.random((3, 96, 3), dtype=np.float32)
    mask = rng.random((3, 96)) > 0.3
    mask[1, :5] = False  # starts at the first valid point, 5
    mask[1, 5] = True
    got = port(xyz, 24, mask)
    xla, pallas = both_jax(xyz, 24, mask)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    assert got[1, 0] == 5
    assert np.take_along_axis(mask, got.astype(np.int64), 1).all()


def test_under_full_cloud_repeats_valid_points():
    rng = np.random.default_rng(2)
    xyz = rng.random((2, 40, 3), dtype=np.float32)
    mask = np.zeros((2, 40), bool)
    mask[0, [3, 7, 11]] = True
    mask[1, 20:] = True
    got = port(xyz, 25, mask)
    xla, pallas = both_jax(xyz, 25, mask)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    assert set(got[0].tolist()) == {3, 7, 11}
    assert len(set(got[1].tolist())) == 20


def test_planted_duplicates_break_ties_to_the_lowest_index():
    """Exact copies of points and a symmetric lattice: many equal distances,
    each resolved to the lowest index on every path."""
    rng = np.random.default_rng(3)
    xyz = rng.random((2, 64, 3), dtype=np.float32)
    xyz[:, 40:] = xyz[:, :24]  # points 40.. duplicate points 0..23
    grid = np.stack(np.meshgrid(*[np.arange(4, dtype=np.float32)] * 3,
                                indexing="ij"), -1).reshape(1, 64, 3) / 4
    xyz = np.concatenate([xyz, grid], 0)
    got = port(xyz, 40)
    xla, pallas = both_jax(xyz, 40)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    assert not (got[:2] >= 40).any()  # a duplicate never beats its original


def test_fully_masked_cloud_gives_zeros():
    """No valid point: the port and the XLA path give 0 in every slot; the
    TPU kernel writes N (out of range) in slot 0 and 0 after it."""
    rng = np.random.default_rng(4)
    xyz = rng.random((2, 50, 3), dtype=np.float32)
    mask = np.ones((2, 50), bool)
    mask[1] = False
    got = port(xyz, 8, mask)
    xla, pallas = both_jax(xyz, 8, mask)
    np.testing.assert_array_equal(got, xla)
    assert (got[1] == 0).all()
    assert pallas[1, 0] == 50 and (pallas[1, 1:] == 0).all()
    np.testing.assert_array_equal(got[0], pallas[0])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    xyz = torch.rand(2, 70, 3)
    before = farthest_point_sample.launches
    idx = farthest_point_sample(xyz, 9)
    assert farthest_point_sample.launches == before  # no kernel on the CPU
    assert torch.equal(idx, fps_reference(xyz, 9))
    pts, idx2 = farthest_point_sample_xyz(xyz, 9)
    assert torch.equal(idx, idx2)
    assert torch.equal(pts, xyz[torch.arange(2)[:, None], idx.long()])
    with pytest.raises(ValueError):
        farthest_point_sample(torch.rand(2, 70, 2), 4)
    with pytest.raises(ValueError):
        farthest_point_sample(xyz, 4, mask=torch.ones(2, 71, dtype=torch.bool))
