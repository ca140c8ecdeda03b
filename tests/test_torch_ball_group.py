"""The port's ball grouping (its plain version, which CPU tensors take)
against pointcloud_tpu on the CPU: the Pallas kernel in interpret mode
(`grouped_gather_ball(..., interpret=True)`, which needs k % 8 == 0) and
the XLA composition `ball_query` + `index_points` (any k). Also the port's
`ball_query` and `index_points` against the JAX package's.

Tolerances: idx and valid equal; feature channels bit-equal; centred xyz
bit-equal in fp32. In bf16 the TPU kernel carries xyz as split-bf16 hi + lo
(16 significant bits), the port exact fp32; both subtract the centroid and
round once to bf16, so the two differ by at most one bf16 ulp of the result
plus the split's residual (2^-17 of the coordinate, under 1e-5 here).
Inputs keep every point's float64 squared distance more than 1e-5
(relative) away from r^2, so the XLA path's matmul expansion and the direct
differences agree on membership.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import ball_margin as margin
from torch_port_utils import to_np

from pointcloud_tpu.ops import geometry as jgeo
from pointcloud_tpu.ops.pallas_kernels import grouped_gather_ball
from pointcloud_tpu_torch.ops import geometry as tgeo
from pointcloud_tpu_torch.ops.ball_group import ball_group, ball_group_reference

MARGIN = 1e-5  # fp32 round-off of either formula is ~1e-6 of r^2 here


def case(seed, B, N, S, F, far=0):
    """Unit-cube clouds, centroids on every (N // S)-th point, the last
    `far` centroids moved far outside (their balls are empty), masks with
    ~1/3 of the points invalid."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((B, N, 3), dtype=np.float32)
    feats = rng.standard_normal((B, N, F)).astype(np.float32)
    cents = xyz[:, :: N // S][:, :S].copy()
    if far:
        cents[:, S - far:] += 5.0
    mask = rng.random((B, N)) > 0.33
    return xyz, feats, cents, mask


def tpu_kernel(xyz, feats, cents, mask, k, radius, dtype=jnp.float32):
    pen = jnp.where(jnp.asarray(mask)[..., None], 0.0, jnp.float32(1e9))
    g, i, v = grouped_gather_ball(jnp.asarray(xyz), jnp.asarray(feats).astype(dtype),
                                  jnp.asarray(cents), pen, k, radius, True)
    return np.asarray(g.astype(jnp.float32)), np.asarray(i), np.asarray(v) > 0.5


def port(xyz, feats, cents, mask, k, radius, dtype=torch.float32):
    g, i, v = ball_group(torch.from_numpy(xyz),
                         None if feats is None else torch.from_numpy(feats).to(dtype),
                         torch.from_numpy(cents),
                         None if mask is None else torch.from_numpy(mask), k, radius)
    return g, to_np(i), to_np(v)


@pytest.mark.parametrize("k,radius", [(8, 0.3), (16, 0.35), (32, 0.5)])
def test_fp32_matches_the_tpu_kernel(k, radius):
    xyz, feats, cents, mask = case(k, 2, 128, 16, 5, far=2)
    assert margin(xyz, cents, radius) > MARGIN
    g, i, v = port(xyz, feats, cents, mask, k, radius)
    tg, ti, tv = tpu_kernel(xyz, feats, cents, mask, k, radius)
    assert g.dtype == torch.float32 and g.shape == (2, 16, k, 8)
    np.testing.assert_array_equal(i, ti)
    np.testing.assert_array_equal(v, tv)
    np.testing.assert_array_equal(to_np(g), tg)
    # empty balls: every slot point 0, invalid, [xyz[0] - c | feats[0]]
    assert (i[:, -2:] == 0).all() and not v[:, -2:].any()
    np.testing.assert_array_equal(to_np(g)[:, -1, :, 3:],
                                  np.broadcast_to(feats[:, None, 0], (2, k, 5)))
    assert mask[np.arange(2)[:, None, None], i][v].all()  # masked points stay out


@pytest.mark.parametrize("k", [8, 24])
def test_bf16_within_one_ulp_of_the_tpu_kernel(k):
    xyz, feats, cents, mask = case(10 + k, 2, 128, 16, 4, far=1)
    assert margin(xyz, cents, 0.35) > MARGIN
    g, i, v = port(xyz, feats, cents, mask, k, 0.35, torch.bfloat16)
    tg, ti, tv = tpu_kernel(xyz, feats, cents, mask, k, 0.35, jnp.bfloat16)
    assert g.dtype == torch.bfloat16
    g = to_np(g.float())
    np.testing.assert_array_equal(i, ti)
    np.testing.assert_array_equal(v, tv)
    np.testing.assert_array_equal(g[..., 3:], tg[..., 3:])  # features exact
    mag = np.maximum(np.abs(g[..., :3]), np.abs(tg[..., :3]))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert (np.abs(g[..., :3] - tg[..., :3]) <= ulp + 1e-5).all()
    # the port's xyz channels are the fp32 centred values rounded once
    exact = torch.from_numpy(xyz[np.arange(2)[:, None, None], i]
                             - cents[:, :, None, :]).bfloat16().float()
    np.testing.assert_array_equal(g[..., :3], to_np(exact))


@pytest.mark.parametrize("k", [5, 12, 40])
@pytest.mark.parametrize("masked", [False, True])
def test_matches_the_xla_composition_at_any_k(k, masked):
    """ball_query + index_points + centring, as sample_and_group composes
    them off the TPU, at k not divisible by 8 (and k = 40 > most balls)."""
    xyz, feats, cents, mask = case(20 + k, 2, 200, 25, 3, far=1)
    mask = mask if masked else None
    assert margin(xyz, cents, 0.3) > MARGIN
    g, i, v = port(xyz, feats, cents, mask, k, 0.3)
    jm = None if mask is None else jnp.asarray(mask)
    ji, jv = jgeo.ball_query(0.3, k, jnp.asarray(xyz), jnp.asarray(cents), mask=jm)
    gx = jgeo.index_points(jnp.asarray(xyz), ji) - jnp.asarray(cents)[:, :, None]
    want = np.concatenate([np.asarray(gx),
                           np.asarray(jgeo.index_points(jnp.asarray(feats), ji))], -1)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(to_np(g), want)
    ti, tv = tgeo.ball_query(0.3, k, torch.from_numpy(xyz), torch.from_numpy(cents),
                             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(to_np(tv), np.asarray(jv))


def test_index_points_and_no_features():
    xyz, feats, cents, mask = case(30, 2, 64, 8, 2)
    idx = np.random.default_rng(0).integers(0, 64, (2, 8, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        to_np(tgeo.index_points(torch.from_numpy(feats), torch.from_numpy(idx))),
        np.asarray(jgeo.index_points(jnp.asarray(feats), jnp.asarray(idx))))
    g, i, v = port(xyz, None, cents, mask, 6, 0.3)
    assert g.dtype == torch.float32 and g.shape == (2, 8, 6, 3)
    full, fi, fv = port(xyz, feats, cents, mask, 6, 0.3)
    np.testing.assert_array_equal(to_np(g), to_np(full[..., :3]))
    np.testing.assert_array_equal(i, fi)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    xyz, feats, cents, mask = case(31, 1, 64, 8, 2)
    args = [torch.from_numpy(a) for a in (xyz, feats, cents, mask)]
    before = ball_group.launches
    got = ball_group(*args, 8, 0.3)
    assert ball_group.launches == before
    for a, b in zip(got, ball_group_reference(*args, 8, 0.3)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ball_group(args[0], args[1], args[2], args[3], 0, 0.3)
    with pytest.raises(ValueError):
        ball_group(torch.rand(1, 64, 4), args[1], args[2], args[3], 8, 0.3)
