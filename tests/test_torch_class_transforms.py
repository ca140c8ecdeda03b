"""The port's class transforms (SampleRandomPoints, FilterClasses,
OneHotEncode, IntegerEncode, class_mean_pos, seg_to_color) against
pointcloud_tpu.transforms on the CPU, plus two probes of the sensor
transforms: the sensor chain on under-full clouds and Normalize(dim=2).

The JAX transforms act on one cloud and are mapped over a batch with
jax.vmap; the port's act on any leading dims. Tolerance: none for filters,
encodings and gathers (comparisons, argmax, gathers at equal indices);
class_mean_pos 1e-6 relative (sums in other orders). SampleRandomPoints
draws from a torch.Generator where the JAX version draws from a PRNG key,
so its samples are compared by support and distribution, not value.
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
N_CLASSES = 5


def labelled(seed, B, N, D=4):
    """xyz in [0, 1), then integer labels in [0, 5) as floats at column 3
    (and more columns where D > 4)."""
    rng = np.random.default_rng(seed)
    pc = rng.random((B, N, D), dtype=np.float32)
    pc[..., 3] = rng.integers(0, N_CLASSES, (B, N)).astype(np.float32)
    return pc


def jmap(t, pc, mask=None):
    """A JAX single-cloud transform mapped over the batch, no key."""
    if mask is None:
        return jax.vmap(lambda p: t(p, None, None))(jnp.asarray(pc))
    return jax.vmap(lambda p, m: t(p, m, None))(jnp.asarray(pc), jnp.asarray(mask))


@pytest.mark.parametrize("whitelist", [(1,), (0, 2, 4), ()])
@pytest.mark.parametrize("masked", [False, True])
def test_filter_classes(whitelist, masked):
    pc = labelled(0, 3, 200)
    pc[0, :5, 3] = 2.7  # a fractional label truncates to 2 on both sides
    m = np.random.default_rng(1).random((3, 200)) > 0.2 if masked else None
    want_pc, want_m = jmap(jtf.FilterClasses(whitelist, seg_dim=3), pc, m)
    got_pc, got_m = ttf.FilterClasses(whitelist, seg_dim=3)(
        torch.from_numpy(pc), None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(to_np(got_pc), np.asarray(want_pc))
    np.testing.assert_array_equal(to_np(got_m), np.asarray(want_m))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_one_hot_and_integer_encode(lead):
    n = int(np.prod(lead)) if lead else 1
    pc = labelled(2, n, 50, D=6)
    pc[0, 0, 3] = 7.0  # out of range: a zero row, as jax.nn.one_hot
    want_oh, _ = jmap(jtf.OneHotEncode(N_CLASSES, seg_dim=3), pc)
    got_oh, got_m = ttf.OneHotEncode(N_CLASSES, seg_dim=3)(
        torch.from_numpy(pc.reshape(*lead, 50, 6)))
    assert got_oh.shape == (*lead, 50, 5 + N_CLASSES) and bool(got_m.all())
    np.testing.assert_array_equal(to_np(got_oh).reshape(n, 50, -1), np.asarray(want_oh))
    assert not to_np(got_oh).reshape(n, 50, -1)[0, 0, 5:].any()

    # logits with an exact tie between classes 1 and 3: the first wins
    logits = np.random.default_rng(3).standard_normal((n, 50, 3 + N_CLASSES)).astype(
        np.float32)
    logits[0, 1, 3 + 1] = logits[0, 1, 3 + 3] = 9.0
    want_int, _ = jmap(jtf.IntegerEncode(N_CLASSES, seg_dim=3), logits)
    got_int, _ = ttf.IntegerEncode(N_CLASSES, seg_dim=3)(
        torch.from_numpy(logits.reshape(*lead, 50, -1)))
    np.testing.assert_array_equal(to_np(got_int).reshape(n, 50, 4), np.asarray(want_int))
    assert to_np(got_int).reshape(n, 50, 4)[0, 1, 3] == 1.0
    # one-hot then integer gives the labels back
    back, _ = ttf.IntegerEncode(N_CLASSES, seg_dim=5)(got_oh)
    np.testing.assert_array_equal(to_np(back)[..., 5], to_np(got_oh)[..., 5:].argmax(-1))


@pytest.mark.parametrize("cls", [0, 1, 4])
def test_class_mean_pos(cls):
    pc = labelled(4, 3, 300)
    m = np.random.default_rng(5).random((3, 300)) > 0.3
    pc[2, :, 3] = np.where(pc[2, :, 3] == cls, (cls + 1) % N_CLASSES, pc[2, :, 3])
    want = jax.vmap(lambda p, q: jtf.class_mean_pos(p, cls, 3, q))(
        jnp.asarray(pc), jnp.asarray(m))
    got = ttf.class_mean_pos(torch.from_numpy(pc), cls, 3, torch.from_numpy(m))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(to_np(got)[2], 0.0)  # no such point: the origin
    one = ttf.class_mean_pos(torch.from_numpy(pc[0]), cls, 3)  # one cloud, no mask
    np.testing.assert_allclose(to_np(one), np.asarray(jtf.class_mean_pos(
        jnp.asarray(pc[0]), cls, 3)), rtol=1e-6, atol=1e-7)


def test_seg_to_color():
    colors = jscenes.cfg_scene["Cube"]["class_colors"]
    labels = labelled(6, 2, 40)[..., 3]
    want = jtf.seg_to_color(jnp.asarray(labels), colors)
    got = ttf.seg_to_color(torch.from_numpy(labels), colors)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    got_int = ttf.seg_to_color(torch.from_numpy(labels.astype(np.int64)), colors)
    np.testing.assert_array_equal(to_np(got_int), np.asarray(want))


def test_sample_random_points_support_and_distribution():
    """K draws among the valid rows only, with replacement, uniform: the
    port's and JAX's samples both stay on the valid rows, and the port's
    counts over 4,000 draws per cloud pass a chi-square test of uniformity
    (as JAX's do), over leading dims."""
    N, K = 40, 4000
    pc = labelled(7, 4, N)
    pc[..., 0] = np.arange(N, dtype=np.float32)  # column 0 names the row
    m = np.random.default_rng(8).random((4, N)) > 0.5
    gen = torch.Generator().manual_seed(0)
    got, got_m = ttf.SampleRandomPoints(K, gen)(
        torch.from_numpy(pc.reshape(2, 2, N, 4)), torch.from_numpy(m.reshape(2, 2, N)))
    assert got.shape == (2, 2, K, 4) and bool(got_m.all())
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    want = np.stack([np.asarray(jtf.SampleRandomPoints(K)(
        jnp.asarray(pc[i]), jnp.asarray(m[i]), keys[i])[0]) for i in range(4)])
    got = to_np(got).reshape(4, K, 4)
    for i in range(4):
        for sample in (got[i], want[i]):
            rows = sample[:, 0].astype(int)
            assert m[i][rows].all()  # only valid rows
            np.testing.assert_array_equal(sample, pc[i][rows])  # whole rows
            counts = np.bincount(rows, minlength=N)[m[i]]
            expected = K / m[i].sum()
            chi2 = ((counts - expected) ** 2 / expected).sum()
            # 99.9% quantile of chi-square with <= 39 degrees of freedom
            assert chi2 < 72.1, (i, chi2)
            assert (counts > 0).all()


def test_sample_random_points_fully_masked_cloud_gives_row_0():
    pc = labelled(9, 3, 30)
    m = np.ones((3, 30), bool)
    m[1] = False
    key = jax.random.PRNGKey(3)
    want = np.asarray(jtf.SampleRandomPoints(16)(jnp.asarray(pc[1]),
                                                 jnp.asarray(m[1]), key)[0])
    np.testing.assert_array_equal(want, np.repeat(pc[1, :1], 16, axis=0))
    got, _ = ttf.SampleRandomPoints(16, torch.Generator().manual_seed(1))(
        torch.from_numpy(pc), torch.from_numpy(m))
    np.testing.assert_array_equal(to_np(got)[1], want)
    assert not (to_np(got)[[0, 2]] == pc[[0, 2], :1]).all()


def test_sample_random_points_uses_its_generator_only():
    pc = torch.from_numpy(labelled(10, 2, 64))
    a = ttf.SampleRandomPoints(32, torch.Generator().manual_seed(5))(pc)[0]
    torch.manual_seed(123)  # the global generator plays no part
    b = ttf.SampleRandomPoints(32, torch.Generator().manual_seed(5))(pc)[0]
    torch.manual_seed(456)
    state = torch.random.get_rng_state()
    ttf.SampleRandomPoints(32, torch.Generator().manual_seed(6))(pc)
    assert torch.equal(a, b)
    assert torch.equal(state, torch.random.get_rng_state())
    with pytest.raises(ValueError, match="Generator"):
        ttf.SampleRandomPoints(32)(pc)


def test_sensor_chain_on_under_full_clouds():
    """Compose([FilterBBox, SampleFurthestPoints(64)]) on a batch of clouds
    with only 15-22 points inside the bbox: FPS returns 64 points, the
    valid ones first and then repeats, equal in both packages."""
    rng = np.random.default_rng(11)
    bbox = np.asarray(BBOX, np.float32)
    B, N = 4, 500
    xyz = bbox[:, 1] + 0.1 + rng.random((B, N, 3), dtype=np.float32)  # outside
    inside = [15, 18, 20, 22]
    for b, k in enumerate(inside):
        rows = rng.choice(N, k, replace=False)
        xyz[b, rows] = bbox[:, 0] + rng.random((k, 3), dtype=np.float32) * (
            bbox[:, 1] - bbox[:, 0])
    pc = np.concatenate([xyz, rng.random((B, N, 3), dtype=np.float32)], -1)
    jchain = jtf.Compose([jtf.FilterBBox(BBOX), jtf.SampleFurthestPoints(64)])
    tchain = ttf.Compose([ttf.FilterBBox(BBOX), ttf.SampleFurthestPoints(64)])
    want = np.stack([np.asarray(jchain(jnp.asarray(pc[b]))[0]) for b in range(B)])
    got, got_m = tchain(torch.from_numpy(pc))
    assert got.shape == (B, 64, 6) and bool(got_m.all())
    np.testing.assert_array_equal(to_np(got), want)
    for b, k in enumerate(inside):
        assert len(np.unique(to_np(got)[b, :, :3], axis=0)) == k
        assert bool(ttf.FilterBBox(BBOX)(got[b])[1].all())


@pytest.mark.parametrize("cls", ["Normalize", "Unnormalize"])
def test_normalize_dim_2(cls):
    """dim=2 maps x and y only; z and the features pass through."""
    pc = np.random.default_rng(12).standard_normal((2, 30, 6)).astype(np.float32)
    want, _ = jmap(getattr(jtf, cls)(BBOX, dim=2), pc)
    got, mask = getattr(ttf, cls)(BBOX, dim=2)(torch.from_numpy(pc))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(to_np(got)[..., 2:], pc[..., 2:])
    assert bool(mask.all())
