"""`ball_group_plan` and the run store's chunk walk, on the CPU.

csrc/ball_group.cu stages a cloud once a block in shared memory (each
warp's slots and tile, the points as (x, y, z, pen), the features where
they fit) and serves `per_block` centroids of that cloud with 32 warps, a
warp two at a time. Clouds
whose points do not fit take the global route. Held here at every driven
shape (PointNet2's SA1 / SA2 at bench.py's B=256, the EMD paths' B=64,
`encode` on one cloud); over a sweep of shapes, that the blocks cover every
centroid once, with at least 32 a block where S allows, and that the shared
memory as the kernel lays it out fits the card. Shapes no launch takes
raise.

A centroid's output run of k * (3+F) elements is written in 16-byte chunks
aligned to the output's 16-byte boundaries: a lane's first chunk starts at
(slot, channel) = divmod(element, 3+F), its next one a fixed step on.
`chunk_walk` mirrors that walk; it covers every element of a run once with
the right (slot, channel) at every alignment, and the run it assembles from
the JAX package's idx (`grouped_gather_ball` in interpret mode) is
bit-equal to that kernel's grouped rows in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_tpu.ops.pallas_kernels import grouped_gather_ball
from pointcloud_tpu_torch.ops import ball_group, ball_group_plan, ball_group_reference
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT

BF, F32 = torch.bfloat16, torch.float32

# name: (B, N, S, k, F, dtype) -> (route, per_block, blocks, tile, stage_feats,
# smem)
DRIVEN = {
    "PointNet2 SA1": ((256, 2048, 512, 32, 3, BF), ("shared", 256, 2, 400, True, 66048)),
    "PointNet2 SA2": ((256, 512, 128, 64, 128, BF),
                      ("shared", 128, 1, 1024, True, 188416)),
    "SA1 at B=64": ((64, 2048, 512, 32, 3, BF), ("shared", 103, 5, 400, True, 66048)),
    "SA2 at B=64": ((64, 512, 128, 64, 128, BF), ("shared", 43, 3, 1024, True, 188416)),
    "encode SA1": ((1, 2048, 512, 32, 3, F32), ("shared", 32, 16, 784, True, 90624)),
    "encode SA2": ((1, 512, 128, 64, 128, F32), ("shared", 32, 4, 1024, False, 57344)),
}


def layout(N, k, F, esize, shared, feats):
    """csrc/ball_group.cu's shared memory: 32 warps' slots for two centroids
    rounded to 16 bytes, 32 warps' tiles (the run and 16 bytes, at most 1
    KB, at least a row and 16 bytes), 16 bytes a staged point, the staged
    features."""
    out = 4 if F == 0 else esize
    tile = max(min(1024, (-(-k * (3 + F) * out // 16) + 1) * 16),
               (-(-(3 + F) * out // 16) + 1) * 16)
    return (-(-64 * k * 4 // 16) * 16 + 32 * tile + (16 * N if shared else 0)
            + (N * F * esize if feats else 0))


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_shapes_take_their_launch(name):
    shape, want = DRIVEN[name]
    p = ball_group_plan(*shape)
    assert p.threads == 1024
    assert (p.route, p.per_block, p.blocks, p.tile, p.stage_feats, p.smem) == want
    assert p.smem <= SMEM_LIMIT


def test_sa1_stages_each_cloud_for_many_centroids():
    """The first version staged a cloud for every 16 centroids (32 blocks a
    cloud at SA1); now a block serves 256 of its 512."""
    p = ball_group_plan(256, 2048, 512, 32, 3, BF)
    assert p.per_block > 16 and p.blocks == 2


@pytest.mark.parametrize("N", [1, 512, 2048, 5000, 14200, 100000])
@pytest.mark.parametrize("S,k", [(1, 1), (16, 8), (40, 5), (128, 64), (512, 32),
                                 (1000, 200)])
@pytest.mark.parametrize("F,dtype", [(0, F32), (3, BF), (128, BF), (128, F32)])
@pytest.mark.parametrize("B", [1, 256])
def test_geometry_covers_every_centroid_once(B, N, S, k, F, dtype):
    p = ball_group_plan(B, N, S, k, F, dtype)
    esize = 2 if dtype == BF else 4
    assert (p.blocks - 1) * p.per_block < S <= p.blocks * p.per_block
    assert p.per_block >= min(S, 32)
    shared = p.route == "shared"
    assert shared == (layout(N, k, F, esize, True, False) <= SMEM_LIMIT)
    assert p.stage_feats == (shared and F > 0
                             and layout(N, k, F, esize, True, True) <= SMEM_LIMIT)
    assert p.smem == layout(N, k, F, esize, shared, p.stage_feats) <= SMEM_LIMIT


@pytest.mark.parametrize("B,N,S,k,F", [(0, 10, 4, 2, 3), (65536, 10, 4, 2, 3),
                                       (1, 0, 4, 2, 3), (1, 10, 0, 2, 3),
                                       (1, 10, 4, 0, 3), (1, 10, 4, 2, -1)])
def test_shapes_no_launch_takes_are_refused(B, N, S, k, F):
    with pytest.raises(ValueError):
        ball_group_plan(B, N, S, k, F, F32)


def test_k_past_the_shared_slots_takes_the_idx_slots():
    """k = 1,000 (past the 780 slots 32 warps hold beside their tiles), on
    10 points: the slots move to the idx output and the small cloud is
    staged; the shared memory holds the tiles, points and features only."""
    p = ball_group_plan(1, 10, 4, 1000, 3, F32)
    assert (p.route, p.stage_feats) == ("shared-idx", True)
    assert p.smem == 32 * 1024 + 16 * 10 + 10 * 3 * 4


def test_other_dtypes_are_refused():
    with pytest.raises(TypeError):
        ball_group_plan(1, 10, 4, 2, 3, torch.float16)


def chunk_walk(k, c, head, per):
    """Every chunk of one run as store_run walks it: (first element, [(e,
    slot, channel) of its elements inside the run]), lane by lane. `head`
    elements come before the run's first 16-byte boundary; a chunk holds
    `per` elements."""
    total = k * c
    base = head - per if head > 0 else 0
    chunks = -(-(total - base) // per)
    jd, cd = divmod(32 * per, c)
    out = []
    for lane in range(32):
        e0 = base + lane * per
        j, ch = divmod(e0, c)  # floor division, as the kernel's
        for _ in range(lane, chunks, 32):
            jj, cc, elems = j, ch, []
            for i in range(per):
                if 0 <= e0 + i < total:
                    elems.append((e0 + i, jj, cc))
                cc += 1
                if cc == c:
                    cc, jj = 0, jj + 1
            out.append((e0, elems))
            e0, j, ch = e0 + 32 * per, j + jd, ch + cd
            if ch >= c:
                ch, j = ch - c, j + 1
    return out


@pytest.mark.parametrize("k,c", [(1, 3), (5, 3), (8, 4), (32, 6), (24, 7), (64, 131),
                                 (17, 259), (3, 1000)])
@pytest.mark.parametrize("per", [4, 8])
def test_chunk_walk_covers_each_element_once(k, c, per):
    for head in range(per):
        walk = chunk_walk(k, c, head, per)
        elems = sorted(e for _, es in walk for e in es)
        assert [e for e, _, _ in elems] == list(range(k * c))
        assert all((j, ch) == divmod(e, c) for e, j, ch in elems)
        # every chunk starts on a 16-byte boundary of the output
        assert all((e0 - head) % per == 0 for e0, _ in walk)


@pytest.mark.parametrize("head", [0, 1, 2, 3])
def test_chunk_walk_assembles_the_tpu_kernels_rows(head):
    """fp32 runs (4 elements a chunk) placed `head` elements before a
    16-byte boundary, built element by element from the walk out of the
    points, the centroids and the JAX kernel's idx, equal the JAX kernel's
    grouped rows bit for bit."""
    rng = np.random.default_rng(head)
    B, N, S, k, F, radius = 2, 128, 16, 8, 5, 0.3
    xyz = rng.random((B, N, 3), dtype=np.float32)
    feats = rng.standard_normal((B, N, F)).astype(np.float32)
    cents = xyz[:, :: N // S][:, :S].copy()
    pen = jnp.zeros((B, N, 1), jnp.float32)
    g, i, _ = grouped_gather_ball(jnp.asarray(xyz), jnp.asarray(feats),
                                  jnp.asarray(cents), pen, k, radius, True)
    g, i = np.asarray(g), np.asarray(i)
    c = 3 + F
    walk = chunk_walk(k, c, head, 4)
    for b in range(B):
        for s in range(S):
            run = np.full(k * c, np.nan, np.float32)
            for _, elems in walk:
                for e, j, ch in elems:
                    p = i[b, s, j]
                    run[e] = (np.float32(xyz[b, p, ch] - cents[b, s, ch]) if ch < 3
                              else feats[b, p, ch - 3])
            np.testing.assert_array_equal(run.reshape(k, c), g[b, s])


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    xyz = torch.from_numpy(rng.random((2, 300, 3), dtype=np.float32))
    feats = torch.from_numpy(rng.standard_normal((2, 300, 7)).astype(np.float32))
    cents = xyz[:, ::10].contiguous()
    before = ball_group.launches
    got = ball_group(xyz, feats, cents, None, 12, 0.3)
    want = ball_group_reference(xyz, feats, cents, None, 12, 0.3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ball_group.launches == before


@pytest.mark.parametrize("k", [780, 781, 1024, 4096])
@pytest.mark.parametrize("N", [10, 2048, 20000])
@pytest.mark.parametrize("F,dtype", [(0, F32), (3, BF), (128, F32)])
def test_large_k_plans_cover_every_centroid_once(k, N, F, dtype):
    """At and past the 780 slots 32 warps hold: the slots move to the idx
    output exactly where the slots and tiles pass the shared memory, and
    the shared memory is then the layout without the slots."""
    p = ball_group_plan(2, N, 512, k, F, dtype)
    esize = 2 if dtype == BF else 4
    slots = -(-64 * k * 4 // 16) * 16
    idx_slots = layout(0, k, F, esize, False, False) > SMEM_LIMIT
    assert p.route.endswith("-idx") == idx_slots == (k > 780)
    assert (p.blocks - 1) * p.per_block < 512 <= p.blocks * p.per_block
    shared = p.route.startswith("shared")
    gone = slots if idx_slots else 0
    assert shared == (layout(N, k, F, esize, True, False) - gone <= SMEM_LIMIT)
    assert p.smem == layout(N, k, F, esize, shared, p.stage_feats) - gone <= SMEM_LIMIT


@pytest.mark.parametrize("k", [300, 1024])
def test_large_k_sample_and_group_matches_the_jax_package(k):
    """The port's SetAbstraction grouping (ball_group's plain version) past
    the TPU kernel's BALL_MAX_K = 256, where the JAX package takes its XLA
    ball_query: centroids, grouped rows and masks equal on a masked cloud
    of 1,200 points (the JAX package's ball_query takes no k above N)."""
    from pointcloud_tpu.ops import geometry as jgeo
    from pointcloud_tpu.ops.pallas_kernels import BALL_MAX_K
    from pointcloud_tpu_torch.ops import geometry as tgeo
    from torch_port_utils import ball_margin, fps_centroids

    assert k > BALL_MAX_K
    rng = np.random.default_rng(k + 2)
    xyz = rng.random((2, 1200, 3), dtype=np.float32)
    feats = rng.standard_normal((2, 1200, 4)).astype(np.float32)
    mask = rng.random((2, 1200)) > 0.2
    assert ball_margin(xyz, fps_centroids(xyz, 16, mask), 0.6) > 1e-5
    got = tgeo.sample_and_group(16, 0.6, k, torch.from_numpy(xyz),
                                torch.from_numpy(feats), mask=torch.from_numpy(mask))
    want = jgeo.sample_and_group(16, 0.6, k, jnp.asarray(xyz), jnp.asarray(feats),
                                 mask=jnp.asarray(mask))
    assert got[1].shape == (2, 16, k, 7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[2].sum(-1).max()) > 256  # balls fuller than the TPU kernel's k
