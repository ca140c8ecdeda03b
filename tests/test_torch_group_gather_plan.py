"""`group_gather_plan`, the staged selection and the row mover's run walks,
on the CPU.

csrc/group_gather.cu stages a cloud once a block of 32 warps (dynamic
shared memory: each warp's mbarrier, slots and tile, the points as (x, y,
z, pen)) and serves `per_block` centroids of it, a warp one or two at a
time (`ball_select::select_staged`); clouds whose points do not fit take
the global route. A centroid's xyz rows and feature rows leave as two runs
through the warp's tile (csrc/row_move.cuh): 16-byte feature rows by bulk
copies, the rest as words in 16-byte stores. Held here: the plan at every
driven shape (the MSG autoencoder's six branches at B=32, `encode` on one
cloud, the fp32 card-vs-CPU check at B=2 x 1024); over a sweep of shapes,
that the blocks cover every centroid once and that the shared memory as the
kernel lays it out fits the card; both sides of the shared-memory switch;
shapes no launch takes raise.

`staged_select` mirrors select_staged's sweep (two centroids a warp, four
batches of 32 points a round, slots placed by ballot ranks); it and the
plain version, and the runs the walks (`bulk_pieces`, `word_walk` in
tests/torch_port_utils.py) assemble from its slots, are held bit-equal to
the JAX package's kernel (`grouped_gather` in interpret mode, transposed
from its (B, k, C, S) layout) on idx, valid and the fp32 rows: masks, a
fully masked cloud, an empty ball, k above the in-ball count and above N.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import assemble_bulk, assemble_words

from pointcloud_tpu.ops.pallas_kernels import grouped_gather
from pointcloud_tpu_torch.ops import group_gather, group_gather_plan, group_gather_reference
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT
from pointcloud_tpu_torch.ops.geometry import penalised_sqdist

# name: (B, N, S, k, row bytes, word) -> (route, threads, cents, per_block,
# blocks, tile, bulk, smem)
DRIVEN = {
    "MSG level 1, r=0.1": ((32, 2048, 512, 16, 6, 2),
                           ("shared", 1024, 2, 64, 8, 224, False, 44288)),
    "MSG level 1, r=0.2": ((32, 2048, 512, 32, 6, 2),
                           ("shared", 1024, 2, 64, 8, 416, False, 54528)),
    "MSG level 1, r=0.4": ((32, 2048, 512, 128, 6, 2),
                           ("shared", 1024, 1, 64, 8, 1568, False, 99584)),
    "MSG level 2, r=0.2": ((32, 512, 128, 32, 640, 16),
                           ("shared", 1024, 1, 32, 4, 4096, True, 143616)),
    "MSG level 2, r=0.4": ((32, 512, 128, 64, 640, 16),
                           ("shared", 1024, 1, 32, 4, 4096, True, 147712)),
    "MSG level 2, r=0.8": ((32, 512, 128, 128, 640, 16),
                           ("shared", 1024, 1, 32, 4, 4096, True, 155904)),
    "encode level 1, r=0.4": ((1, 2048, 512, 128, 6, 2),
                              ("shared", 1024, 1, 32, 16, 1568, False, 99584)),
    "encode level 2, r=0.8": ((1, 512, 128, 128, 640, 16),
                              ("shared", 1024, 1, 32, 4, 4096, True, 155904)),
    "fp32 card vs CPU level 1, r=0.1": ((2, 1024, 512, 16, 12, 4),
                                        ("shared", 1024, 1, 32, 16, 224, False, 25856)),
    "fp32 card vs CPU level 2, r=0.8": ((2, 512, 128, 128, 1280, 16),
                                        ("shared", 1024, 1, 32, 4, 4096, True, 155904)),
}


def tile_of(k, row_bytes, with_xyz=True):
    """The tile the plan asks for: the longer run (k feature rows, or k xyz
    rows of 12 bytes) and 16 bytes, rounded up to 32, at most 4 KB."""
    run = max(k * row_bytes, 12 * k if with_xyz else 0)
    return max(32, min(4096, -(-(run + 16) // 32) * 32))


def layout(N, k, cents, tile, shared):
    """csrc/group_gather.cu's shared memory: 32 warps' mbarriers, 32 warps'
    slots for `cents` centroids rounded to 16 bytes, 32 warps' tiles, 16
    bytes a staged point."""
    return 32 * 8 + -(-32 * cents * k * 4 // 16) * 16 + 32 * tile + (16 * N if shared else 0)


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_shapes_take_their_launch(name):
    shape, want = DRIVEN[name]
    p = group_gather_plan(*shape)
    assert tuple(p) == want
    assert p.smem <= SMEM_LIMIT


def test_level_1_stages_each_cloud_for_many_centroids():
    """The first version staged a cloud for every 16 centroids (32 blocks a
    cloud at level 1); now a block serves 64 of its 512."""
    p = group_gather_plan(32, 2048, 512, 16, 6, 2)
    assert p.per_block == 64 and p.blocks == 8


@pytest.mark.parametrize("N", [1, 20, 512, 2048, 5000, 13000, 14000, 100000])
@pytest.mark.parametrize("S,k", [(1, 1), (16, 8), (40, 5), (128, 64), (128, 128),
                                 (512, 32), (1000, 200)])
@pytest.mark.parametrize("row_bytes,word", [(0, 16), (6, 2), (12, 4), (640, 16),
                                            (66, 2), (4400, 16)])
@pytest.mark.parametrize("B", [1, 32])
def test_geometry_covers_every_centroid_once(B, N, S, k, row_bytes, word):
    p = group_gather_plan(B, N, S, k, row_bytes, word)
    assert (p.blocks - 1) * p.per_block < S <= p.blocks * p.per_block
    assert p.threads == 1024 and p.cents in (1, 2)
    assert p.tile == tile_of(k, row_bytes) and p.tile % 32 == 0
    shared = p.route == "shared"
    assert shared == (layout(N, k, p.cents, p.tile, True) <= SMEM_LIMIT)
    assert p.smem == layout(N, k, p.cents, p.tile, shared) <= SMEM_LIMIT
    assert p.bulk == (row_bytes >= 256 and word == 16)


def test_shared_memory_switch():
    """The largest cloud the shared route stages at level 2's k and rows,
    and one point more: the global route."""
    p = group_gather_plan(1, 512, 128, 128, 640, 16)
    most = (SMEM_LIMIT - layout(0, 128, p.cents, p.tile, False)) // 16
    assert group_gather_plan(1, most, 128, 128, 640, 16).route == "shared"
    assert group_gather_plan(1, most + 1, 128, 128, 640, 16).route == "global"


def test_slots_for_large_k_shrink_the_tile():
    """k = 1,806 fills the shared memory with one centroid's slots a warp
    and a 32-byte tile; one more slot does not fit, and k = 1,807 keeps its
    slots in the idx output with the tile it asks for, the cloud staged."""
    p = group_gather_plan(1, 100, 10, 1806, 0)
    assert (p.route, p.cents, p.tile, p.smem) == ("global", 1, 32, SMEM_LIMIT)
    p = group_gather_plan(1, 100, 10, 1807, 0)
    assert (p.route, p.tile) == ("shared-idx", tile_of(1807, 0))
    assert p.smem == 32 * 8 + 32 * p.tile + 16 * 100


@pytest.mark.parametrize("B,N,S,k,row_bytes,word", [
    (0, 10, 4, 2, 6, 2), (65536, 10, 4, 2, 6, 2), (1, 0, 4, 2, 6, 2), (1, 10, 0, 2, 6, 2),
    (1, 10, 4, 0, 6, 2), (1, 10, 4, 2, -2, 2), (1, 10, 4, 2, 6, 4), (1, 10, 4, 2, 6, 3)])
def test_shapes_no_launch_takes_are_refused(B, N, S, k, row_bytes, word):
    with pytest.raises(ValueError):
        group_gather_plan(B, N, S, k, row_bytes, word)


def staged_select(inside, k, cents=2, batches=4):
    """select_staged's sweep over in-ball flags inside (S, N) bool: `cents`
    centroids at once, rounds of `batches` batches of 32 points, each
    batch's in-ball points placed at their ballot rank after the count so
    far while it is below k, the sweep over once every centroid of the
    group has k; slots past the count repeat slot 0 (point 0 in an empty
    ball). Returns (idx (S, k), count (S,))."""
    S, N = inside.shape
    idx = np.full((S, k), -1, np.int64)
    cnt = np.zeros(S, np.int64)
    for g in range(0, S, cents):
        group = range(g, min(S, g + cents))
        base = 0
        while base < N and any(cnt[m] < k for m in group):
            for u in range(batches):
                lo = base + 32 * u
                for m in group:
                    ball = np.flatnonzero(inside[m, lo:lo + 32]) + lo
                    for rank, i in enumerate(ball, cnt[m]):
                        if rank < k:
                            idx[m, rank] = i
                    cnt[m] += len(ball)
            base += 32 * batches
    cnt = np.minimum(cnt, k)
    for m in range(S):
        idx[m, cnt[m]:] = idx[m, 0] if cnt[m] > 0 else 0
    return idx, cnt


def clouds(seed, B, N, S, F, masked):
    """Unit-cube clouds, centroids on every (N // S)-th point, the last one
    far outside (an empty ball); with masks ~1/3 of the points invalid and
    the last cloud fully masked (every ball empty)."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((B, N, 3), dtype=np.float32)
    feats = rng.standard_normal((B, N, F)).astype(np.float32)
    cents = xyz[:, :: max(1, N // S)][:, :S].copy()
    cents[:, -1] += 5.0
    mask = None
    if masked:
        mask = rng.random((B, N)) > 0.33
        mask[-1] = False
    return xyz, feats, cents, mask


def tpu_kernel(xyz, feats, cents, mask, k, radius):
    """grouped_gather in interpret mode, in group_neighbors' layout."""
    B, N, _ = xyz.shape
    pen = (jnp.zeros((B, N, 1), jnp.float32) if mask is None
           else jnp.where(jnp.asarray(mask)[..., None], 0.0, jnp.float32(1e9)))
    gx, gf, i, v = grouped_gather(jnp.asarray(xyz), jnp.asarray(feats),
                                  jnp.asarray(cents), pen, k, radius, True)
    return (np.asarray(gx.transpose(0, 3, 1, 2)), np.asarray(gf.transpose(0, 3, 1, 2)),
            np.asarray(jnp.swapaxes(i, 1, 2)), np.asarray(jnp.swapaxes(v, 1, 2)) > 0.5)


@pytest.mark.parametrize("N,S,k,radius,masked", [
    (300, 16, 16, 0.1, False),   # level 1's ball: under-full, every point tested
    (300, 16, 32, 0.3, True),    # masks, a fully masked cloud
    (200, 9, 5, 0.35, True),     # an odd count of centroids: a lone one in a pair
    (20, 4, 24, 0.5, False),     # k above N
    (256, 12, 128, 0.6, True),   # level 2's k
])
def test_staged_selection_matches_the_tpu_kernel(N, S, k, radius, masked):
    """The staged sweep, at one and two centroids a warp, and the plain
    version (CPU tensors) give the TPU kernel's idx and valid; every empty
    ball is point 0, invalid."""
    xyz, feats, cents, mask = clouds(N + k, 3, N, S, 4, masked)
    gx, gf, idx, valid = tpu_kernel(xyz, feats, cents, mask, k, radius)
    d = penalised_sqdist(torch.from_numpy(xyz), torch.from_numpy(cents),
                         None if mask is None else torch.from_numpy(mask))
    inside = (d <= torch.tensor(radius * radius, dtype=torch.float32)).numpy()
    for cents_a_warp in (1, 2):
        for b in range(3):
            sel, cnt = staged_select(inside[b], k, cents_a_warp)
            np.testing.assert_array_equal(sel, idx[b])
            np.testing.assert_array_equal(np.arange(k)[None] < cnt[:, None], valid[b])
    got = group_gather(*(None if a is None else torch.from_numpy(a)
                         for a in (xyz, feats, cents, mask)), k, radius)
    for g, w in zip(got, (gx, gf, idx, valid)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (idx[:, -1] == 0).all() and not valid[:, -1].any()


@pytest.mark.parametrize("head", [0, 1, 3])
def test_run_walks_assemble_the_tpu_kernels_rows(head):
    """Level 2's wide rows by the bulk walk (8 fp32 channels: 32-byte rows,
    16-byte words), level 1's narrow ones and the xyz rows by the word walk
    at every alignment of the output: the runs assembled from the staged
    selection's slots equal the TPU kernel's rows bit for bit."""
    xyz, feats, cents, mask = clouds(3 + head, 2, 160, 8, 8, True)
    gx, gf, idx, _ = tpu_kernel(xyz, feats, cents, mask, 24, 0.4)
    d = penalised_sqdist(torch.from_numpy(xyz), torch.from_numpy(cents),
                         torch.from_numpy(mask))
    inside = (d <= torch.tensor(0.4 * 0.4, dtype=torch.float32)).numpy()
    rows8 = feats.view(np.uint8).reshape(2, 160, 32)
    words3 = feats[..., :3].copy().view(np.uint32).reshape(2, 160, 3)
    for b in range(2):
        sel, _ = staged_select(inside[b], 24)
        for s in range(8):
            run = assemble_bulk(rows8[b], sel[s], 160)
            np.testing.assert_array_equal(run.view(np.float32).reshape(24, 8), gf[b, s])
            np.testing.assert_array_equal(assemble_words(xyz[b], sel[s], head, 64, 4),
                                          gx[b, s])
            run = assemble_words(words3[b], sel[s], head, 32, 4)
            np.testing.assert_array_equal(run.view(np.float32), gf[b, s, :, :3])


def test_cpu_tensors_take_the_plain_version():
    xyz, feats, cents, mask = clouds(5, 2, 300, 30, 7, True)
    args = [torch.from_numpy(a) for a in (xyz, feats, cents, mask)]
    before = group_gather.launches
    got = group_gather(*args, 12, 0.3)
    want = group_gather_reference(*args, 12, 0.3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert group_gather.launches == before


@pytest.mark.parametrize("k", [1806, 1807, 2048, 10000])
@pytest.mark.parametrize("N", [20, 2048, 14000])
@pytest.mark.parametrize("row_bytes,word", [(0, 16), (6, 2), (640, 16)])
def test_large_k_plans_cover_every_centroid_once(k, N, row_bytes, word):
    """At and past the 1,806 slots a warp's shared memory holds: the slots
    move to the idx output exactly where no tile fits beside them, the tile
    is then the one the run asks for, and the shared memory the layout
    without the slots."""
    p = group_gather_plan(2, N, 512, k, row_bytes, word)
    assert p.route.endswith("-idx") == (k > 1806)
    assert (p.blocks - 1) * p.per_block < 512 <= p.blocks * p.per_block
    shared = p.route.startswith("shared")
    if k > 1806:
        assert p.tile == tile_of(k, row_bytes)
        bare = layout(N, k, p.cents, p.tile, shared) - (-(-32 * p.cents * k * 4 // 16) * 16)
        assert shared == (bare + (0 if shared else 16 * N) <= SMEM_LIMIT)
        assert p.smem == bare <= SMEM_LIMIT
    else:
        assert p.smem == layout(N, k, p.cents, p.tile, shared) <= SMEM_LIMIT


@pytest.mark.parametrize("k", [300, 1024])
def test_large_k_group_neighbors_matches_the_jax_package(k):
    """The port's ball grouping (group_gather's plain version) past the TPU
    kernel's BALL_MAX_K = 256, where the JAX package takes its XLA
    ball_query: xyz, features, idx and valid equal on a masked cloud of
    1,200 points (the JAX package's ball_query takes no k above N)."""
    from torch_port_utils import ball_margin

    from pointcloud_tpu.ops import geometry as jgeo
    from pointcloud_tpu.ops.pallas_kernels import BALL_MAX_K
    from pointcloud_tpu_torch.ops import geometry as tgeo

    assert k > BALL_MAX_K
    xyz, feats, cents, mask = clouds(k, 2, 1200, 12, 5, True)
    cents[:, -1] -= 5.0  # no empty ball: every centroid on a point
    assert ball_margin(xyz, cents, 0.6) > 1e-5
    got = tgeo.group_neighbors(*(torch.from_numpy(a) for a in (xyz, feats, cents)), k,
                               radius=0.6, mask=torch.from_numpy(mask))
    want = jgeo.group_neighbors(*(jnp.asarray(a) for a in (xyz, feats, cents)), k,
                                radius=0.6, mask=jnp.asarray(mask))
    assert got[0].shape == (2, 12, k, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[3][0].sum(-1).max()) > 256  # balls fuller than the TPU kernel's k
