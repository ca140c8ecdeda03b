"""`knn_group_plan`, the list route's selection and the row mover's run
walks, on the CPU.

csrc/knn_group.cu's list route (k up to 64, the cloud staged in shared
memory) keeps each centroid's best keys as a warp-held sorted list, filled
from the points at or below a threshold that one pass finds, a centroid a
warp; other shapes take the first version's rounds route. Held here: the plan at every driven shape (PointMLP
and PointMLP-Elite at bench.py's B=32, `encode` on one cloud, the Segmenter
at B=8, the fp32 card-vs-CPU checks at B=2); over a sweep of shapes, that
the blocks cover every centroid once and that the shared memory as the
kernel lays it out fits the card; both sides of the list-capacity switch
(k = 32 / 33 / 64 / 65) and of the shared-memory switch; shapes no launch
takes raise.

`knn_list_mirror` is the list route's selection step for step (the pass's
least keys, the threshold `kth_of_64`, the lanes searched again, the
buffered candidates, the bitonic sort and merge of `flush`): held bit-equal to the JAX package's kernel
(`grouped_gather_knn(_feats)` in interpret mode, at k rounded up to a
multiple of 8 and cut to k slots, as tests/test_torch_knn_group.py does)
on idx, and through the row mover's walks (`bulk_pieces`, `word_walk` in
tests/torch_port_utils.py) on the grouped rows, with planted exact ties,
masks, a fully masked cloud and k > N.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_utils import assemble_bulk, assemble_words, bulk_pieces, word_walk

from pointcloud_tpu.ops.pallas_kernels import grouped_gather_knn, grouped_gather_knn_feats
from pointcloud_tpu_torch.ops import knn_group, knn_group_plan, knn_group_reference
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT
from pointcloud_tpu_torch.ops.geometry import penalised_sqdist
from pointcloud_tpu_torch.ops.knn_group import (
    bitonic_merge_asc,
    bitonic_sort_desc,
    knn_list_mirror,
    kth_of_64,
)

BF, F32 = torch.bfloat16, torch.float32

# name: (B, N, S, k, F, dtype) -> (route, threads, keys, per_block, blocks,
# tile, rows, smem)
DRIVEN = {
    "PointMLP stage 1": ((32, 2048, 1024, 24, 64, BF),
                         ("list", 512, 1, 128, 8, 3104, "prefetch", 90752)),
    "PointMLP stage 2": ((32, 1024, 512, 24, 128, BF),
                         ("list", 512, 1, 64, 8, 4096, "bulk", 90240)),
    "PointMLP stage 3": ((32, 512, 256, 24, 256, BF),
                         ("list", 512, 1, 32, 8, 4096, "bulk", 82048)),
    "PointMLP stage 4": ((32, 256, 128, 24, 512, BF),
                         ("list", 512, 1, 16, 8, 4096, "bulk", 77952)),
    "Elite stage 1": ((32, 2048, 1024, 24, 32, BF),
                      ("list", 512, 1, 128, 8, 1568, "prefetch", 66176)),
    "Elite stage 2": ((32, 1024, 512, 24, 64, BF),
                      ("list", 512, 1, 64, 8, 3104, "prefetch", 74368)),
    "Elite stage 3": ((32, 512, 256, 24, 128, BF),
                      ("list", 512, 1, 32, 8, 4096, "bulk", 82048)),
    "Elite stage 4": ((32, 256, 128, 24, 256, BF),
                      ("list", 512, 1, 16, 8, 4096, "bulk", 77952)),
    "encode stage 1": ((1, 2048, 1024, 24, 64, BF),
                       ("list", 512, 1, 16, 64, 3104, "prefetch", 90752)),
    "encode stage 4": ((1, 256, 128, 24, 512, BF),
                       ("list", 512, 1, 16, 8, 4096, "bulk", 77952)),
    "Segmenter stage 1": ((8, 2048, 1024, 24, 32, BF),
                          ("list", 512, 1, 32, 32, 1568, "prefetch", 66176)),
    "fp32 card vs CPU stage 1": ((2, 2048, 1024, 24, 64, F32),
                                 ("list", 512, 1, 16, 64, 4096, "bulk", 106624)),
}


def list_tile(k, F, esize, with_xyz=False):
    """The list route's tile: the longer run (k feature rows, or k xyz rows
    of 12 bytes) and 16 bytes, rounded up to 32, at most 4 KB."""
    run = max(k * F * esize, 12 * k if with_xyz else 0)
    return max(32, min(4096, -(-(run + 16) // 32) * 32))


def list_layout(N, keys, tile):
    """csrc/knn_group.cu's list-route shared memory: 16 warps' mbarriers,
    lists and buffers of 32 * keys 8-byte keys, tiles, then 16 bytes a
    staged point in rows of 32."""
    return 16 * 8 + 16 * 2 * 32 * keys * 8 + 16 * tile + 16 * 32 * -(-N // 32)


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_shapes_take_their_launch(name):
    shape, want = DRIVEN[name]
    p = knn_group_plan(*shape)
    assert tuple(p) == want
    assert p.smem <= SMEM_LIMIT


def test_stage_1_stages_each_cloud_for_many_centroids():
    """The first version staged a cloud for every 8 to 64 centroids (16
    blocks a cloud at stage 1, 8 warps each); now a block of 16 warps serves
    128 of its 1,024, and a warp's next selection overlaps its last run's
    loads."""
    p = knn_group_plan(32, 2048, 1024, 24, 64, BF)
    assert p.route == "list" and p.per_block == 128 and p.rows == "prefetch"


@pytest.mark.parametrize("N", [1, 20, 300, 2048, 12000, 13500, 20000])
@pytest.mark.parametrize("S,k", [(1, 1), (12, 5), (40, 24), (128, 32), (128, 33),
                                 (512, 64), (64, 65), (1000, 200)])
@pytest.mark.parametrize("F,dtype", [(0, F32), (7, F32), (64, BF), (512, BF)])
@pytest.mark.parametrize("B", [1, 32])
def test_geometry_covers_every_centroid_once(B, N, S, k, F, dtype):
    row = F * (2 if dtype == BF else 4)
    word = next(w for w in (16, 8, 4, 2) if row % w == 0)
    p = knn_group_plan(B, N, S, k, F, dtype, word)
    tile = list_tile(k, F, 2 if dtype == BF else 4)
    assert (p.blocks - 1) * p.per_block < S <= p.blocks * p.per_block
    if p.route == "list":
        assert k <= 64 and p.keys == (1 if k <= 32 else 2)
        assert p.threads == 512 and p.tile == tile
        assert p.smem == list_layout(N, p.keys, p.tile) <= SMEM_LIMIT
        # 16-byte feature words where the row allows
        want = ("words" if F == 0 or row % 16 else "prefetch" if k * row <= tile
                else "bulk" if row >= 256 else "words")
        assert p.rows == want
    else:
        # the list would not fit (or k > 64): the first version's geometry
        assert k > 64 or list_layout(N, 1 if k <= 32 else 2, tile) > SMEM_LIMIT
        assert p.threads == 256 and p.per_block % 8 == 0 and p.keys == 0
        stage = 4 * 32 * (-(-N // 32) | 1) * 4
        assert p.route == ("rounds" if stage <= 160 * 1024 else "global")
        assert p.smem == (stage if p.route == "rounds" else 0)


@pytest.mark.parametrize("k,keys,route", [(32, 1, "list"), (33, 2, "list"),
                                          (64, 2, "list"), (65, 0, "rounds")])
def test_list_capacity_switch(k, keys, route):
    p = knn_group_plan(3, 300, 40, k, 16, BF)
    assert (p.keys, p.route) == (keys, route)


def test_shared_memory_switch():
    """The largest cloud the list route stages (a whole number of rows of 32
    points), and one point more: past the rounds route's 160 KB of staged
    chunks too, so the global route. The rounds route (k = 65) stages clouds up to
    10,208 points (319 chunks of 32 and a padded stride of 319)."""
    p = knn_group_plan(1, 2048, 1, 24, 64, BF)
    fixed = list_layout(0, 1, p.tile)
    most = (SMEM_LIMIT - fixed) // 512 * 32  # whole rows of 32 points
    assert most > 10208
    assert knn_group_plan(1, most, 1, 24, 64, BF).route == "list"
    assert knn_group_plan(1, most + 1, 1, 24, 64, BF).route == "global"
    assert knn_group_plan(1, 10208, 128, 65, 0, F32).route == "rounds"
    assert knn_group_plan(1, 10209, 128, 65, 0, F32).route == "global"


@pytest.mark.parametrize("word,rows", [(16, "bulk"), (8, "words"), (4, "words"),
                                       (2, "words")])
def test_bulk_copies_and_prefetches_take_16_byte_words_only(word, rows):
    """Stage 3's rows (512 bytes, a run past the tile) by bulk copies only on
    16-byte words; stage 1's (a run inside the tile) prefetched only then,
    and not beside the xyz rows; no features, no rows."""
    assert knn_group_plan(32, 512, 256, 24, 256, BF, word).rows == rows
    assert knn_group_plan(32, 2048, 1024, 24, 64, BF, word).rows == (
        "prefetch" if word == 16 else "words")
    assert knn_group_plan(32, 2048, 1024, 24, 64, BF, word, True).rows == "words"
    assert knn_group_plan(32, 2048, 1024, 24, 0, BF, word).rows == "words"


@pytest.mark.parametrize("B,N,S,k,F,word", [(0, 10, 4, 2, 3, 16), (65536, 10, 4, 2, 3, 16),
                                            (1, 0, 4, 2, 3, 16), (1, 10, 0, 2, 3, 16),
                                            (1, 10, 4, 0, 3, 16), (1, 10, 4, 2, -1, 16),
                                            (1, 1 << 30, 4, 2, 3, 16), (1, 10, 4, 2, 3, 3),
                                            (1, 10, 4, 2, 3, 8)])
def test_shapes_no_launch_takes_are_refused(B, N, S, k, F, word):
    with pytest.raises(ValueError):
        knn_group_plan(B, N, S, k, F, F32, word)


def test_other_dtypes_are_refused():
    with pytest.raises(TypeError):
        knn_group_plan(1, 10, 4, 2, 3, torch.float16)


@pytest.mark.parametrize("n", [32, 64])
def test_bitonic_network_sorts_and_merges(n):
    """sort_desc's and merge_asc's compare-exchange steps, mirrored: the
    sort descends, the merge gives the n least keys of both ascending,
    repeated keys and the empty-slot key included."""
    rng = np.random.default_rng(n)
    for _ in range(40):
        v = torch.from_numpy(rng.integers(0, 50, n))
        v[rng.integers(0, n, 3)] = (1 << 63) - 1
        assert torch.equal(bitonic_sort_desc(v), torch.sort(v, descending=True).values)
        lst = torch.sort(torch.from_numpy(rng.integers(0, 50, n))).values
        want = torch.sort(torch.cat([lst, v])).values[:n]
        assert torch.equal(bitonic_merge_asc(lst, bitonic_sort_desc(v)), want)


@pytest.mark.parametrize("k", [1, 5, 24, 32, 33, 64])
def test_first_threshold_network_picks_the_kth_least(k):
    """kth_of_64's steps, mirrored: the k-th least of the lanes' 64 values,
    repeated values included."""
    rng = np.random.default_rng(k)
    for _ in range(40):
        a, b = (torch.from_numpy(rng.integers(0, 40, 32)) for _ in range(2))
        assert int(kth_of_64(a, b, k)) == int(torch.sort(torch.cat([a, b])).values[k - 1])


def clouds(seed, B, N, S, F, masked, ties):
    """Unit-cube clouds, centroids on every (N // S)-th point. `ties`: every
    fourth point is a copy of the point before it (exact distance ties,
    resolved by index). With masks ~30% of the points invalid and the last
    cloud fully masked (slot 0, the least penalised point, in every slot)."""
    rng = np.random.default_rng(seed)
    xyz = rng.random((B, N, 3), dtype=np.float32)
    if ties:
        xyz[:, 3::4] = xyz[:, 2::4][:, : xyz[:, 3::4].shape[1]]
    feats = rng.standard_normal((B, N, F)).astype(np.float32)
    cents = xyz[:, :: max(1, N // S)][:, :S].copy()
    mask = None
    if masked:
        mask = rng.random((B, N)) > 0.3
        mask[-1] = False
    return xyz, feats, cents, mask


def tpu_kernel(xyz, feats, cents, mask, k):
    """The interpret-mode TPU kernel at k rounded up to a multiple of 8, cut
    to k slots: (gx, gf, idx) as numpy."""
    k8 = -(-k // 8) * 8
    pen = (jnp.zeros((xyz.shape[0], xyz.shape[1], 1), jnp.float32) if mask is None
           else jnp.where(jnp.asarray(mask)[..., None], 0.0, jnp.float32(1e9)))
    gx, gf, idx = grouped_gather_knn(jnp.asarray(xyz), jnp.asarray(feats),
                                     jnp.asarray(cents), pen, k8, True)
    return (np.asarray(gx)[:, :, :k], np.asarray(gf)[:, :, :k],
            np.asarray(idx)[:, :, :k])


@pytest.mark.parametrize("N,S,k,masked,ties", [
    (300, 12, 24, False, False),   # the path's k, one key a lane
    (300, 12, 24, True, True),     # masks, a fully masked cloud, planted ties
    (200, 10, 32, True, False),    # a full one-key list
    (200, 10, 33, False, True),    # two keys a lane
    (200, 10, 64, True, True),     # a full two-key list
    (20, 4, 24, True, False),      # k > N
    (100, 12, 5, False, True),
])
def test_list_selection_matches_the_tpu_kernel(N, S, k, masked, ties):
    """knn_list_mirror on the port's penalised distances gives the TPU
    kernel's idx slot for slot; the features gathered by its slots equal
    the TPU kernel's rows bit for bit."""
    xyz, feats, cents, mask = clouds(N + k, 3, N, S, 5, masked, ties)
    _, gf, idx = tpu_kernel(xyz, feats, cents, mask, k)
    d = penalised_sqdist(torch.from_numpy(xyz), torch.from_numpy(cents),
                         None if mask is None else torch.from_numpy(mask))
    got = knn_list_mirror(d, k)
    np.testing.assert_array_equal(got.numpy(), idx)
    rows = np.take_along_axis(feats[:, None], got.numpy()[..., None].astype(np.int64), 2)
    np.testing.assert_array_equal(rows, gf)
    if masked:  # the fully masked cloud: every slot repeats slot 0
        assert (idx[-1] == idx[-1, :, :1]).all()


def test_k_above_the_list_takes_the_rounds_route():
    """k = 65: the rounds route, whose plain version (CPU tensors) still
    gives the TPU kernel's idx and rows; the mirror refuses it."""
    xyz, feats, cents, mask = clouds(65, 2, 200, 8, 4, True, True)
    assert knn_group_plan(2, 200, 8, 65, 4, F32).route == "rounds"
    gx, gf, idx = tpu_kernel(xyz, feats, cents, mask, 65)
    got = knn_group(*(torch.from_numpy(a) for a in (xyz, feats, cents, mask)), 65, True)
    np.testing.assert_array_equal(got[2].numpy(), idx)
    np.testing.assert_array_equal(got[1].numpy(), gf)
    np.testing.assert_array_equal(got[0].numpy(), gx)
    with pytest.raises(ValueError):
        knn_list_mirror(torch.zeros(1, 1, 200), 65)


@pytest.mark.parametrize("k,row_bytes,tile", [(24, 128, 3104), (24, 1024, 4096),
                                              (24, 64, 1568), (5, 16, 96), (64, 2048, 4096),
                                              (3, 4096, 4096), (1, 16, 32)])
def test_bulk_walk_covers_each_byte_once(k, row_bytes, tile):
    """Every byte of the run in exactly one copy; every copy a multiple of
    16 bytes, 16-byte aligned at both ends and inside one row; a piece at
    most half the tile."""
    seen = np.zeros(k * row_bytes, np.int64)
    for p0, pn, copies in bulk_pieces(k, row_bytes, tile):
        assert pn <= (tile // 2) & ~15 and p0 % 16 == 0
        for off, j, src, n in copies:
            assert off % 16 == src % 16 == n % 16 == 0 and n > 0
            assert src + n <= row_bytes
            assert p0 + off == j * row_bytes + src
            seen[p0 + off:p0 + off + n] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("k,wpr,per,tile_words", [(24, 3, 4, 32), (24, 3, 4, 800),
                                                  (5, 7, 4, 8), (16, 3, 8, 112),
                                                  (24, 33, 8, 64), (3, 1100, 4, 64),
                                                  (40, 1, 8, 16)])
def test_word_walk_covers_each_word_once(k, wpr, per, tile_words):
    """At every alignment of the output: each word of the run loaded once,
    from its own (row, word), into its place in the piece's tile; each
    16-byte chunk stored starts on an output 16-byte boundary."""
    for head in range(per):
        seen = np.zeros(k * wpr, np.int64)
        for p0, pn, fills, chunks in word_walk(k, wpr, head, tile_words, per):
            for pos, e, j, w in fills:
                assert pos == e - p0 and (j, w) == divmod(e, wpr) and pos < pn
                seen[e] += 1
            assert all((e0 - head) % per == 0 for e0, _ in chunks)
        assert (seen == 1).all()


@pytest.mark.parametrize("head", [0, 2, 5])
def test_run_walks_assemble_the_tpu_kernels_rows(head):
    """The runs the bulk walk (16-byte rows) and the word walk (the xyz
    rows, and 2-byte words of odd bf16-width rows) assemble from the
    mirror's slots equal the TPU kernel's grouped rows bit for bit."""
    xyz, feats, cents, mask = clouds(7 + head, 2, 160, 8, 8, True, True)
    gx, gf, idx = tpu_kernel(xyz, feats, cents, mask, 24)
    d = penalised_sqdist(torch.from_numpy(xyz), torch.from_numpy(cents),
                         torch.from_numpy(mask))
    sel = knn_list_mirror(d, 24).numpy()
    rows8 = feats.view(np.uint8).reshape(2, 160, 32)  # 32-byte rows: 16-byte words
    words2 = feats[..., :7].copy().view(np.uint16).reshape(2, 160, 14)  # 14-byte rows
    for b in range(2):
        for s in range(8):
            run = assemble_bulk(rows8[b], sel[b, s], 96)
            np.testing.assert_array_equal(run.view(np.float32).reshape(24, 8), gf[b, s])
            run = assemble_words(xyz[b], sel[b, s], head % 4, 32, 4)
            np.testing.assert_array_equal(run, gx[b, s])
            run = assemble_words(words2[b], sel[b, s], head, 64, 8)
            np.testing.assert_array_equal(run.view(np.float32), gf[b, s, :, :7])


def test_cpu_tensors_take_the_plain_version():
    xyz, feats, cents, mask = clouds(5, 2, 300, 30, 7, True, False)
    args = [torch.from_numpy(a) for a in (xyz, feats, cents, mask)]
    before = knn_group.launches
    got = knn_group(*args, 24, True)
    want = knn_group_reference(*args, 24, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert knn_group.launches == before
