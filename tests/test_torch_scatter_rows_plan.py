"""`scatter_plan` and `scatter_rows_mirror`, on the CPU.

csrc/scatter_rows.cu is one launch: a block owns `targets` consecutive
targets of one cloud, its 16 warps split the cloud's rows into contiguous
runs in row order, and groups of `group` lanes sum a target's rows, `vec`
channels a lane, in `passes` passes. The plan picks the geometry from the
shape, the dtype and the rows' alignment. Held here at every driven shape
(the Chamfer backward's segment-sum route, PointNet2's SA2 grouping
gradient, PointMLP's four stages, MSG level 2's three branches); over a
sweep of shapes, that the blocks cover every target once, the warps' runs
every row once, the groups every channel once, each load is aligned, and
the shared memory as the kernel lays it out fits the card. Shapes no launch
takes raise.

`scatter_rows_mirror` is the kernel's order of additions: the plain version
for buckets of up to PIECE rows, a fixed-shape sum of pieces of PIECE rows
for longer ones. Held bit-equal to the plain version where no bucket is long, to a
piece sum written out by hand where one is, and within 2e-5 (absolute and
relative: the TPU kernel's one-hot MXU products sum in another order) of
the JAX package's `scatter_rows_pallas` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_tpu.ops.pallas_kernels import scatter_rows_pallas
from pointcloud_tpu_torch.ops import (
    scatter_plan,
    scatter_rows,
    scatter_rows_mirror,
    scatter_rows_reference,
)
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT
from pointcloud_tpu_torch.ops.scatter_rows import PIECE, _smem

BF, F32 = torch.bfloat16, torch.float32
WARPS = 16

# name: (B, R, n, C, dtype) -> (ranges, targets, vec, group, passes, perm_cap,
# item_cap, cloud_pieces, smem)
DRIVEN = {
    "segment-sum route": ((4, 4096, 4096, 6, F32),
                          (32, 128, 2, 4, 1, 1024, 193, 96, 16744)),
    "PointNet2 SA2": ((256, 8192, 512, 131, BF),
                      (1, 512, 1, 32, 5, 8192, 641, 129, 77928)),
    "PointMLP stage 1": ((32, 24576, 2048, 64, BF),
                         (4, 512, 8, 8, 1, 12288, 897, 388, 95336)),
    "PointMLP stage 2": ((32, 12288, 1024, 128, BF),
                         (4, 256, 8, 16, 1, 6144, 449, 196, 48488)),
    "PointMLP stage 3": ((32, 6144, 512, 256, BF),
                         (4, 128, 8, 32, 1, 3072, 225, 100, 25064)),
    "PointMLP stage 4": ((32, 3072, 256, 512, BF),
                         (4, 64, 8, 32, 2, 1536, 113, 52, 13352)),
    "MSG level 2, k=32": ((32, 4096, 512, 320, BF),
                          (4, 128, 8, 32, 2, 2048, 193, 68, 20840)),
    "MSG level 2, k=64": ((32, 8192, 512, 320, BF),
                          (4, 128, 8, 32, 2, 4096, 257, 132, 29288)),
    "MSG level 2, k=128": ((32, 16384, 512, 320, BF),
                           (4, 128, 8, 32, 2, 8192, 385, 260, 46184)),
}


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_shapes_take_their_launch(name):
    shape, want = DRIVEN[name]
    p = scatter_plan(*shape)
    assert (p.route, p.threads) == ("ranges", 512)
    assert (p.ranges, p.targets, p.vec, p.group, p.passes, p.perm_cap,
            p.item_cap, p.cloud_pieces, p.smem) == want
    assert p.smem <= SMEM_LIMIT


def test_the_route_fills_the_card_and_sa2_rows_take_a_channel_a_lane():
    """The segment-sum route's 4 clouds take 128 blocks, one wave (it lost
    to index_add_ on 4 blocks); SA2's 131-channel bf16 rows start on 2-byte
    boundaries, so a lane takes one channel, a warp 64 contiguous bytes of
    a row a load, in exactly the 5 passes a row needs."""
    p = scatter_plan(4, 4096, 4096, 6, F32)
    assert 4 * p.ranges == 128
    p = scatter_plan(256, 8192, 512, 131, BF)
    assert (p.vec, p.group, p.passes) == (1, 32, 5) and (131 * 2) % 4 == 2


def warp_runs(R):
    """[lo, hi) of each warp's run of rows, as the kernel cuts them."""
    run = (-(-R // WARPS) + 31) // 32 * 32
    return [(min(R, w * run), min(R, w * run + run)) for w in range(WARPS)]


SWEEP = [(B, R, n, C, dt) for B, R, n in ((1, 0, 1), (1, 1, 1), (2, 100, 7),
                                           (3, 1000, 77), (1, 65536, 8192),
                                           (8, 5000, 20000), (1, 196608, 196608),
                                           (64, 2048, 2048), (256, 8192, 512))
         for C in (1, 3, 6, 8, 64, 131, 320, 1000) for dt in (F32, BF)]


@pytest.mark.parametrize("B,R,n,C,dtype", SWEEP)
def test_geometry_covers_targets_rows_and_channels_once(B, R, n, C, dtype):
    p = scatter_plan(B, R, n, C, dtype)
    # targets: every one in exactly one block, at most 1,024 a block
    assert 1 <= p.targets <= 1024
    assert (p.ranges - 1) * p.targets < n <= p.ranges * p.targets
    # rows: the warps' runs partition [0, R) in order
    runs = warp_runs(R)
    assert runs[0][0] == 0 and runs[-1][1] == R
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    # channels: a group's lanes x vec x passes, in chunks, cover a row
    assert p.group in (1, 2, 4, 8, 16, 32) and 1 <= p.passes <= 8
    assert p.passes in (1, 2, 3, 4, 8) or p.vec == 1
    assert p.passes * p.vec <= 16  # at most 16 accumulators a lane
    assert p.group * p.vec >= C or p.group == 32
    assert p.passes == 1 or p.group == 32
    # loads: vec elements a lane, aligned at every row's start
    esize = 2 if dtype == BF else 4
    assert p.vec * esize <= 16 and (C * esize) % (p.vec * esize) == 0
    assert p.vec == 1 or (C * esize) % (2 * p.vec * esize) != 0 or p.vec * esize == 16
    # slots; items: every target and the pieces of its long buckets; the
    # pieces' sums of the cloud's blocks at their offsets; shared memory
    assert 0 <= p.perm_cap <= max(R, 0) and (p.perm_cap % 32 == 0 or p.perm_cap == R)
    assert p.item_cap == p.targets + 2 * R // PIECE + 1
    assert p.cloud_pieces == 2 * R // PIECE + p.ranges
    assert p.smem == _smem(p.targets, p.perm_cap, p.item_cap) <= SMEM_LIMIT


def block_pieces(rows_below, rows_in, blk):
    """First and one-past-last piece of a block's region in the cloud's
    scratch of pieces' sums, as the kernel places it, holding the most
    pieces its rows can make (every long bucket PIECE + 1 rows)."""
    first = 2 * (rows_below // PIECE) + blk
    return first, first + rows_in // (PIECE + 1) * 2


@pytest.mark.parametrize("rows", [[0, 0, 0], [129] * 4, [4096], [500, 129, 0, 7000, 258],
                                  [PIECE] * 9, [PIECE + 1, 2 * PIECE + 1, 1]])
def test_blocks_pieces_never_overlap(rows):
    """Each block's region of the scratch starts past the previous block's
    most pieces and the last ends inside cloud_pieces."""
    below, regions = 0, []
    for blk, r in enumerate(rows):
        regions.append(block_pieces(below, r, blk))
        below += r
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
    assert regions[-1][1] <= 2 * below // PIECE + len(rows)


@pytest.mark.parametrize("C,align,vec", [(6, 16, 2), (6, 4, 1), (8, 8, 2), (64, 2, 1),
                                         (64, 4, 2), (64, 16, 8), (131, 16, 1)])
def test_loads_follow_the_rows_alignment(C, align, vec):
    """g's first element on an `align`-byte boundary: the widest load that
    both it and the row width allow."""
    dtype = F32 if C in (6, 8) else BF
    assert scatter_plan(2, 64, 16, C, dtype, align=align).vec == vec


@pytest.mark.parametrize("B,R,n,C,dtype", [(0, 10, 4, 3, F32), (65536, 10, 4, 3, F32),
                                           (1, -1, 4, 3, F32), (1, 10, 0, 3, F32),
                                           (1, 10, 4, 0, F32), (1, 1 << 28, 4, 4, F32),
                                           (1, 10, 1 << 28, 4, BF)])
def test_shapes_no_launch_takes_are_refused(B, R, n, C, dtype):
    with pytest.raises(ValueError):
        scatter_plan(B, R, n, C, dtype)


def test_other_dtypes_are_refused():
    with pytest.raises(TypeError):
        scatter_plan(1, 10, 4, 3, torch.float16)


def case(seed, B, R, n, C, crowd):
    """Rows, indices (`crowd` of each cloud's rows onto target 3) and an
    init."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, R, C)).astype(np.float32)
    idx = rng.integers(0, n, (B, R)).astype(np.int32)
    idx[:, :crowd] = 3
    init = rng.standard_normal((B, n, C)).astype(np.float32)
    return g, idx, init


@pytest.mark.parametrize("with_init", [False, True])
def test_mirror_is_the_plain_version_without_long_buckets(with_init):
    g, idx, init = case(1, 2, 300, 40, 5, crowd=PIECE - 12)  # target 3 holds ~PIECE
    g, idx = torch.from_numpy(g), torch.from_numpy(idx)
    init = torch.from_numpy(init) if with_init else None
    assert int((idx == 3).sum(1).max()) <= PIECE
    assert torch.equal(scatter_rows_mirror(g, idx, 40, init),
                       scatter_rows_reference(g, idx, 40, init))


def test_mirror_sums_a_long_bucket_in_pieces():
    """One target holding ~90 rows of a cloud: pieces of PIECE rows and the
    rest, each in row order, the first from init, added in piece order; the
    other targets as the plain version."""
    g, idx, init = case(2, 1, 400, 16, 4, crowd=2 * PIECE + 5)
    g, idx, init = (torch.from_numpy(a) for a in (g, idx, init))
    got = scatter_rows_mirror(g, idx, 16, init)
    rows = torch.nonzero(idx[0] == 3).flatten().tolist()
    assert 2 * PIECE < len(rows) <= 3 * PIECE
    parts = []
    for q in range(0, len(rows), PIECE):
        acc = init[0, 3].clone() if q == 0 else torch.zeros(4)
        for r in rows[q:q + PIECE]:
            acc = acc + g[0, r]
        parts.append(acc)
    want = scatter_rows_reference(g, idx, 16, init)
    want[0, 3] = (parts[0] + parts[1]) + parts[2]
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), scatter_rows_reference(
        g, idx, 16, init).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("crowd", [0, 200])
@pytest.mark.parametrize("with_init", [False, True])
def test_mirror_matches_the_tpu_kernel(crowd, with_init):
    g, idx, init = case(3 + crowd, 2, 512, 32, 6, crowd)
    want = np.asarray(scatter_rows_pallas(
        jnp.asarray(g), jnp.asarray(idx), 32,
        init=jnp.asarray(init) if with_init else None, interpret=True))
    got = scatter_rows_mirror(torch.from_numpy(g), torch.from_numpy(idx), 32,
                              torch.from_numpy(init) if with_init else None)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    g, idx, init = case(4, 2, 300, 40, 131, crowd=200)
    gb = torch.from_numpy(g).bfloat16()
    before = scatter_rows.launches
    got = scatter_rows(gb, torch.from_numpy(idx), 40, torch.from_numpy(init))
    assert torch.equal(got, scatter_rows_reference(gb, torch.from_numpy(idx), 40,
                                                   torch.from_numpy(init)))
    assert scatter_rows.launches == before
