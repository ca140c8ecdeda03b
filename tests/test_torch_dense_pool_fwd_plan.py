"""`pool_fwd_plan`: the route and geometry of the dense-pool forward, on the
CPU.

csrc/dense_bn_pool.cu runs the forward of `dense_pool_stats` on TMA +
`wgmma` for bf16 with Cin <= 128 and Cin, C multiples of 8 at a pool of 16
or 32 rows or a multiple of 64 (a 16-row warp slice of a 64-row tile never
straddles two pool blocks), and on the 64 x 128 tiles otherwise (fp32,
ragged widths, Cin > 128, other pools). Held here at every driven shape
(PointNet's three 128 -> 1024 layers at B=256 x 2048 rows and the AE + EMD
batch of 128, the six MSG branches' last layers at B=32, the ragged C = 200
/ Cin = 72 of the card checks): the route, the padded Cin, that the chunks
hold whole pool blocks and tiles, cover every row once and fill whole waves
of one block an SM, and the shared memory as the kernel lays it out, within
the card's 227 KB. Shapes no route takes raise.
"""

import pytest
import torch

from pointcloud_tpu_torch.ops import (
    dense_pool_stats,
    dense_pool_stats_reference,
    pool_fwd_plan,
)
from pointcloud_tpu_torch.ops import dense_bn_pool as tdp
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT

# name: (rows, Cin, C, pool)
DRIVEN = {
    "PointNet train, B=256": (256 * 2048, 128, 1024, 2048),
    "AE + EMD train, B=128": (128 * 2048, 128, 1024, 2048),
    "MSG level 1, r=0.1": (32 * 512 * 16, 32, 64, 16),
    "MSG level 1, r=0.2": (32 * 512 * 32, 64, 128, 32),
    "MSG level 1, r=0.4": (32 * 512 * 128, 96, 128, 128),
    "MSG level 2, r=0.2": (32 * 128 * 32, 64, 128, 32),
    "MSG level 2, r=0.4": (32 * 128 * 64, 128, 256, 64),
    "MSG level 2, r=0.8": (32 * 128 * 128, 128, 256, 128),
}


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_bf16_shapes_take_tma_and_wgmma(name):
    rows, cin, c, pool = DRIVEN[name]
    p = pool_fwd_plan(rows, cin, c, True, pool)
    assert (p.rows, p.cin, p.c, p.pool, p.route) == (rows, cin, c, pool, "wgmma")
    assert p.cin_pad == (64 if cin <= 64 else 128) >= cin
    granule = max(pool, 64)  # whole pool blocks and whole 64-row tiles
    assert p.chunk_rows % granule == 0 and p.chunk_rows > 0
    assert (p.chunks - 1) * p.chunk_rows < rows <= p.chunks * p.chunk_rows
    assert p.col_blocks == -(-c // 128)
    # one block an SM, at most four waves of 132
    assert p.chunks * p.col_blocks <= 4 * 132
    assert p.smem == tdp._fwd_smem(p.cin_pad) <= SMEM_LIMIT


def test_pointnet_geometry():
    """PointNet's layer (524,288 rows, 128 -> 1024, pool 2048): 16 chunks of
    16 pool blocks (512 tiles) x 8 channel blocks, 128 blocks in one wave;
    141 KB of shared memory."""
    p = pool_fwd_plan(256 * 2048, 128, 1024, True, 2048)
    assert (p.chunk_rows, p.chunks, p.col_blocks) == (16 * 2048, 16, 8)
    # slack; x ring 6 x 64 x 128 bf16, w 2 x 128 x 64 bf16, pool reductions
    # 2 x (2 x 2 x 4 x 64) x 4 bytes, sums 2 x 4 x 2 x 64 fp32, 13 mbarriers,
    # padded to 128 bytes
    assert p.smem == 1024 + -(-(98304 + 32768 + 8192 + 4096 + 104) // 128) * 128


def test_small_pools_split_rows_into_whole_tiles():
    """MSG level 1's first branch (32 -> 64, a pool of 16, 262,144 rows):
    Cin padded to one 64-wide atom, four pool blocks a tile, one block
    across C (its two consumers take alternate tiles)."""
    p = pool_fwd_plan(32 * 512 * 16, 32, 64, True, 16)
    assert (p.cin_pad, p.col_blocks) == (64, 1)
    assert p.chunk_rows % 64 == 0 and p.chunks * p.chunk_rows >= 32 * 512 * 16
    assert p.smem == 1024 + -(-(49152 + 16384 + 8192 + 4096 + 104) // 128) * 128


@pytest.mark.parametrize("rows,cin,c,bf16,pool", [
    (256 * 2048, 128, 1024, False, 2048),  # fp32: the card-vs-CPU checks
    (450, 72, 200, True, 30),  # a pool neither dividing nor a multiple of 64
    (450, 72, 200, False, 30),
    (1000, 130, 256, True, 100),  # Cin no multiple of 8
    (1024, 64, 100, True, 64),  # C no multiple of 8
    (1024, 136, 256, True, 64),  # Cin past one accumulator tile
    (1024, 128, 1024, True, 8),  # a pool under a warp's 16 rows
    (960, 128, 1024, True, 96),
    (1000, 128, 1024, True, 1),
])
def test_other_widths_pools_and_fp32_take_the_tile_route(rows, cin, c, bf16, pool):
    p = pool_fwd_plan(rows, cin, c, bf16, pool)
    assert p.route == "tile" and p.cin_pad == 0 and p.smem == 0
    assert p.chunk_rows == 512 and p.chunks == -(-rows // 512)
    assert p.col_blocks == -(-c // 128)


@pytest.mark.parametrize("pool", [16, 32, 64, 128, 192, 2048])
def test_every_pool_the_warp_slices_allow_takes_wgmma(pool):
    p = pool_fwd_plan(pool * 64, 64, 128, True, pool)
    assert p.route == "wgmma" and p.chunk_rows % pool == 0


@pytest.mark.parametrize("rows,cin,c,pool", [(0, 128, 1024, 1), (65535 * 64 + 64, 128, 1024, 64),
                                             (1000, 0, 64, 10), (1000, 64, 0, 10),
                                             (1000, 64, 64, 0), (1000, 64, 64, 12)])
def test_shapes_no_route_takes_are_refused(rows, cin, c, pool):
    for bf16 in (False, True):
        with pytest.raises(ValueError):
            pool_fwd_plan(rows, cin, c, bf16, pool)


def test_plans_depend_on_the_sm_count_only_through_the_waves():
    a = pool_fwd_plan(256 * 2048, 128, 1024, True, 2048, sms=132)
    b = pool_fwd_plan(256 * 2048, 128, 1024, True, 2048, sms=114)
    assert a.route == b.route == "wgmma" and a.smem == b.smem
    for p in (a, b):
        assert p.chunk_rows % 2048 == 0 and p.chunks * p.chunk_rows >= 256 * 2048


def test_the_cpu_takes_the_plain_version_whatever_the_route():
    """A CPU tensor never reaches a plan or a kernel: dense_pool_stats is
    the plain version there, at a shape of either route."""
    g = torch.Generator().manual_seed(0)
    for pool, cin, c in ((64, 64, 128), (30, 72, 200)):
        x = torch.randn((2, 2 * pool, cin), generator=g)
        w = torch.randn((cin, c), generator=g)
        b = torch.randn((c,), generator=g)
        s = torch.where(torch.rand((c,), generator=g) > 0.5, 1.0, -1.0)
        before = dense_pool_stats.launches
        got = dense_pool_stats(x, w, b, s, None, pool)
        want = dense_pool_stats_reference(x, w, b, s, None, pool)
        assert all(torch.equal(a, r) for a, r in zip(got, want))
        assert dense_pool_stats.launches == before
