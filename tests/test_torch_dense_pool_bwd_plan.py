"""`pool_bwd_plan`: the route and geometry of the dense-pool backward, on the
CPU.

csrc/dense_bn_pool.cu runs the backward of `dense_pool_stats` on TMA +
`wgmma` for bf16 with Cin <= 128 and Cin, C multiples of 8 where its shared
memory fits at the pool (each ring stage carries the asel and dpsel tables of
the pool blocks its rows meet), and on the 64 x 128 tiles of tile_mma.cuh
otherwise (fp32, ragged widths, Cin > 128, pools of a few rows). Held
here at every driven shape (PointNet's three 128 -> 1024 layers at B=256 x
2048 rows and the AE + EMD batch of 128, the six MSG branches' last layers
at B=32, the ragged C = 200 / Cin = 72 of the card checks): the route, the
padded Cin, that the dx and dw chunks cover every row once in whole tiles
and steps within four waves of one block an SM, and the shared memory of
each launch as the kernels lay it out, within the card's 227 KB. Shapes no
route takes raise; the CPU rule is unchanged.
"""

import pytest
import torch

from pointcloud_tpu_torch.ops import (
    dense_pool_stats,
    dense_pool_stats_bwd,
    dense_pool_stats_reference,
    pool_bwd_plan,
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
    "ragged C and Cin": (450, 72, 200, 30),
}


def covers(chunk_rows, chunks, rows, granule):
    return (chunk_rows % granule == 0 and chunk_rows > 0
            and (chunks - 1) * chunk_rows < rows <= chunks * chunk_rows)


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_bf16_shapes_take_tma_and_wgmma(name):
    rows, cin, c, pool = DRIVEN[name]
    p = pool_bwd_plan(rows, cin, c, True, pool)
    assert (p.rows, p.cin, p.c, p.pool, p.route) == (rows, cin, c, pool, "wgmma")
    assert p.cin_pad == (64 if cin <= 64 else 128) >= cin
    assert covers(p.dx_chunk_rows, p.dx_chunks, rows, 128)
    assert covers(p.dw_chunk_rows, p.dw_chunks, rows, 64)
    # one block an SM, at most four waves of 132 (a dw chunk is -(-C // 128)
    # blocks, one a 128-channel tile of C)
    assert p.dx_chunks <= 4 * 132
    assert p.dw_chunks * -(-c // 128) <= 4 * 132
    assert p.dx_smem == tdp._dx_smem(p.cin_pad, c, pool) <= SMEM_LIMIT
    assert p.dw_smem == tdp._dw_smem(p.cin_pad, pool) <= SMEM_LIMIT


def test_pointnet_geometry():
    """PointNet's layer (524,288 rows, 128 -> 1024, pool 2048): 128 dx
    blocks of 32 tiles (one wave), 33 dw chunks of 249 steps x 8 channel
    tiles (two waves); 166 KB and 159 KB of shared memory."""
    p = pool_bwd_plan(256 * 2048, 128, 1024, True, 2048)
    assert (p.dx_chunk_rows, p.dx_chunks) == (32 * 128, 128)
    assert (p.dw_chunk_rows, p.dw_chunks) == (249 * 64, 33)
    # slack; x slots 2 x 128 x 128 bf16, w ring 5 x 128 x 64 bf16 and 14
    # mbarriers, padded to 128 bytes; 5 stages x (asel, dpsel) x 2 pool
    # blocks x 64 channels; 1024 float4 scalars
    assert p.dx_smem == 1024 + (65536 + 81920 + 128) + 5 * 2 * 2 * 64 * 4 + 16384
    # slack; x ring 5 x 64 x 128, w 2 x 128 x 64, dz 2 x 2 x 64 x 64 bf16,
    # scalars, db reduction, 11 mbarriers, padded; 5 x 2 x 2 x 128 tables
    assert p.dw_smem == (1024 + (81920 + 32768 + 32768 + 2048 + 2048 + 128)
                         + 5 * 2 * 2 * 128 * 4)


@pytest.mark.parametrize("rows,cin,c,bf16,pool", [
    (256 * 2048, 128, 1024, False, 2048),  # fp32: the card-vs-CPU checks
    (450, 72, 200, False, 30),
    (1000, 130, 256, True, 100),  # Cin no multiple of 8
    (1000, 64, 100, True, 100),  # C no multiple of 8
    (1000, 136, 256, True, 100),  # Cin past one accumulator tile
    (1000, 256, 512, True, 100),
    (1000, 128, 1024, True, 1),  # a pool of one row: the tables do not fit
    (1000, 128, 1024, True, 5),
])
def test_other_widths_and_fp32_take_the_tile_route(rows, cin, c, bf16, pool):
    p = pool_bwd_plan(rows, cin, c, bf16, pool)
    assert p.route == "tile" and p.cin_pad == 0
    assert covers(p.dx_chunk_rows, p.dx_chunks, rows, 64) and p.dx_chunk_rows == 64
    assert covers(p.dw_chunk_rows, p.dw_chunks, rows, 64) and p.dw_chunks <= 64
    assert p.dx_smem == p.dw_smem == 0


@pytest.mark.parametrize("rows,cin,c,pool", [(0, 128, 1024, 1), (65535 * 64 + 1, 128, 1024, 1),
                                             (1000, 0, 64, 10), (1000, 64, 0, 10),
                                             (1000, 64, 64, 0), (1000, 64, 64, 12)])
def test_shapes_no_route_takes_are_refused(rows, cin, c, pool):
    for bf16 in (False, True):
        with pytest.raises(ValueError):
            pool_bwd_plan(rows, cin, c, bf16, pool)


def test_the_smallest_pools_the_tables_allow():
    """The tables grow as the pool shrinks: at PointNet's widths the wgmma
    route takes pools from 6 rows (dx's tables then span 23 pool blocks a
    stage), smaller ones the tile route."""
    routes = {pool: pool_bwd_plan(5040 * 8, 128, 1024, True, pool).route
              for pool in range(1, 9)}
    assert routes == {p: "tile" if p < 6 else "wgmma" for p in range(1, 9)}


def test_the_backward_kernel_refuses_cpu_tensors():
    x = torch.randn((2, 64, 8))
    w = torch.randn((8, 16))
    b, s = torch.zeros(16), torch.ones(16)
    psel, asel, _, _ = dense_pool_stats(x, w, b, s, None, 32)
    want = dense_pool_stats_reference(x, w, b, s, None, 32)
    assert torch.equal(asel, want[1])
    with pytest.raises(ValueError):  # the CPU takes autograd, not the kernel
        dense_pool_stats_bwd(x, w, b, s, asel, psel, b, b, 32)
