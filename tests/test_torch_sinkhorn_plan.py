"""`sinkhorn_plan`: the geometry of the Sinkhorn sweeps, on the CPU.

csrc/sinkhorn.cu's `sweep_kernel` runs 256 threads a block, four outputs a
thread, over (blocks, B); where B alone gives fewer than two blocks an SM
the q range of each staged tile is split over 2, 4 or 8 groups of warps
whose (max, sum) pairs are merged in a fixed order. Held here at every
driven shape (the AE + EMD batch of 128, the Segmenter's and PointNet2's
64, the card checks' small and ragged clouds, B = 1 and 1024) and at the
bounds: the outputs cover every point once, the split is the fewest that
reaches two blocks an SM (8 at most), and shapes past the kernel's index
range raise.
"""

import pytest
import torch

from pointcloud_tpu_torch.ops import sinkhorn, sinkhorn_plan, sinkhorn_reference
from pointcloud_tpu_torch.ops.sinkhorn import _MAX_ROWS, eps_schedule

SHAPES = [
    (128, 2048, 2048),  # AE + EMD train and eval
    (64, 2048, 2048),  # Segmenter, PointNet2 + EMD
    (32, 2048, 2048),  # PointMLP-Elite + EMD
    (8, 2048, 2048),
    (1, 1500, 2500),
    (2, 1021, 997),  # no thread count divides N or M
    (1024, 64, 64),
    (4, 128, 128),
    (1, 1, 3),
]


def blocks_for(P, split):
    return -(-P // (256 // split * 4))


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_outputs_cover_every_point_in_the_fewest_groups(B, N, M):
    p = sinkhorn_plan(B, N, M)
    assert (p.B, p.N, p.M, p.outputs) == (B, N, M, 4)
    for P, split, blocks in ((N, p.split_x, p.blocks_x), (M, p.split_y, p.blocks_y)):
        assert split in (1, 2, 4, 8)
        assert blocks == blocks_for(P, split)
        per = 256 // split * 4  # outputs a block
        assert (blocks - 1) * per < P <= blocks * per
        # two blocks an SM of 132, else the largest split
        assert B * blocks >= 2 * 132 or split == 8
        if split > 1:  # the next smaller split would not reach it
            assert B * blocks_for(P, split // 2) < 2 * 132


def test_the_emd_batches():
    """B=128 at 2048 points: 2 groups, 4 blocks a cloud (512 blocks); the
    Segmenter's B=64: 4 groups, 8 blocks a cloud (512 blocks)."""
    p = sinkhorn_plan(128, 2048, 2048)
    assert (p.split_x, p.blocks_x, p.split_y, p.blocks_y) == (2, 4, 2, 4)
    p = sinkhorn_plan(64, 2048, 2048)
    assert (p.split_x, p.blocks_x, p.split_y, p.blocks_y) == (4, 8, 4, 8)


def test_the_split_follows_the_sm_count():
    assert sinkhorn_plan(128, 2048, 2048, sms=132).split_x == 2
    assert sinkhorn_plan(128, 2048, 2048, sms=64).split_x == 1
    assert sinkhorn_plan(128, 2048, 2048, sms=300).split_x == 4


@pytest.mark.parametrize("B,N,M", [(0, 64, 64), (65536, 8, 8), (2, 0, 64), (2, 64, 0),
                                   (2, _MAX_ROWS, 8), (1, 8, _MAX_ROWS + 1)])
def test_shapes_past_the_index_range_are_refused(B, N, M):
    with pytest.raises(ValueError):
        sinkhorn_plan(B, N, M)


def test_the_cpu_takes_the_plain_version():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 40, 3), generator=g)
    y = torch.rand((2, 50, 3), generator=g)
    before = sinkhorn.launches
    got = sinkhorn(x, y, 0.01, 5)
    want = sinkhorn_reference(x, y, eps_schedule(0.01, 5))[:2]
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    assert sinkhorn.launches == before
