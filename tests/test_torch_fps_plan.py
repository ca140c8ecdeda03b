"""`fps_plan`: the route of each farthest-point-sampling shape, on the CPU.

csrc/fps.cu has three routes: a block per cloud with the cloud in registers
(N <= 12,288: `threads` x `slots` points, the coordinates also in shared
memory), one cloud over a thread block cluster of up to 16 blocks with each
block's slice in registers (N <= 196,608, the sensor's cloud of 3 cameras x
256 x 256), and a block per cloud over a global scratch (larger N). The plan
picks one from (B, N) alone. Held here at every driven shape: PointNet2's
SA1 / SA2 at B=256, the MSG levels and PointMLP's four stages at B=32,
`encode` on one cloud, the sensor; over a sweep of N, that a block's
threads x slots cover the cloud with the fewest slots (a multiple of 4, at
most 24 registers' worth), and that a cluster's blocks cover the cloud
once, hold at most 12,288 points each (512 threads x 24 registers) and fit
the card's shared memory. Shapes no route takes raise.
"""

import pytest
import torch

from pointcloud_tpu_torch.ops import farthest_point_sample, fps_plan, fps_reference
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT
from pointcloud_tpu_torch.ops.fps import _ROUTES

# name: (B, N, route, threads, slots, cluster, per_block, smem, scratch floats)
DRIVEN = {
    "PointNet2 SA1": (256, 2048, "block", 256, 8, 1, 2048, 24576, 0),
    "PointNet2 SA2": (256, 512, "block", 128, 4, 1, 512, 6144, 0),
    "MSG level 1": (32, 2048, "block", 256, 8, 1, 2048, 24576, 0),
    "MSG level 2": (32, 512, "block", 128, 4, 1, 512, 6144, 0),
    "PointMLP stage 1": (32, 2048, "block", 256, 8, 1, 2048, 24576, 0),
    "PointMLP stage 4": (32, 256, "block", 64, 4, 1, 256, 3072, 0),
    "encode": (1, 2048, "block", 256, 8, 1, 2048, 24576, 0),
    # (the key keeps the case's first name: the block route then took 1024
    # threads above 4,096 points)
    "block, 1024 threads": (2, 5000, "block", 512, 12, 1, 5000, 60000, 0),
    "largest block": (2, 12288, "block", 512, 24, 1, 12288, 147456, 0),
    "sensor": (1, 196608, "cluster", 512, 24, 16, 12288, 147456, 0),
    "smallest cluster": (2, 12289, "cluster", 512, 24, 2, 6145, 73740, 0),
    "scratch": (1, 196609, "scratch", 1024, 0, 1, 196609, 0, 4 * 196609),
}


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_shapes_take_their_route(name):
    B, N, *want = DRIVEN[name]
    p = fps_plan(B, N)
    assert tuple(p) == tuple(want)
    assert p.route in _ROUTES
    assert p.smem <= SMEM_LIMIT


def test_the_sensor_cloud_runs_on_a_cluster_of_16():
    """3 cameras x 256 x 256 = 196,608 points: 16 blocks of 12,288, each on
    its own SM (a non-portable cluster size), 144 KB of coordinates each."""
    p = fps_plan(1, 3 * 256 * 256)
    assert (p.route, p.cluster, p.per_block, p.threads) == ("cluster", 16, 12288, 512)
    assert p.per_block == p.threads * 24  # 24 points a thread, in registers


@pytest.mark.parametrize("N", [12289, 20000, 24576, 24577, 40000, 99999, 150001,
                               196607, 196608])
def test_cluster_blocks_cover_the_cloud_once(N):
    p = fps_plan(3, N)
    assert p.route == "cluster"
    assert 2 <= p.cluster <= 16
    assert p.per_block <= 12288 and p.per_block <= p.threads * 24
    # every point in one block, every block holds at least one point
    assert (p.cluster - 1) * p.per_block < N <= p.cluster * p.per_block
    # the fewest blocks that hold the cloud, the points split evenly
    assert p.cluster == -(-N // 12288)
    assert p.per_block == -(-N // p.cluster)
    assert p.smem == 12 * p.per_block <= SMEM_LIMIT


@pytest.mark.parametrize("N", [1, 3, 4, 100, 255, 256, 257, 511, 512, 513, 700, 1023,
                               1024, 1025, 2047, 2048, 2049, 4096, 4097, 5000, 8191,
                               12287, 12288])
def test_block_threads_and_slots_cover_the_cloud(N):
    """threads x slots >= N with slots a multiple of 4 and at most 24 (the
    register budget: 4 registers a point); the fewest such slots for the
    block size; at most 8 points a thread (4 up to 1,024 points) unless the
    cloud needs more than 512 x 8; the coordinates in shared memory."""
    p = fps_plan(2, N)
    assert p.route == "block" and p.threads in (64, 128, 256, 512)
    assert p.slots % 4 == 0 and 4 <= p.slots <= 24
    assert p.threads * p.slots >= N > p.threads * (p.slots - 4)
    per = 4 if N <= 1024 else 8
    assert p.slots <= per or p.threads == 512
    assert p.threads == 64 or (p.threads // 2) * per < N
    assert (p.cluster, p.per_block, p.smem) == (1, N, 12 * N) and p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("B,N", [(0, 100), (1, 0), (2, -5), (1, 1 << 29)])
def test_shapes_no_route_takes_are_refused(B, N):
    with pytest.raises(ValueError):
        fps_plan(B, N)


@pytest.mark.parametrize("N", [300, 13000])
def test_cpu_tensors_take_the_plain_version_at_any_route(N):
    """A block-route and a cluster-route shape on the CPU: the plain
    version, and no launch counted."""
    xyz = torch.rand((2, N, 3), dtype=torch.float32)
    before = farthest_point_sample.launches
    assert torch.equal(farthest_point_sample(xyz, 8), fps_reference(xyz, 8))
    assert farthest_point_sample.launches == before
