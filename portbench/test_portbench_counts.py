"""The FLOP counts and bounds equal totals worked by hand from the published
widths."""

from __future__ import annotations

import pytest

from portbench import core, counts


def test_pointnet2_flops():
    cfg = core.load_json("configs", "ae_pointnet2_chamfer")
    # SA1: 512 groups of 32 rows, 6 -> 64 -> 64 -> 128
    sa1 = 2 * 512 * 32 * (6 * 64 + 64 * 64 + 64 * 128)
    # SA2: 128 groups of 64 rows, (3 + 128) -> 128 -> 128 -> 256
    sa2 = 2 * 128 * 64 * (131 * 128 + 128 * 128 + 128 * 256)
    # SA3: the 128 centroids as one group, (3 + 256) -> 256 -> 512 -> 1024
    sa3 = 2 * 128 * (259 * 256 + 256 * 512 + 512 * 1024)
    # bottleneck 1024 -> 13, decoder 13 -> 512 -> 1024 -> 2048 -> 2048 x 6
    dec = 2 * (1024 * 13 + 13 * 512 + 512 * 1024 + 1024 * 2048 + 2048 * 12288)
    assert counts.pointnet2_level_flops(cfg) == [sa1, sa2, sa3]
    assert counts.forward_flops(cfg) == sa1 + sa2 + sa3 + dec == 1_735_629_824


def test_pointnet_flops():
    cfg = core.load_json("configs", "ae_pointnet_emd")
    n = 2048
    stn3 = 2 * n * (6 * 64 + 64 * 128 + 128 * 1024) + 2 * (1024 * 512 + 512 * 256 + 256 * 9)
    stn64 = 2 * n * (64 * 64 + 64 * 128 + 128 * 1024) + 2 * (1024 * 512 + 512 * 256 + 256 * 4096)
    transforms = 2 * n * 3 * 3 + 2 * n * 64 * 64
    mlps = 2 * n * (6 * 64 + 64 * 64) + 2 * n * (64 * 64 + 64 * 128 + 128 * 1024)
    dec = 2 * (1024 * 13 + 13 * 512 + 512 * 1024 + 1024 * 2048 + 2048 * 12288)
    assert counts.forward_flops(cfg) == stn3 + stn64 + transforms + mlps + dec
    assert counts.forward_flops(cfg) == 1_841_905_152


def test_bounds():
    # Sinkhorn at B=128, 2048 x 2048, 50 iterations: the ex2 bound,
    # 2 * 50 * 128 * 2048^2 exponentials at 67e12 / 16 a second
    ms, by = counts.sinkhorn_bound(128, 2048, 2048, 50)
    assert by == "operations"
    assert ms == pytest.approx(2 * 50 * 128 * 2048**2 / (67e12 / 16) * 1e3)
    # one chain layer's forward product bound by operations: 2 rows cd cu
    fwd = counts.chain_bounds(1 << 16, 1 << 10, 1024, 1024, 2, False, True)[0]
    assert fwd == (pytest.approx(2 * (1 << 16) * 1024 * 1024 / 989e12 * 1e3), "operations")
    # a PointNet++ train step's chains at B=256: the sum of its levels
    cfg = core.load_json("configs", "ae_pointnet2_chamfer")
    total = counts.chain_train_bound_ms(cfg, 256)
    levels = [counts.chain_step_bound_ms(256 * 512 * 32, 256 * 512,
                                         [(6, 64), (64, 64), (64, 128)], 2, False),
              counts.chain_step_bound_ms(256 * 128 * 64, 256 * 128,
                                         [(131, 128), (128, 128), (128, 256)], 2, True),
              counts.chain_step_bound_ms(256 * 128, 256,
                                         [(259, 256), (256, 512), (512, 1024)], 2, True)]
    assert total == pytest.approx(sum(levels))
    assert 6.0 < total < 7.5
