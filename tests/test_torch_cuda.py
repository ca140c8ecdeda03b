"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pointcloud_tpu_torch.ops import chamfer_distance, nn_sweep, nn_sweep_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def clouds(dev, seed, B, N, M, C, masked):
    """Unit-cube clouds; target M-1 duplicates target 1 and query 0 sits on
    it. With masks ~10% of points are masked and the last batch element's
    x points all are."""
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, C), dtype=np.float32)
    y = rng.random((B, M, C), dtype=np.float32)
    y[:, M - 1] = y[:, 1]
    x[:, 0] = y[:, 1]
    xm = ym = None
    if masked:
        xm = rng.random((B, N)) > 0.1
        ym = rng.random((B, M)) > 0.1
        xm[:, 0] = True
        ym[:, [1, M - 1]] = True
        xm[B - 1] = False
    t = (lambda a: None if a is None else torch.from_numpy(a).to(dev))
    return t(x), t(y), t(xm), t(ym)


@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_version(dev, C, masked):
    """Values within 1e-5 (direct differences vs the plain version's matmul
    expansion: fp32 round-off only), masked points >= 1e10, and the first
    of two tied targets wins."""
    x, y, xm, ym = clouds(dev, C, 3, 300, 517, C, masked)
    got = nn_sweep(x, y, xm, ym)
    torch.cuda.synchronize()
    want = nn_sweep_reference(x, y, xm, ym)
    for v, mask in ((0, xm), (2, ym)):
        valid = torch.ones_like(got[v], dtype=torch.bool) if mask is None else mask
        assert (got[v] - want[v]).abs()[valid].max() <= 1e-5
        assert (got[v][~valid] >= 1e10).all()
    assert got[1].dtype == torch.int32 and got[1].shape == (3, 300)
    assert got[3].dtype == torch.int32 and got[3].shape == (3, 517)
    assert (got[1][:, 0] == 1).all()


def test_indices_agree_off_ties(dev):
    """Wherever the exact (fp64) runner-up is more than 1e-5 farther than
    the nearest valid target, the kernel names the nearest."""
    x, y, xm, ym = clouds(dev, 11, 2, 1024, 1024, 6, masked=True)
    got = nn_sweep(x, y, xm, ym)
    d = torch.cdist(x.double(), y.double()).square()
    d = d.masked_fill(~ym[:, None, :], 1e10)
    top = torch.topk(d, 2, dim=2, largest=False)
    clear = top.values[..., 1] - top.values[..., 0] > 1e-5
    assert clear.float().mean() > 0.5
    assert (got[1].long() == top.indices[..., 0])[clear].all()


def test_launch_counter_and_cpu_rule(dev):
    x, y, _, _ = clouds(dev, 3, 2, 64, 64, 3, masked=False)
    before = nn_sweep.launches
    nn_sweep(x, y)
    assert nn_sweep.launches == before + 1
    nn_sweep(x.cpu(), y.cpu())  # the plain version: no launch
    assert nn_sweep.launches == before + 1


def test_kernel_rejects_what_it_does_not_take(dev):
    x = torch.rand(2, 16, 3, device=dev)
    with pytest.raises(TypeError):
        nn_sweep(x.double(), x.double())
    with pytest.raises(ValueError):
        nn_sweep(x.transpose(0, 1).contiguous().transpose(0, 1), x)
    with pytest.raises(ValueError):
        nn_sweep(torch.rand(2, 16, 9, device=dev), torch.rand(2, 16, 9, device=dev))
    with pytest.raises(ValueError):
        nn_sweep(x, x.cpu())


def test_chamfer_on_card_matches_cpu(dev):
    """Masked Chamfer within the 1e-5 guard. Every batch element keeps some
    valid x points: one without any would leave its y points no valid
    target, and their 1e10 distances in the mean."""
    x, y, xm, ym = clouds(dev, 5, 4, 2048, 2048, 6, masked=True)
    xm[-1, : 2048 // 2] = True
    got = chamfer_distance(x, y, xm, ym)
    want = chamfer_distance(x.cpu(), y.cpu(), xm.cpu(), ym.cpu())
    assert abs(float(got) - float(want)) <= 1e-5
