"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pointcloud_tpu_torch.ops import (
    chamfer_bwd,
    chamfer_bwd_reference,
    chamfer_distance,
    dense_pool_stats,
    dense_pool_stats_bwd,
    dense_pool_stats_reference,
    nn_sweep,
    nn_sweep_reference,
    scatter_rows,
    scatter_rows_reference,
)

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


# ---- the training slice's kernels ----

def seg_case(dev, seed, B=3, R=700, n=300, C=6, dtype=torch.float32):
    """Rows, indices (a third of them to target 3) and an fp32 init."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn((B, R, C), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, n, (B, R), generator=g, device=dev, dtype=torch.int32)
    idx[:, ::3] = 3
    init = torch.randn((B, n, C), generator=g, device=dev)
    return rows, idx, init


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_init", [False, True])
def test_scatter_rows_matches_plain_and_is_deterministic(dev, dtype, with_init):
    """1e-5 relative to the largest output: fp32 sums in another order."""
    rows, idx, init = seg_case(dev, 1, dtype=dtype)
    init = init if with_init else None
    got = scatter_rows(rows, idx, 300, init=init)
    again = scatter_rows(rows, idx, 300, init=init)
    want = scatter_rows_reference(rows, idx, 300, init)
    assert torch.equal(got, again)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_chamfer_bwd_matches_plain_and_is_deterministic(dev):
    """Masked clouds; 1e-5 relative to the largest gradient."""
    x, y, xm, ym = clouds(dev, 7, 3, 600, 500, 6, masked=True)
    _, ax, _, ay = nn_sweep(x, y, xm, ym)
    gx = torch.randn(3, 600, device=dev) * xm
    gy = torch.randn(3, 500, device=dev) * ym
    got = chamfer_bwd(x, y, gx, gy, ax, ay)
    again = chamfer_bwd(x, y, gx, gy, ax, ay)
    want = chamfer_bwd_reference(x, y, gx, gy, ax, ay)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert (a - w).abs().max() <= 1e-5 * w.abs().max()


def test_chamfer_gradients_on_card_match_cpu(dev):
    """Both backward routes (the switch lowered for the second) vs the CPU,
    1e-5 relative to the largest gradient."""
    from pointcloud_tpu_torch.ops import chamfer as tch

    x, y, xm, ym = clouds(dev, 8, 2, 512, 384, 6, masked=True)
    xm[-1, :256] = True
    grads = []
    for switch in (tch.FUSED_BWD_MAX_ELEMENTS, 0):
        old, tch.FUSED_BWD_MAX_ELEMENTS = tch.FUSED_BWD_MAX_ELEMENTS, switch
        try:
            for d in (dev, "cpu"):
                a = x.detach().to(d).clone().requires_grad_()
                b = y.detach().to(d).clone().requires_grad_()
                chamfer_distance(a, b, xm.to(d), ym.to(d)).backward()
                grads.append((a.grad.cpu(), b.grad.cpu()))
        finally:
            tch.FUSED_BWD_MAX_ELEMENTS = old
    for card, cpu in (grads[0:2], grads[2:4]):
        for g, w in zip(card, cpu):
            assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def dense_case(dev, seed, B, R, Cin, C, dtype, masked):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, R, Cin), generator=g, device=dev).to(dtype)
    w = (torch.randn((Cin, C), generator=g, device=dev) / Cin ** 0.5).to(dtype)
    b = (0.1 * torch.randn((C,), generator=g, device=dev)).to(dtype)
    s = torch.where(torch.rand((C,), generator=g, device=dev) > 0.3, 1.0, -1.0)
    pen = None
    if masked:
        keep = torch.rand((B, R), generator=g, device=dev) > 0.1
        keep[:, 0] = True
        pen = torch.where(keep, 0.0, 1e9)
    return x, w, b, s, pen


@pytest.mark.parametrize("shape", [(2, 256, 64, 256, 256), (2, 256, 128, 1024, 32),
                                   (3, 150, 72, 200, 30)])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_pool_stats_fp32_matches_plain(dev, shape, masked):
    """fp32: 1e-4 relative to the largest entry (summation order only);
    equal indices; the backward against autograd through the plain version
    at the kernel's own selection; two runs bit-equal."""
    B, R, Cin, C, pool = shape
    x, w, b, s, pen = dense_case(dev, 3, B, R, Cin, C, torch.float32, masked)
    got = dense_pool_stats(x, w, b, s, pen, pool)
    again = dense_pool_stats(x, w, b, s, pen, pool)
    want = dense_pool_stats_reference(x, w, b, s, pen, pool)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert torch.equal(got[1], want[1])
    for a, r in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        assert (a - r).abs().max() <= 1e-4 * r.abs().max()
    dp = torch.randn(got[0].shape, device=dev)
    ds = torch.randn((C,), device=dev) / (B * R)
    kern = dense_pool_stats_bwd(x, w, b, s, got[1], dp, ds, ds, pool)
    assert all(torch.equal(a, c) for a, c in zip(
        kern, dense_pool_stats_bwd(x, w, b, s, got[1], dp, ds, ds, pool)))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    out = dense_pool_stats_reference(*leaves, s, pen, pool)
    ref = torch.autograd.grad((out[0], out[2], out[3]), leaves, (dp, ds, ds))
    for a, r in zip(kern, ref):
        assert (a - r).abs().max() <= 1e-4 * r.abs().max()


def test_dense_pool_stats_bf16_within_one_ulp(dev):
    """bf16: psel within 1 bf16 ulp of |z| (accumulation order can flip one
    rounding), ssum/ssq within 1e-3 relative."""
    x, w, b, s, pen = dense_case(dev, 4, 2, 512, 128, 1024, torch.bfloat16, True)
    got = dense_pool_stats(x, w, b, s, pen, 512)
    want = dense_pool_stats_reference(x, w, b, s, pen, 512)
    ulp = torch.exp2(torch.floor(torch.log2(want[0].float().abs())) - 7)
    assert ((got[0].float() - want[0].float()).abs() <= ulp).all()
    for a, r in zip(got[2:], want[2:]):
        assert (a - r).abs().max() <= 1e-3 * r.abs().max()


def test_training_kernels_count_launches_and_keep_the_cpu_rule(dev):
    rows, idx, init = seg_case(dev, 2)
    x, w, b, s, _ = dense_case(dev, 5, 1, 64, 8, 16, torch.float32, False)
    before = (scatter_rows.launches, dense_pool_stats.launches,
              dense_pool_stats_bwd.launches)
    scatter_rows(rows, idx, 300)
    scatter_rows(rows.cpu(), idx.cpu(), 300)
    out = dense_pool_stats(x.requires_grad_(), w, b, s, None, 64)
    out[0].sum().backward()
    dense_pool_stats(x.detach().cpu(), w.cpu(), b.cpu(), s.cpu(), None, 64)
    assert (scatter_rows.launches, dense_pool_stats.launches,
            dense_pool_stats_bwd.launches) == tuple(v + 1 for v in before)


def test_training_kernels_reject_what_they_do_not_take(dev):
    rows, idx, init = seg_case(dev, 3)
    with pytest.raises(TypeError):
        scatter_rows(rows.double(), idx, 300)
    with pytest.raises(TypeError):
        scatter_rows(rows, idx.long(), 300)
    with pytest.raises(ValueError):
        scatter_rows(rows.transpose(0, 1).contiguous().transpose(0, 1), idx, 300)
    x, y, _, _ = clouds(dev, 4, 2, 64, 64, 3, masked=False)
    _, ax, _, ay = nn_sweep(x, y)
    gx, gy = torch.ones(2, 64, device=dev), torch.ones(2, 64, device=dev)
    with pytest.raises(TypeError):
        chamfer_bwd(x.double(), y.double(), gx, gy, ax, ay)
    with pytest.raises(ValueError):
        chamfer_bwd(torch.rand(2, 64, 9, device=dev), torch.rand(2, 64, 9, device=dev),
                    gx, gy, ax, ay)
    with pytest.raises(ValueError):
        chamfer_bwd(x, y, gx.t().contiguous().t(), gy, ax, ay)  # non-contiguous
    xd, wd, bd, sd, _ = dense_case(dev, 6, 2, 64, 8, 16, torch.float32, False)
    with pytest.raises(ValueError):
        dense_pool_stats(xd, wd, bd, sd, None, 48)  # 64 % 48 != 0
    with pytest.raises(TypeError):
        dense_pool_stats(xd.double(), wd.double(), bd.double(), sd, None, 64)
    with pytest.raises(TypeError):
        dense_pool_stats(xd.bfloat16(), wd, bd, sd, None, 64)  # mixed dtypes
    with pytest.raises(ValueError):
        dense_pool_stats(xd, wd.t().contiguous().t(), bd, sd, None, 64)
