"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. This file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pointcloud_tpu_torch.ops import (
    affine_scalars,
    ball_group,
    ball_group_plan,
    ball_group_reference,
    bn_pool,
    bn_pool_reference,
    bnact_mm_stats,
    bnact_mm_stats_reference,
    bwd_plan,
    chain_bwd_pass,
    chain_bwd_pass_reference,
    chain_da_reference,
    chain_dh_reference,
    chain_dw_reference,
    chamfer_bwd,
    chamfer_bwd_reference,
    chamfer_distance,
    dense_pool_stats,
    dense_pool_stats_bwd,
    dense_pool_stats_reference,
    emd_match,
    eps_schedule,
    farthest_point_sample,
    fps_plan,
    fps_reference,
    group_gather,
    group_gather_plan,
    group_gather_reference,
    knn_group,
    knn_group_plan,
    knn_group_reference,
    matching_difference,
    mlp_pool_bwd_reference,
    mlp_pool_fused,
    mlp_pool_reference,
    mm_stats,
    mm_stats_reference,
    nn_plan,
    nn_sweep,
    nn_sweep_reference,
    pool_bwd_plan,
    pool_fwd_plan,
    scatter_plan,
    scatter_rows,
    scatter_rows_mirror,
    scatter_rows_reference,
    sinkhorn,
    sinkhorn_match,
    sinkhorn_plan,
    sinkhorn_reference,
    preextract_pool_fused,
    preextract_pool_reference,
    up_scalars,
)
from pointcloud_tpu_torch.ops import preextract_fused as tpf
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT
from pointcloud_tpu_torch.ops.scatter_rows import PIECE

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


def seg_rows(dev, seed, B, R, n, C, dtype, crowd=0):
    """Rows and indices drawn with numpy (`crowd` of each cloud's first rows
    onto target 3) and an fp32 init, on the card."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((B, R, C)).astype(np.float32))
    idx = rng.integers(0, n, (B, R)).astype(np.int32)
    idx[:, :crowd] = 3
    init = torch.from_numpy(rng.standard_normal((B, n, C)).astype(np.float32))
    return g.to(dtype).to(dev), torch.from_numpy(idx).to(dev), init.to(dev)


def assert_scatter_exact(got, g, idx, n, init):
    """Bit-equal to the plain version on the CPU (index_add_ in row order)
    where no bucket holds more than PIECE rows, to the kernel's order
    (scatter_rows_mirror) everywhere, and within 1e-4 of the plain version."""
    want = scatter_rows_mirror(g.cpu(), idx.cpu(), n,
                               None if init is None else init.cpu())
    assert torch.equal(got.cpu(), want)
    plain = scatter_rows_reference(g.cpu(), idx.cpu(), n,
                                   None if init is None else init.cpu())
    assert (want - plain).abs().max() <= 1e-4 * plain.abs().max()


@pytest.mark.parametrize("C,dtype", [(1, torch.float32), (6, torch.float32),
                                     (131, torch.bfloat16), (512, torch.bfloat16),
                                     (37, torch.bfloat16), (64, torch.bfloat16),
                                     (320, torch.float32)])
def test_scatter_rows_widths_match_the_cpu_bit_for_bit(dev, C, dtype):
    """Every load width of the sum: fp32 and bf16 rows of 1 to 512 channels
    (C=37 and 131 bf16 rows start on 2-byte boundaries: a channel a lane,
    in 2 and 5 passes), with and without
    init, two runs bit-equal, bit-equal to the CPU's index_add_ (no long
    bucket here)."""
    g, idx, init = seg_rows(dev, C, 3, 2000, 300, C, dtype)
    for i in (None, init):
        got = scatter_rows(g, idx, 300, i)
        assert torch.equal(got, scatter_rows(g, idx, 300, i))
        assert_scatter_exact(got, g, idx, 300, i)


@pytest.mark.parametrize("C,dtype", [(6, torch.float32), (131, torch.bfloat16),
                                     (64, torch.bfloat16)])
def test_scatter_rows_one_bucket_holds_every_row(dev, C, dtype):
    """R = 4096 rows of each cloud onto one target: the block's groups sum
    pieces of PIECE rows in row order, added in piece order (the kernel's
    fixed-shape tree, scatter_rows_mirror), 1e-4 of index_add_; the other
    targets keep init."""
    g, idx, init = seg_rows(dev, 7, 2, 4096, 64, C, dtype, crowd=4096)
    got = scatter_rows(g, idx, 64, init)
    assert torch.equal(got, scatter_rows(g, idx, 64, init))
    assert_scatter_exact(got, g, idx, 64, init)
    others = torch.arange(64, device=dev) != 3
    assert torch.equal(got[:, others], init[:, others])


def test_scatter_rows_empty_targets_and_dropped_indices(dev):
    """Targets no row picks hold init (or zeros); rows whose index lies
    outside [0, n) are dropped, as the TPU kernel's one-hot rows drop them."""
    g, idx, init = seg_rows(dev, 9, 3, 700, 300, 6, torch.float32)
    idx[:, ::5] = torch.where(idx[:, ::5] % 2 == 0, -1, 300)  # outside [0, n)
    idx[idx == 17] = 18  # target 17 empty
    keep = (idx >= 0) & (idx < 300)
    for i in (None, init):
        got = scatter_rows(g, idx, 300, i)
        want = scatter_rows_reference((g * keep[..., None]).cpu(),
                                      torch.where(keep, idx, 0).cpu(), 300,
                                      None if i is None else i.cpu())
        assert torch.equal(got.cpu(), want)  # the CPU's order: zero rows change nothing
        assert torch.equal(got[:, 17], torch.zeros_like(got[:, 17]) if i is None
                           else i[:, 17])


def test_scatter_rows_one_cloud_of_65536_rows(dev):
    g, idx, init = seg_rows(dev, 11, 1, 65536, 8192, 8, torch.bfloat16)
    got = scatter_rows(g, idx, 8192, init)
    assert torch.equal(got, scatter_rows(g, idx, 8192, init))
    assert_scatter_exact(got, g, idx, 8192, init)


def test_scatter_rows_rows_of_a_misaligned_base(dev):
    """g starting 2 bytes past a 16-byte boundary: the plan's loads follow
    the base's alignment (a channel a lane), the result is unchanged."""
    g, idx, init = seg_rows(dev, 13, 2, 1000, 100, 64, torch.bfloat16)
    flat = torch.empty(g.numel() + 1, dtype=g.dtype, device=dev)
    shifted = flat[1:].view(g.shape)
    shifted.copy_(g)
    assert shifted.data_ptr() % 16 == 2
    assert scatter_plan(2, 1000, 100, 64, torch.bfloat16, align=2).vec == 1
    assert torch.equal(scatter_rows(shifted, idx, 100, init),
                       scatter_rows(g, idx, 100, init))


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
    """The one backward route at 2 x 512 x 384 and at 1 x 2560 x 2560 (N*M
    above the JAX package's 6<<20 switch) vs the CPU, 1e-5 relative to the
    largest gradient; one chamfer_bwd launch each."""
    grads = []
    for shape in ((8, 2, 512, 384), (9, 1, 2560, 2560)):
        x, y, xm, ym = clouds(dev, *shape, 6, masked=True)
        xm[-1, :256] = True
        for d in (dev, "cpu"):
            a = x.detach().to(d).clone().requires_grad_()
            b = y.detach().to(d).clone().requires_grad_()
            before = chamfer_bwd.launches
            chamfer_distance(a, b, xm.to(d), ym.to(d)).backward()
            assert chamfer_bwd.launches - before == (1 if d == dev else 0)
            grads.append((a.grad.cpu(), b.grad.cpu()))
    for card, cpu in (grads[0:2], grads[2:4]):
        for g, w in zip(card, cpu):
            assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def chamfer_mirror(x, y, gx, gy, ax, ay):
    """The kernel's order of sums on the CPU: scatter_rows_mirror of each
    direction's terms (buckets of up to 32 rows in row order, longer ones
    in pieces of 32 added in piece order)."""
    from pointcloud_tpu_torch.ops.chamfer_bwd import PIECE, nn_terms

    x, y, gx, gy, ax, ay = (t.cpu() for t in (x, y, gx, gy, ax, ay))
    tx, ty = nn_terms(x, y, gx, gy, ax, ay)
    return (scatter_rows_mirror(-ty, ay, x.shape[1], init=tx, piece=PIECE),
            scatter_rows_mirror(-tx, ax, y.shape[1], init=ty, piece=PIECE))


@pytest.mark.parametrize("case", ["masked", "collapsed", "4096", "global"])
def test_chamfer_bwd_routes_match_the_mirror(dev, case):
    """Masked 2 x 2048 x 2048 clouds, a collapsed y cloud (every y point
    within 1e-3 of x point 5: one bucket of 2,048 rows, 64 pieces), the
    4 x 4096 x 4096 route check and a pair past the shared memory (the
    global route): one launch, two runs bit-equal, bit-equal to the
    kernel's order on the CPU and within 1e-4 relative of the plain
    version."""
    from pointcloud_tpu_torch.ops import chamfer_bwd_plan

    B, N, M, C = {"masked": (2, 2048, 2048, 6), "collapsed": (2, 2048, 2048, 6),
                  "4096": (4, 4096, 4096, 6), "global": (1, 20000, 300, 3)}[case]
    x, y, xm, ym = clouds(dev, 21, B, N, M, C, masked=case == "masked")
    if case == "collapsed":
        y = x[:, 5:6] + 1e-3 * y
    _, ax, _, ay = nn_sweep(x, y, xm, ym)
    if case == "collapsed":
        assert (ay == 5).all()
    g = torch.Generator(device=dev).manual_seed(4)
    gx = torch.randn((B, N), generator=g, device=dev)
    gy = torch.randn((B, M), generator=g, device=dev)
    if xm is not None:
        gx, gy = gx * xm, gy * ym
    args = (x, y, gx, gy, ax, ay)
    assert chamfer_bwd_plan(B, N, M, C).route == ("global" if case == "global"
                                                  else "shared")
    before = chamfer_bwd.launches
    got = chamfer_bwd(*args)
    again = chamfer_bwd(*args)
    torch.cuda.synchronize()
    assert chamfer_bwd.launches - before == 2
    for a, b, m, w in zip(got, again, chamfer_mirror(*args),
                          chamfer_bwd_reference(*args)):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), m)
        assert (a - w).abs().max() <= 1e-4 * w.abs().max()


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


# ---- the PointNet2 slice's kernels ----

def fps_case(dev, seed, B, N, C=3, masked=True):
    """Unit-cube clouds; points N//2.. duplicate points 0.. (exact ties);
    with masks ~20% of points masked, point 0 masked in cloud 0 and every
    point masked in the last cloud."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand((B, N, C), generator=g, device=dev)
    xyz[:, N // 2 + N % 2:] = xyz[:, : N // 2]
    mask = None
    if masked:
        mask = torch.rand((B, N), generator=g, device=dev) > 0.2
        mask[0, 0] = False
        mask[-1] = False
    return xyz, mask


@pytest.mark.parametrize("B,N,K", [(4, 2048, 512), (3, 512, 128), (2, 5000, 300),
                                   (1, 20000, 256), (2, 100, 150), (1, 200000, 64)])
@pytest.mark.parametrize("masked", [False, True])
def test_fps_matches_plain_and_is_deterministic(dev, B, N, K, masked):
    """Equal indices (the same rounded operations in the same order); the
    block route (256 threads x 8 slots, 128 x 4, 512 x 12), the cluster route
    (N = 20000: two blocks), the global-scratch route (N > 196,608) and an
    under-full cloud (K > N)."""
    xyz, mask = fps_case(dev, N, B, N, masked=masked)
    got = farthest_point_sample(xyz, K, mask)
    again = farthest_point_sample(xyz, K, mask)
    torch.cuda.synchronize()
    want = fps_reference(xyz, K, mask)
    assert got.dtype == torch.int32 and got.shape == (B, K)
    assert torch.equal(got, again)
    assert torch.equal(got, want)
    if masked:
        assert (got[-1] == 0).all()  # no valid point: zeros
        assert bool(torch.gather(mask[:-1], 1, got[:-1].long()).all())


def test_fps_reads_xyz_of_wider_points(dev):
    xyz, mask = fps_case(dev, 7, 2, 700, C=6)
    assert torch.equal(farthest_point_sample(xyz, 64, mask),
                       farthest_point_sample(xyz[..., :3].contiguous(), 64, mask))


def ball_case(dev, seed, B, N, S, F, dtype, masked):
    """Unit-cube clouds, centroids on every (N // S)-th point, the last
    centroid far outside (an empty ball), ~1/3 of the points masked."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand((B, N, 3), generator=g, device=dev)
    feats = (torch.randn((B, N, F), generator=g, device=dev).to(dtype)
             if F else None)
    cents = xyz[:, :: N // S][:, :S].clone()
    cents[:, -1] += 5.0
    mask = torch.rand((B, N), generator=g, device=dev) > 0.33 if masked else None
    return xyz, feats, cents, mask


@pytest.mark.parametrize("N,S,k,F,radius", [(2048, 512, 32, 3, 0.2),
                                            (512, 128, 64, 128, 0.4),
                                            (300, 40, 5, 7, 0.3),
                                            (5000, 64, 24, 4, 0.1),
                                            (15000, 64, 24, 4, 0.05),
                                            (256, 16, 8, 0, 0.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_ball_group_matches_plain_and_is_deterministic(dev, N, S, k, F, radius,
                                                       dtype, masked):
    """Bit-equal outputs: the same membership test (rounded intrinsics in
    the plain version's order), the same gathers, one rounding of the
    centred xyz; the shared-memory and global paths; k not a multiple of 8;
    no features."""
    xyz, feats, cents, mask = ball_case(dev, N + k, 2, N, S, F, dtype, masked)
    got = ball_group(xyz, feats, cents, mask, k, radius)
    again = ball_group(xyz, feats, cents, mask, k, radius)
    torch.cuda.synchronize()
    want = ball_group_reference(xyz, feats, cents, mask, k, radius)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert got[1].shape == (2, S, k) and got[2].dtype == torch.bool
    assert (got[1][:, -1] == 0).all() and not got[2][:, -1].any()  # empty ball
    if not masked:
        assert got[2][:, :-1, 0].all()  # each centroid sits in its own ball


def test_pointnet2_kernels_count_launches_and_keep_the_cpu_rule(dev):
    xyz, feats, cents, mask = ball_case(dev, 1, 1, 256, 16, 3, torch.float32, True)
    before = (farthest_point_sample.launches, ball_group.launches)
    farthest_point_sample(xyz, 16, mask)
    farthest_point_sample(xyz.cpu(), 16, mask.cpu())
    ball_group(xyz, feats, cents, mask, 8, 0.3)
    ball_group(xyz.cpu(), feats.cpu(), cents.cpu(), mask.cpu(), 8, 0.3)
    assert (farthest_point_sample.launches, ball_group.launches) == tuple(
        v + 1 for v in before)


def test_pointnet2_kernels_reject_what_they_do_not_take(dev):
    xyz, feats, cents, mask = ball_case(dev, 2, 2, 256, 16, 3, torch.float32, True)
    with pytest.raises(TypeError):
        farthest_point_sample(xyz.double(), 16)
    with pytest.raises(ValueError):
        farthest_point_sample(xyz.transpose(0, 1).contiguous().transpose(0, 1), 16)
    with pytest.raises(TypeError):
        ball_group(xyz, feats.half(), cents, mask, 8, 0.3)
    with pytest.raises(TypeError):
        ball_group(xyz.bfloat16(), feats, cents, mask, 8, 0.3)
    with pytest.raises(ValueError):
        ball_group(xyz, feats.transpose(0, 1).contiguous().transpose(0, 1), cents,
                   mask, 8, 0.3)
    with pytest.raises(ValueError):
        ball_group(xyz, feats, cents, mask.cpu(), 8, 0.3)


@pytest.mark.parametrize("N,S,k,F,dtype,masked", [
    (2048, 37, 32, 3, torch.bfloat16, True),  # S not a multiple of a block's
    (512, 300, 64, 128, torch.bfloat16, False),
    (300, 40, 5, 7, torch.bfloat16, True),  # runs of 100 bytes: ragged ends
    (700, 33, 13, 0, torch.float32, True),  # no features, 156-byte runs
    (15000, 20, 24, 128, torch.float32, True),  # the global route
    (512, 128, 200, 3, torch.float32, False),  # k above every in-ball count
    (400, 24, 9, 129, torch.bfloat16, True),  # rows 2-byte past a word, odd F
    (300, 20, 6, 1100, torch.float32, False),  # a row wider than a 2 KB tile
])
def test_ball_group_staged_cloud_and_run_store(dev, N, S, k, F, dtype, masked):
    """Several blocks a cloud, centroids past the last full pair of a warp,
    runs not a multiple of 16 bytes, the global route, k above the in-ball
    count and an empty ball: idx, valid and grouped bit-equal to the plain
    version, two runs bit-equal."""
    xyz, feats, cents, mask = ball_case(dev, N + S + k, 2, N, S, F, dtype, masked)
    p = ball_group_plan(2, N, S, k, F, dtype)
    assert p.route == ("global" if N == 15000 else "shared")
    got = ball_group(xyz, feats, cents, mask, k, 0.2)
    again = ball_group(xyz, feats, cents, mask, k, 0.2)
    torch.cuda.synchronize()
    want = ball_group_reference(xyz, feats, cents, mask, k, 0.2)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert (got[1][:, -1] == 0).all() and not got[2][:, -1].any()  # empty ball
    if k == 200:
        assert not got[2][..., -1].any()  # no ball holds 200 points


@pytest.mark.parametrize("N,S,k,F,dtype,masked,radius", [
    (2048, 37, 781, 3, torch.bfloat16, True, 0.7),  # one past the shared slots
    (2048, 64, 1024, 128, torch.bfloat16, False, 0.8),
    (700, 20, 1024, 3, torch.float32, True, 0.6),  # k above N
    (15000, 8, 1024, 0, torch.float32, True, 0.3),  # the global route
])
def test_ball_group_takes_any_k(dev, N, S, k, F, dtype, masked, radius):
    """k past the 780 slots 32 warps hold in shared memory: the slots in the
    idx output; idx, valid and grouped bit-equal to the plain version, two
    runs bit-equal, balls fuller than 780 points."""
    xyz, feats, cents, mask = ball_case(dev, N + S + k, 2, N, S, F, dtype, masked)
    p = ball_group_plan(2, N, S, k, F, dtype)
    assert p.route == ("global-idx" if N == 15000 else "shared-idx")
    got = ball_group(xyz, feats, cents, mask, k, radius)
    again = ball_group(xyz, feats, cents, mask, k, radius)
    torch.cuda.synchronize()
    want = ball_group_reference(xyz, feats, cents, mask, k, radius)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert int(got[2].sum(-1).max()) > (780 if N > k else 300)
    assert (got[1][:, -1] == 0).all() and not got[2][:, -1].any()  # empty ball


@pytest.mark.parametrize("B,N,S,k,F,dtype,masked,with_xyz,radius", [
    (3, 4096, 37, 1807, 3, torch.bfloat16, True, True, 0.9),  # one past the slots
    (3, 2048, 20, 2048, 320, torch.bfloat16, False, False, 0.9),  # bulk rows
    (2, 1500, 10, 2048, 6, torch.float32, True, True, 0.9),  # k above N
    (2, 16000, 6, 1807, 3, torch.bfloat16, True, True, 0.5),  # the global route
])
def test_group_gather_takes_any_k(dev, B, N, S, k, F, dtype, masked, with_xyz, radius):
    """k past the 1,806 slots a warp's shared memory holds: the slots in the
    idx output; every output equal to the plain version's, two runs
    bit-equal, balls fuller than 1,806 points."""
    xyz, feats, cents, mask = route_case(dev, N + k + F, B, N, S, F, dtype, masked,
                                         far=True)
    row = F * (2 if dtype == torch.bfloat16 else 4)
    p = group_gather_plan(B, N, S, k, row, feature_word(F, dtype, feats), with_xyz)
    assert p.route == ("global-idx" if N == 16000 else "shared-idx")
    got = group_gather(xyz, feats, cents, mask, k, radius, with_xyz)
    again = group_gather(xyz, feats, cents, mask, k, radius, with_xyz)
    torch.cuda.synchronize()
    assert_equal_twice(got, again,
                       group_gather_reference(xyz, feats, cents, mask, k, radius, with_xyz))
    assert int(got[3].sum(-1).max()) > (1806 if N > k else 1000)
    assert (got[2][:, -1] == 0).all() and not got[3][:, -1].any()  # the empty ball


def test_ball_group_sa2_gradient_through_the_new_scatter(dev):
    """SA2's shape at B=4 (512 points, 128 centroids, k=64, 128 bf16
    features): the gradient is one scatter_rows of 131-channel bf16 rows
    (2-byte aligned, a channel a lane); equal to the CPU path's bit for bit
    where no bucket passes PIECE rows (fp32 sums of bf16 rows in row order),
    else within a bf16 ulp (1e-4 for fp32 xyz)."""
    xyz, feats, cents, _ = ball_case(dev, 21, 4, 512, 128, 128, torch.bfloat16, False)
    torch.manual_seed(1)
    cw = torch.randn((4, 128, 64, 131), device=dev)

    def grads(d):
        f = feats.to(d).clone().requires_grad_()
        x = xyz.to(d).clone().requires_grad_()
        g = ball_group(x, f, cents.to(d), None, 64, 0.4)[0]
        return torch.autograd.grad((g.float() * cw.to(d)).sum(), [x, f])

    before = scatter_rows.launches
    got = grads(dev)
    assert scatter_rows.launches == before + 1
    want = grads("cpu")
    idx = ball_group(xyz, feats, cents, None, 64, 0.4)[1].reshape(4, -1).long()
    idx = idx + 512 * torch.arange(4, device=dev)[:, None]
    long_bucket = int(torch.bincount(idx.flatten()).max()) > PIECE
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if not long_bucket:  # every bucket in the CPU's order
            assert torch.equal(g.cpu(), w)
        elif w.dtype == torch.bfloat16:  # one bf16 rounding of nearby fp32 sums
            ulp = torch.exp2(torch.floor(torch.log2(w.float().abs().clamp_min(1e-30))) - 7)
            assert ((g.cpu().float() - w.float()).abs() <= ulp + 1e-6).all()
        else:
            assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()


# ---- the PointNet2 train slice's kernels ----

def chain_case(dev, seed, B, R, layout, dtype, pool, masked=True):
    """x in dtype, fp32 weights, scales (some negative), offsets and pen; the
    last row of every group repeats its first (an exact tie, pen included)
    and, with masks, group 0 of cloud 0 has no valid row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, R, layout[0][0]), generator=g, device=dev).to(dtype)
    x4 = x.view(B, R // pool, pool, -1)
    x4[:, :, -1] = x4[:, :, 0]
    ws = [torch.randn(s, generator=g, device=dev) / s[0] ** 0.5 for s in layout]
    gs = [torch.where(torch.rand((s[1],), generator=g, device=dev) < 0.2, -1.0, 1.0)
          * (0.5 + torch.rand((s[1],), generator=g, device=dev)) for s in layout]
    bs = [0.1 * torch.randn((s[1],), generator=g, device=dev) for s in layout]
    pen = torch.zeros((B, R), device=dev)
    if masked:
        pen = torch.where(torch.rand((B, R), generator=g, device=dev) < 0.3, 1e9, 0.0)
        pen[0, :pool] = 1e9
        p3 = pen.view(B, R // pool, pool)
        p3[:, :, -1] = p3[:, :, 0]
    return x, ws, gs, bs, pen


def close_act(got, want):
    """fp32 1e-4 of the largest entry (summation order); bf16 one ulp of the
    entry (the order can flip its one rounding) plus 2e-6 of the largest."""
    g, w = got.float(), want.float()
    scale = w.abs().max()
    if want.dtype == torch.float32:
        tol = 1e-4 * scale
    else:
        tol = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7) \
            + 2e-6 * scale
    assert got.dtype == want.dtype and ((g - w).abs() <= tol).all()


def close_sums(got, want, dtype, bf16_tol=1e-3):
    tol = 1e-4 if dtype == torch.float32 else bf16_tol
    assert (got - want).abs().max() <= tol * want.abs().max()


CHAINS = [(2, 48, [(9, 16), (16, 16), (16, 24)], 4),
          (2, 1024, [(6, 64), (64, 64), (64, 128)], 32),
          (3, 640, [(131, 128), (128, 200), (200, 72)], 128),
          (2, 128, [(259, 256), (256, 512), (512, 1024)], 128),
          (2, 96, [(259, 40)], 32)]


@pytest.mark.parametrize("case", CHAINS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("final_relu", [True, False])
def test_chain_passes_match_plain_and_are_deterministic(dev, case, dtype, final_relu):
    """Each of the four kernels against its plain version on the same
    inputs, each twice: h by `close_act`, sums 1e-4 / 1e-3 relative, the
    pool's four outputs exactly equal (ties to the lowest row, -1e9 on
    exactly the groups without a valid row), dzd by `close_act`, dw 1e-4 /
    1e-3 relative (the same dh bits on both sides), sd / se 1e-4 / 5e-3: they
    sum the rounded dzd, whose entries differ by a bf16 ulp where the
    summation order flipped a rounding, and the sums cancel."""
    B, R, layout, pool = case
    x, ws, gs, bs, pen = chain_case(dev, R, B, R, layout, dtype, pool)
    n, L = B * R, len(layout)
    ws_c = [w.to(dtype) for w in ws]
    hs, scs = [], []
    for u in range(L):
        fn, ref = ((bnact_mm_stats, bnact_mm_stats_reference) if u
                   else (mm_stats, mm_stats_reference))
        args = (hs[-1], scs[-1], ws_c[u]) if u else (x, ws_c[0])
        got, again, want = fn(*args), fn(*args), ref(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        close_act(got[0], want[0])
        close_sums(got[1], want[1], dtype)
        close_sums(got[2], want[2], dtype)
        hs.append(got[0])
        scs.append(affine_scalars(got[1], got[2], gs[u], bs[u], n))
    pooled = bn_pool(hs[-1], scs[-1], pen, pool, final_relu)
    for a, w in zip(pooled, bn_pool_reference(hs[-1], scs[-1], pen, pool, final_relu)):
        assert a.dtype == w.dtype and torch.equal(a, w)
    out, maxv, amax, hsel = pooled
    assert not (amax == pool - 1).any()  # the tie went to the lower row
    empty = ~(pen.view(B, R // pool, pool) == 0).any(dim=2)
    assert empty[0, 0] and torch.equal(out.float() < -5e8,
                                       empty[..., None].expand_as(out))

    dout = torch.randn(out.shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(R)).to(dtype)
    dosel = dout.float() * (maxv > (0.0 if final_relu else -5e8))
    sd = dosel.sum(dim=(0, 1))
    se = (dosel * ((hsel - scs[-1][0]) * scs[-1][3])).sum(dim=(0, 1))
    dz = None
    for u in range(L - 1, -1, -1):
        uc = up_scalars(scs[u], gs[u], sd, se, n)
        kw = dict(dosel=dosel, amax=amax, pool=pool) if u == L - 1 else dict(dz=dz)
        args = (hs[u], uc, ws_c[u], hs[u - 1] if u else x, scs[u - 1] if u else None)
        got, again = chain_bwd_pass(*args, **kw), chain_bwd_pass(*args, **kw)
        want = chain_bwd_pass_reference(*args, **kw)
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(got, again))
        close_act(got[0], want[0])
        close_sums(got[3], want[3], dtype)
        if u:
            close_sums(got[1], want[1], dtype, bf16_tol=5e-3)
            close_sums(got[2], want[2], dtype, bf16_tol=5e-3)
            dz, sd, se = got[:3]
        else:
            assert got[1] is None and got[2] is None
            dw_only = chain_bwd_pass(*args, need_dzd=False, **kw)
            assert dw_only[0] is None and torch.equal(dw_only[3], got[3])


@pytest.mark.parametrize("case", CHAINS[:3])
def test_mlp_pool_fused_fp32_matches_the_plain_chain(dev, case):
    """The whole chain and its autograd against the plain version and its
    autograd, fp32, 2e-4 of each tensor's largest entry (summation order
    through three BatchNorms); no mask, so that no pooled maximum sits at a
    planted tie's mercy; the statistics carry no gradient."""
    B, R, layout, pool = case
    x, ws, gs, bs, pen = chain_case(dev, 7, B, R, layout, torch.float32, pool,
                                    masked=False)
    torch.manual_seed(R)
    x = torch.randn_like(x)  # no planted ties: both sides route alike
    cw = torch.randn((B, R // pool, layout[-1][1]), device=dev)
    res = []
    for fn in (mlp_pool_fused, mlp_pool_reference):
        leaves = [t.clone().requires_grad_() for t in (x, *ws, *gs, *bs)]
        L = len(ws)
        out, stats = fn(leaves[0], leaves[1:1 + L], leaves[1 + L:1 + 2 * L],
                        leaves[1 + 2 * L:], pen, pool)
        res.append((out, stats, torch.autograd.grad((out * cw).sum(), leaves)))
    (out, stats, grads), (rout, rstats, rgrads) = res
    assert not stats[0][0].requires_grad and rstats[0][0].requires_grad
    assert (out - rout).abs().max() <= 2e-4 * rout.abs().max()
    for (a, b), (ra, rb) in zip(stats, rstats):
        assert (a - ra).abs().max() <= 1e-4 * ra.abs().max()
        assert (b - rb).abs().max() <= 1e-4 * rb.abs().max()
    for g, r in zip(grads, rgrads):
        assert (g - r).abs().max() <= 2e-4 * r.abs().max()


def test_mlp_pool_fused_bf16_follows_the_explicit_backward(dev):
    """bf16 at the SA1 widths: pooled outputs within 2e-2, gradients within
    3e-2 of each tensor's largest entry of `mlp_pool_bwd_reference`, which
    rounds where the kernels round (a flipped rounding of an 8-bit h moves
    entries by a bf16 step of the largest summand)."""
    B, R, layout, pool = CHAINS[1]
    x, ws, gs, bs, pen = chain_case(dev, 9, B, R, layout, torch.bfloat16, pool)
    leaves = [t.clone().requires_grad_() for t in (x, *ws, *gs, *bs)]
    out, _ = mlp_pool_fused(leaves[0], leaves[1:4], leaves[4:7], leaves[7:], pen, pool)
    rout, _ = mlp_pool_reference(x, ws, gs, bs, pen, pool)
    assert out.dtype == torch.bfloat16
    live = rout.float() > -5e8
    assert torch.equal(out.float() > -5e8, live)
    assert ((out.float() - rout.float()).abs()[live]
            <= 2e-2 * (1 + rout.float().abs()[live])).all()
    torch.manual_seed(0)
    dout = (torch.randn(out.shape, device=dev) * live).to(torch.bfloat16)
    grads = torch.autograd.grad(out, leaves, dout)
    dx, dws, dgs, dbs = mlp_pool_bwd_reference(x, ws, gs, bs, pen, pool, dout)
    assert grads[0].dtype == torch.bfloat16 and grads[1].dtype == torch.float32
    for g, r in zip(grads, (dx, *dws, *dgs, *dbs)):
        assert (g.float() - r.float()).abs().max() <= 3e-2 * r.float().abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ball_group_gradient_matches_the_cpu_path(dev, dtype):
    """One scatter_rows launch per backward; fp32 gradients 1e-5 relative to
    the largest (summation order), bf16 feature gradients within one bf16
    ulp; in fp32 also against autograd through the plain version."""
    xyz, feats, cents, mask = ball_case(dev, 3, 2, 512, 64, 6, dtype, True)
    torch.manual_seed(0)
    cw = torch.randn((2, 64, 16, 9), device=dev)

    def grads(fn, d):
        leaves = [t.to(d).clone().requires_grad_() for t in (xyz, feats, cents)]
        g = fn(*leaves, mask.to(d), 16, 0.3)[0]
        return [t.to(dev) for t in torch.autograd.grad((g.float() * cw.to(d)).sum(),
                                                       leaves)]

    before = (ball_group.launches, scatter_rows.launches)
    got = grads(ball_group, dev)
    assert (ball_group.launches, scatter_rows.launches) == (before[0] + 1,
                                                            before[1] + 1)
    assert all(torch.equal(a, b) for a, b in zip(got, grads(ball_group, dev)))
    refs = [grads(ball_group, "cpu")]
    if dtype == torch.float32:
        refs.append(grads(ball_group_reference, dev))
    for want in refs:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            if w.dtype == torch.bfloat16:
                ulp = torch.exp2(torch.floor(torch.log2(
                    w.float().abs().clamp_min(1e-30))) - 7)
                assert ((g.float() - w.float()).abs() <= ulp + 1e-6).all()
            else:
                assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    # a gradient for the features alone: the set-abstraction train path
    f = feats.clone().requires_grad_()
    g = ball_group(xyz, f, cents, mask, 16, 0.3)[0]
    (df,) = torch.autograd.grad((g.float() * cw).sum(), [f])
    assert torch.equal(df, got[1])


def test_chain_kernels_count_launches_and_keep_the_cpu_rule(dev):
    x, ws, gs, bs, pen = chain_case(dev, 1, 2, 48, CHAINS[0][2], torch.float32, 4)
    leaves = [t.clone().requires_grad_() for t in (x, *ws, *gs, *bs)]
    names = (mm_stats, bnact_mm_stats, bn_pool, chain_bwd_pass)
    before = [f.launches for f in names]
    out, _ = mlp_pool_fused(leaves[0], leaves[1:4], leaves[4:7], leaves[7:], pen, 4)
    assert [f.launches for f in names] == [before[0] + 1, before[1] + 2,
                                           before[2] + 1, before[3]]
    out.sum().backward()
    assert chain_bwd_pass.launches == before[3] + 3
    cpu = [t.detach().cpu() for t in (x, *ws, *gs, *bs)]
    mlp_pool_fused(cpu[0], cpu[1:4], cpu[4:7], cpu[7:], pen.cpu(), 4)
    assert [f.launches for f in names] == [before[0] + 1, before[1] + 2,
                                           before[2] + 1, before[3] + 3]


def test_chain_kernels_reject_what_they_do_not_take(dev):
    x, ws, gs, bs, pen = chain_case(dev, 2, 2, 48, CHAINS[0][2], torch.float32, 4)
    h, ss, sq = mm_stats(x, ws[0])
    sc = affine_scalars(ss, sq, gs[0], bs[0], 96)
    with pytest.raises(TypeError):
        mm_stats(x.bfloat16(), ws[0])  # mixed dtypes
    with pytest.raises(TypeError):
        mm_stats(x.double(), ws[0].double())
    with pytest.raises(ValueError):
        mm_stats(x.transpose(0, 1).contiguous().transpose(0, 1), ws[0])
    with pytest.raises(ValueError):
        mm_stats(x, ws[0].cpu())
    with pytest.raises(TypeError):
        bnact_mm_stats(h, sc.double(), ws[1])
    with pytest.raises(ValueError):
        bn_pool(h, sc, pen, 5)
    with pytest.raises(TypeError):
        bn_pool(h, sc, pen.double(), 4)
    with pytest.raises(ValueError):
        mlp_pool_fused(x, ws, gs, bs, pen.cpu(), 4)
    with pytest.raises(TypeError):
        chain_bwd_pass(h, torch.zeros(4, 16, device=dev), ws[0], x,
                       dosel=torch.zeros(2, 12, 16, device=dev),
                       amax=torch.zeros(2, 12, 16, device=dev, dtype=torch.int64),
                       pool=4)


# ---- the chain's backward pass, stage by stage ----

# (B, R, Cd, Cu, pool, kind, res_mode, skip): a sparse top layer below a
# BatchNorm and at the input (depths 6, 131, 259; ragged widths 130, 200,
# 72, also below a BatchNorm), dense layers, the three residual modes with
# both skip shares at mid width 16 and at width 1024, a pool of 24
# straddling 128-row tiles
STAGE_CASES = [
    (2, 48, 16, 24, 4, "sparse", tpf.RES_NONE, None),
    (4, 1024, 6, 64, 32, "dense", None, None),
    (3, 640, 131, 128, 128, "dense", None, None),
    (3, 640, 128, 200, 128, "dense", tpf.RES_NONE, None),
    (3, 640, 200, 72, 128, "sparse", tpf.RES_NONE, None),
    (2, 128, 259, 256, 128, "dense", None, None),
    (2, 96, 259, 40, 32, "sparse", None, None),
    (2, 96, 24, 130, 4, "sparse", tpf.RES_NONE, None),
    (2, 72, 64, 16, 24, "dense", tpf.RES_BNRELU, "pool"),
    (2, 72, 16, 64, 24, "dense", tpf.RES_NONE, "dense"),
    (4, 24 * 40, 128, 128, 24, "dense", tpf.RES_DENSE, "dense"),
    (2, 24 * 8, 1024, 1024, 24, "dense", tpf.RES_BNRELU, "pool"),
    (2, 24 * 8, 1027, 1024, 24, "dense", None, None),
    # a ragged width below a BatchNorm (the epilogue's one-channel path)
    (2, 72, 130, 64, 24, "dense", tpf.RES_BNRELU, "pool"),
    (2, 96, 130, 40, 4, "sparse", tpf.RES_NONE, None),
]


def stage_inputs(dev, seed, B, R, Cd, Cu, pool, kind, res_mode, skip, dtype):
    """Arguments of one backward pass on the card: activations ~ N(0, 1) in
    dtype, BatchNorm scalars of random statistics (some scales negative),
    a pooled cotangent at random rows or a dense one."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = B * R

    def act(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def scalars(C):
        gamma = torch.where(torch.rand(C, generator=g, device=dev) < 0.2, -1.0, 1.0) \
            * (0.5 + torch.rand(C, generator=g, device=dev))
        ssum = 0.1 * n * torch.randn(C, generator=g, device=dev)
        ssq = n * (0.5 + torch.rand(C, generator=g, device=dev))
        return affine_scalars(ssum, ssq, gamma, 0.1 * torch.randn(
            C, generator=g, device=dev), n), gamma

    h_up, a_in, w = act(B, R, Cu), act(B, R, Cd), act(Cd, Cu) / Cd ** 0.5
    sc_up, gamma = scalars(Cu)
    uc = up_scalars(sc_up, gamma, torch.randn(Cu, generator=g, device=dev),
                    torch.randn(Cu, generator=g, device=dev), n)
    kw = dict(pool=pool)
    if kind == "sparse":
        kw["dosel"] = torch.randn((B, R // pool, Cu), generator=g, device=dev)
        kw["amax"] = torch.randint(0, pool, (B, R // pool, Cu), generator=g,
                                   device=dev, dtype=torch.int32)
    else:
        kw["dz"] = act(B, R, Cu)
    sc_down = None
    if res_mode is not None:
        sc_down = scalars(Cd)[0]
        if res_mode == tpf.RES_BNRELU:
            kw["res"] = (act(B, R, Cd), scalars(Cd)[0])
        elif res_mode == tpf.RES_DENSE:
            kw["res"] = torch.relu(act(B, R, Cd))
        if skip == "pool":
            kw["skip_pool"] = (torch.randn((B, R // pool, Cd), generator=g, device=dev),
                               torch.randint(0, pool, (B, R // pool, Cd), generator=g,
                                             device=dev, dtype=torch.int32))
        elif skip == "dense":
            kw["skip_dense"] = act(B, R, Cd)
    return (h_up, uc, w.contiguous(), a_in, sc_down), kw


@pytest.mark.parametrize("case", STAGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_bwd_stages_match_their_plain_stages(dev, case, dtype):
    """Each stage kernel of `chain_bwd_pass` against its plain stage on the
    same inputs, each twice and bit-equal: dh bit-equal (the pad channels
    0), dzd within one ulp (`close_act`), a_up bit-equal, sd / se 1e-4 /
    5e-3 and dw 1e-4 / 1e-3 relative (summation order); then the whole pass
    against `chain_bwd_pass_reference`."""
    B, R, Cd, Cu, pool, kind, res_mode, skip = case
    (h_up, uc, w, a_in, sc_down), kw = stage_inputs(dev, sum(case[:5]), *case, dtype)
    rows = B * R
    plan = bwd_plan(rows, Cd, Cu, dtype == torch.bfloat16, sc_down is None)
    sparse = {k: kw.get(k) for k in ("dz", "dosel", "amax")}

    def twice(fn):
        got, again = fn(), fn()
        got_t = got if isinstance(got, tuple) else (got,)
        again_t = again if isinstance(again, tuple) else (again,)
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(got_t, again_t))
        return got

    dh = twice(lambda: tpf._bwd_dh(plan, h_up, uc, pool=pool, **sparse))
    want_dh = chain_dh_reference(h_up, uc, pool=pool, **sparse)
    assert dh.dtype == dtype and dh.shape == (rows, plan.ldh)
    assert torch.equal(dh[:, :Cu].reshape(B, R, Cu), want_dh)
    assert not bool(dh[:, Cu:].float().abs().sum())
    joins = {k: kw.get(k) for k in ("res", "skip_pool", "skip_dense")}
    for need in ((True, False) if sc_down is None else (True,)):
        dzd, sdse, a_up = twice(lambda: tpf._bwd_da(plan, dh, w, a_in, sc_down, need,
                                                    pool=pool, **joins))
        w_dzd, w_sd, w_se, w_aup = chain_da_reference(want_dh, w, a_in, sc_down, need,
                                                      pool=pool, **joins)
        if need:
            close_act(dzd, w_dzd)
        else:
            assert dzd is None
        assert torch.equal(a_up[:, :Cd].reshape(B, R, Cd), w_aup)
        if sc_down is not None:
            close_sums(sdse[0], w_sd, dtype, bf16_tol=5e-3)
            close_sums(sdse[1], w_se, dtype, bf16_tol=5e-3)
        dw = twice(lambda: tpf._bwd_dw(plan, dh, a_up))
        close_sums(dw, chain_dw_reference(w_aup, want_dh), dtype)
    got = chain_bwd_pass(h_up, uc, w, a_in, sc_down, **kw)
    want = chain_bwd_pass_reference(h_up, uc, w, a_in, sc_down, **kw)
    close_act(got[0], want[0])
    close_sums(got[3], want[3], dtype)


def test_chain_bwd_stage_kernels_reject_what_they_do_not_take(dev):
    """A plan whose chunks are no whole tiles, or padded strides that are
    no multiple of 8, make the launch fail rather than run."""
    (h_up, uc, w, a_in, sc_down), kw = stage_inputs(
        dev, 0, 2, 128, 64, 64, 4, "dense", tpf.RES_NONE, None, torch.bfloat16)
    plan = bwd_plan(256, 64, 64, True, False)
    dh = tpf._bwd_dh(plan, h_up, uc, kw["dz"])
    with pytest.raises(RuntimeError, match="da kernel launch failed"):
        tpf._bwd_da(plan._replace(da_chunk_rows=100), dh, w, a_in, sc_down)
    with pytest.raises(RuntimeError, match="dh kernel launch failed"):
        tpf._bwd_dh(plan._replace(ldh=60), h_up, uc, kw["dz"])
    with pytest.raises(RuntimeError, match="dw kernel launch failed"):
        tpf._bwd_dw(plan._replace(dw_chunk_rows=96), dh, dh)


# ---- the chain's forward products on TMA + wgmma ----

# (B, R, Cd, Cu, mode, write_r), mode: "input" (layer 0, no BatchNorm),
# RES_NONE / RES_BNRELU / RES_DENSE below a BatchNorm. Ragged input depths
# (6, 10, 131, 643), narrow outputs (8, 16), row counts that are no multiple
# of a panel (150, 1000), cd = cu = 1024 (64-row panels), every residual
# mode with write_r; the last two are widths the plan leaves on the tile
# kernel (cu, or cd below a BatchNorm, no multiple of 8).
FWD_CASES = [
    (3, 50, 6, 64, "input", False),
    (2, 75, 10, 8, "input", False),
    (4, 250, 131, 128, "input", False),
    (2, 96, 643, 256, "input", False),
    (3, 50, 64, 16, tpf.RES_NONE, False),
    (3, 50, 16, 64, tpf.RES_NONE, False),
    (2, 96, 1024, 1024, tpf.RES_NONE, False),
    (2, 96, 1024, 1024, tpf.RES_BNRELU, True),
    (4, 250, 128, 128, tpf.RES_BNRELU, True),
    (3, 50, 256, 256, tpf.RES_DENSE, True),
    (2, 75, 200, 72, tpf.RES_DENSE, False),
    (2, 96, 24, 130, tpf.RES_NONE, False),
    (2, 96, 130, 40, tpf.RES_BNRELU, True),
]


def fwd_inputs(dev, seed, B, R, Cd, Cu, mode, dtype):
    """Arguments of one forward product pass on the card: the input ~ N(0,
    1) in dtype, w ~ N(0, 1 / Cd), BatchNorm scalars of random statistics
    (some scales negative), a residual (h0 with its scalars, or a stored
    r >= 0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = B * R

    def scalars(C):
        gamma = torch.where(torch.rand(C, generator=g, device=dev) < 0.2, -1.0, 1.0) \
            * (0.5 + torch.rand(C, generator=g, device=dev))
        ssum = 0.1 * n * torch.randn(C, generator=g, device=dev)
        ssq = n * (0.5 + torch.rand(C, generator=g, device=dev))
        return affine_scalars(ssum, ssq, gamma, 0.1 * torch.randn(
            C, generator=g, device=dev), n)

    x = torch.randn((B, R, Cd), generator=g, device=dev).to(dtype)
    w = (torch.randn((Cd, Cu), generator=g, device=dev) / Cd ** 0.5).to(dtype)
    if mode == "input":
        return (x, w), {}
    res = None
    if mode == tpf.RES_BNRELU:
        res = (torch.randn((B, R, Cd), generator=g, device=dev).to(dtype), scalars(Cd))
    elif mode == tpf.RES_DENSE:
        res = torch.relu(torch.randn((B, R, Cd), generator=g, device=dev)).to(dtype)
    return (x, scalars(Cd), w), {"res": res}


@pytest.mark.parametrize("sms", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FWD_CASES)
def test_fwd_products_match_plain_and_are_deterministic(dev, case, dtype, sms,
                                                        monkeypatch):
    """mm_stats / bnact_mm_stats against their plain versions on the same
    inputs, each twice and bit-equal: h by `close_act` (fp32 accumulations
    in another order), ssum / ssq 1e-4 / 1e-3 relative, the stored layer
    input r exactly equal. bf16 takes the TMA + wgmma kernel at every width
    fwd_plan gives it (asserted) and the tile kernel elsewhere; with `sms`
    the plan is made for a card of 3 SMs, so that a block walks several
    panels and the launch several chunks."""
    B, R, Cd, Cu, mode, write_r = case
    if sms is not None:
        monkeypatch.setattr(tpf, "sm_count", lambda index: sms)
    args, kw = fwd_inputs(dev, sum(case[:4]), B, R, Cd, Cu, mode, dtype)
    plan = tpf.fwd_plan(B * R, Cd, Cu, dtype == torch.bfloat16, mode == "input",
                        sms or tpf.sm_count(dev.index))
    wgmma = dtype == torch.bfloat16 and Cu % 8 == 0 and (mode == "input" or Cd % 8 == 0)
    assert (plan.panel_rows > 0) == wgmma
    if sms is not None and wgmma:
        assert plan.chunks > 1 or plan.chunk_rows > plan.panel_rows
    if mode == "input":
        fn, ref = mm_stats, mm_stats_reference
    else:
        fn, ref = bnact_mm_stats, bnact_mm_stats_reference
        kw["write_r"] = write_r
    before = fn.launches
    got, again = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref(*args, **kw)
    assert len(got) == len(want) == 3 + int(write_r)
    close_act(got[0], want[0])
    close_sums(got[1], want[1], dtype)
    close_sums(got[2], want[2], dtype)
    if write_r:
        assert got[3].dtype == dtype and torch.equal(got[3], want[3])


def test_fwd_kernel_rejects_what_it_does_not_take(dev, monkeypatch):
    """A plan whose chunks are no whole panels, or with more panel slots or
    fewer ring stages than the kernel has, makes the launch fail rather than
    run."""
    (x, sc, w), _ = fwd_inputs(dev, 0, 2, 128, 64, 64, tpf.RES_NONE, torch.bfloat16)
    plan = tpf.fwd_plan(256, 64, 64, True, False, tpf.sm_count(dev.index))
    for bad in (plan._replace(chunk_rows=100), plan._replace(slots=9),
                plan._replace(stages=0)):
        monkeypatch.setattr(tpf, "fwd_plan", lambda *a, _p=bad: _p)
        with pytest.raises(RuntimeError, match="product kernel launch failed"):
            tpf._mm_stats_kernel(x, sc, w)


# ---- the PointMLP train slice's kernels: the chain's residual mode ----

# (B, R, layout, pool): PointMLP-Elite's mid width 16 with a pool of 24 over
# 144 rows (a group straddles the 64-row tiles); two blocks; three blocks
# (RES_DENSE inside the stack and in the backward); the first and last
# stages' widths of PointMLP and Elite's first, with fewer rows
RES_CHAINS = [(2, 72, [(12, 64), (64, 16), (16, 64)], 24),
              (2, 48, [(10, 16)] + [(16, 16)] * 4, 4),
              (1, 96, [(6, 8)] + [(8, 8)] * 6, 4),
              (4, 24 * 40, [(128, 128)] + [(128, 128)] * 4, 24),
              (2, 24 * 8, [(1024, 1024)] + [(1024, 1024)] * 4, 24),
              (4, 24 * 40, [(64, 64), (64, 16), (16, 64)], 24)]


def checked_passes(dtype):
    """The chain's passes as kernel-vs-plain checks on the same inputs, each
    kernel twice and bit-equal: h by `close_act`, sums as
    test_chain_passes_match_plain_and_are_deterministic, the stored residual
    r and the pool's four outputs exactly equal, dzd by `close_act`, dw
    1e-4 / 1e-3 and sd / se 1e-4 / 5e-3 relative. They return the kernel's
    results, so the kernel chain's own tensors feed the next pass."""
    def twice(fn, *a, **kw):
        got, again = fn(*a, **kw), fn(*a, **kw)
        assert all((g is None and h is None) or torch.equal(g, h)
                   for g, h in zip(got, again))
        return got

    def product(kernel, ref):
        def run(*a, **kw):
            got, want = twice(kernel, *a, **kw), ref(*a, **kw)
            close_act(got[0], want[0])
            close_sums(got[1], want[1], dtype)
            close_sums(got[2], want[2], dtype)
            if len(got) == 4:  # write_r: the staged layer input, bit for bit
                assert torch.equal(got[3], want[3])
            return got
        return run

    def pool(*a, **kw):
        got, want = twice(bn_pool, *a, **kw), bn_pool_reference(*a, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        return got

    def bwd(*a, **kw):
        got, want = twice(chain_bwd_pass, *a, **kw), chain_bwd_pass_reference(*a, **kw)
        if got[0] is not None:
            close_act(got[0], want[0])
        close_sums(got[3], want[3], dtype)
        if got[1] is not None:
            close_sums(got[1], want[1], dtype, bf16_tol=5e-3)
            close_sums(got[2], want[2], dtype, bf16_tol=5e-3)
        return got

    return (product(mm_stats, mm_stats_reference),
            product(bnact_mm_stats, bnact_mm_stats_reference), pool), bwd


@pytest.mark.parametrize("case", RES_CHAINS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_chain_passes_match_plain_and_are_deterministic(dev, case, dtype):
    """Every pass of the residual chain, forward and backward, against its
    plain version on the same inputs (`checked_passes`), walked as the
    chain walks them; planted ties (the last row of every group repeats its
    first) go to the lower row."""
    B, R, layout, pool = case
    x, ws, gs, bs, _ = chain_case(dev, R + len(layout), B, R, layout, dtype, pool,
                                  masked=False)
    passes, bwd = checked_passes(dtype)
    out, _, saved = tpf._chain_forward(x, ws, gs, bs, None, pool, True, passes,
                                       residual=True)
    amax = saved[5]
    assert out.dtype == dtype and not (amax == pool - 1).any()
    dout = torch.randn(out.shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(R)).to(dtype)
    tpf._chain_backward(x, gs, saved, dout, pool, True, True, bwd, residual=True)


@pytest.mark.parametrize("case", RES_CHAINS[:3])
def test_preextract_pool_fused_fp32_matches_the_plain_chain(dev, case):
    """The whole residual chain and its autograd against the plain version
    and its autograd, fp32, 2e-4 of each tensor's largest entry; no planted
    ties; two runs bit-equal; the statistics carry no gradient; one launch
    of each forward pass per layer and one backward pass per layer."""
    B, R, layout, pool = case
    x, ws, gs, bs, _ = chain_case(dev, 11, B, R, layout, torch.float32, pool,
                                  masked=False)
    torch.manual_seed(R)
    x = torch.randn_like(x)
    cw = torch.randn((B, R // pool, layout[-1][1]), device=dev)
    L = len(ws)
    names = (mm_stats, bnact_mm_stats, bn_pool, chain_bwd_pass)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (x, *ws, *gs, *bs)]
        out, stats = fn(leaves[0], leaves[1:1 + L], leaves[1 + L:1 + 2 * L],
                        leaves[1 + 2 * L:], pool)
        return out, stats, torch.autograd.grad((out * cw).sum(), leaves)

    before = [f.launches for f in names]
    out, stats, grads = run(preextract_pool_fused)
    assert [f.launches - b for f, b in zip(names, before)] == [1, L - 1, 1, L]
    again = run(preextract_pool_fused)
    assert torch.equal(out, again[0]) and all(
        torch.equal(a, b) for a, b in zip(grads, again[2]))
    rout, rstats, rgrads = run(preextract_pool_reference)
    assert not stats[0][0].requires_grad and rstats[0][0].requires_grad
    assert (out - rout).abs().max() <= 2e-4 * rout.abs().max()
    for (a, b), (ra, rb) in zip(stats, rstats):
        assert (a - ra).abs().max() <= 1e-4 * ra.abs().max()
        assert (b - rb).abs().max() <= 1e-4 * rb.abs().max()
    for g, r in zip(grads, rgrads):
        assert (g - r).abs().max() <= 2e-4 * r.abs().max()


@pytest.mark.parametrize("case", [RES_CHAINS[0], RES_CHAINS[3]])
def test_preextract_pool_fused_bf16_follows_the_explicit_backward(dev, case):
    """bf16: autograd through preextract_pool_fused against the explicit
    backward (`chain_bwd_pass_reference` walked by `_chain_backward`, which
    rounds where the kernels round) on the kernel chain's own forward
    tensors, within 3e-2 of each tensor's largest entry; the pooled output
    within 2e-2 of the plain chain's. (Against the plain forward's tensors
    a pool may pick another row: a bf16 h differs by an ulp where the
    summation order flips a rounding, and at PointMLP's stage-1 widths one
    dx entry then moves by a whole pooled gradient, measured.)"""
    B, R, layout, pool = case
    x, ws, gs, bs, _ = chain_case(dev, 13, B, R, layout, torch.bfloat16, pool,
                                  masked=False)
    L = len(ws)
    leaves = [t.clone().requires_grad_() for t in (x, *ws, *gs, *bs)]
    out, _ = preextract_pool_fused(leaves[0], leaves[1:1 + L], leaves[1 + L:1 + 2 * L],
                                   leaves[1 + 2 * L:], pool)
    rout, _ = preextract_pool_reference(x, ws, gs, bs, pool)
    assert out.dtype == torch.bfloat16
    assert ((out.float() - rout.float()).abs() <= 2e-2 * (1 + rout.float().abs())).all()
    torch.manual_seed(0)
    dout = torch.randn(out.shape, device=dev).to(torch.bfloat16)
    grads = torch.autograd.grad(out, leaves, dout)
    saved = tpf._chain_forward(x, ws, gs, bs, None, pool, True, tpf._KERNELS,
                               residual=True)[2]
    dx, dws, dgs, dbs = tpf._chain_backward(x, gs, saved, dout, pool, True, True,
                                            chain_bwd_pass_reference, residual=True)
    assert grads[0].dtype == dx.dtype == torch.bfloat16
    assert grads[1].dtype == torch.float32
    for g, r in zip(grads, (dx, *dws, *dgs, *dbs)):
        assert (g.float() - r.float()).abs().max() <= 3e-2 * r.float().abs().max()


def test_residual_passes_reject_what_they_do_not_take(dev):
    B, R, layout, pool = RES_CHAINS[1]
    x, ws, gs, bs, _ = chain_case(dev, 3, B, R, layout, torch.float32, pool,
                                  masked=False)
    h, ss, sq = mm_stats(x, ws[0])
    sc = affine_scalars(ss, sq, gs[0], bs[0], B * R)
    with pytest.raises(TypeError):  # a residual of another dtype
        bnact_mm_stats(h, sc, ws[1], res=h.bfloat16())
    with pytest.raises(ValueError):  # its scalars on the CPU
        bnact_mm_stats(h, sc, ws[1], res=(h, sc.cpu()))
    with pytest.raises(ValueError):
        bn_pool(h, sc, None, pool, res=h[:, :-4])
    with pytest.raises(TypeError):
        bn_pool(h, sc, None, pool, res=(h, sc.double()))
    uc = up_scalars(sc, gs[1], ss, sq, B * R)
    with pytest.raises(TypeError):  # pooled skip share with int64 rows
        chain_bwd_pass(h, uc, ws[1], h, sc, dz=h, pool=pool,
                       skip_pool=(torch.zeros(B, R // pool, 16, device=dev),
                                  torch.zeros(B, R // pool, 16, device=dev,
                                              dtype=torch.int64)))
    before = chain_bwd_pass.launches
    got = chain_bwd_pass(h, uc, ws[1], h, sc, dz=h, res=(h, sc), skip_dense=h)
    assert chain_bwd_pass.launches == before + 1 and got[0].shape == h.shape


# Sinkhorn matching. The kernel's potentials differ from the plain version's
# by rounding (ex2.approx, another summation order), and the matching is an
# argmax: a row whose two best scores lie within that round-off may go to
# another target. So: at least 99.5% of the rows equal; on every other row
# the kernel's target scores within 1e-6 of the best (float64, the plain
# version's potentials); dists within 1e-6 where the assignments agree.
# After a single iteration ties are structural (every target whose nearest
# point is i scores log(1/M) eps on row i, up to round-off: several percent
# of the rows at 64 points), so that case demands 90% and the gap rule.
SINKHORN_SHAPES = [
    (2, 128, 128, 3, 0.005, 50, None, 0.995),
    (2, 128, 128, 3, 0.01, 30, None, 0.995),
    (3, 64, 128, 6, 0.01, 20, None, 0.995),
    (2, 100, 77, 3, 0.002, 60, 0.1, 0.995),
    (2, 1500, 2500, 4, 0.005, 50, None, 0.995),  # ragged tiles and chunks
    (2, 2048, 2048, 6, 0.002, 60, 0.1, 0.995),
    (2, 64, 64, 3, 0.005, 1, None, 0.9),
    (1, 1, 3, 3, 0.005, 5, None, 0.995),
]


def sinkhorn_case(dev, seed, B, N, M, C):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((B, N, C), dtype=np.float32)).to(dev),
            torch.from_numpy(rng.random((B, M, C), dtype=np.float32)).to(dev))


@pytest.mark.parametrize("shape", SINKHORN_SHAPES)
def test_sinkhorn_matches_plain_and_is_deterministic(dev, shape):
    B, N, M, C, eps, iters, anneal, share = shape
    x, y = sinkhorn_case(dev, 21, B, N, M, C)
    got = sinkhorn(x, y, eps, iters, anneal)
    again = sinkhorn(x, y, eps, iters, anneal)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[0].shape == got[1].shape == (B, N)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert int(got[1].min()) >= 0 and int(got[1].max()) < M
    *want, f, g = sinkhorn_reference(x, y, eps_schedule(eps, iters, anneal))
    same, gap, d_err = matching_difference(x, y, f, g, got, want)
    assert same >= share and gap <= 1e-6 and d_err <= 1e-6, (same, gap, d_err)
    # the stored distance is the squared distance to the named target
    picked = torch.gather(y[..., :3], 1, got[1].long()[..., None].expand(-1, -1, 3))
    direct = (x[..., :3] - picked).square().sum(-1)
    assert float((got[0] - direct).abs().max()) <= 1e-6


def test_sinkhorn_identity_and_unused_dims(dev):
    x, _ = sinkhorn_case(dev, 22, 2, 64, 64, 6)
    d, a = sinkhorn(x, x, 0.002, 100)
    assert torch.equal(a, torch.arange(64, device=dev, dtype=torch.int32).expand(2, 64))
    assert float(d.max()) <= 1e-6
    x2 = x.clone()
    x2[..., 3:] += 1.0  # dims 3: take no part
    d2, a2 = sinkhorn(x2, x, 0.002, 100)
    assert torch.equal(a2, a) and torch.equal(d2, d)
    db, ab = sinkhorn(x.bfloat16(), x.bfloat16(), 0.002, 100)  # cast to fp32
    assert torch.equal(ab, a)


def test_sinkhorn_follows_the_library_formulation(dev):
    """`emd.sinkhorn_match` (stored cost by the matmul expansion,
    torch.logsumexp) on the same clouds: the same matching up to near ties."""
    x, y = sinkhorn_case(dev, 23, 4, 512, 512, 3)
    got = sinkhorn(x, y, 0.005, 50)
    lib = sinkhorn_match(x, y, 0.005, 50)
    *_, f, g = sinkhorn_reference(x, y, eps_schedule(0.005, 50))
    same, gap, d_err = matching_difference(x, y, f, g, lib, got)
    assert same >= 0.995 and gap <= 2e-6 and d_err <= 1e-6, (same, gap, d_err)


def test_sinkhorn_counts_launches_rejects_and_keeps_the_cpu_rule(dev):
    x, y = sinkhorn_case(dev, 24, 2, 64, 48, 3)
    before = sinkhorn.launches
    sinkhorn(x, y, 0.01, 10)
    assert sinkhorn.launches == before + 1
    sinkhorn(x.cpu(), y.cpu(), 0.01, 10)  # the plain version: no launch
    assert sinkhorn.launches == before + 1
    xl = x.clone().requires_grad_()
    d, a = emd_match(xl, y, 0.01, 10)
    assert sinkhorn.launches == before + 2
    d.sum().backward()
    want = 2.0 * (x - torch.gather(y, 1, a.long()[..., None].expand(-1, -1, 3)))
    assert float((xl.grad - want).abs().max()) <= 1e-6
    with pytest.raises(ValueError):
        sinkhorn(x, y.cpu())
    with pytest.raises(ValueError):
        sinkhorn(x[..., :2], y)
    with pytest.raises(TypeError):
        sinkhorn(x.int(), y)


# ---- the PointMLP slice's kNN grouping ----

def knn_case(dev, seed, B, N, S, F, dtype, masked):
    """Unit-cube clouds, centroids on every (N // S)-th point; with masks
    ~30% of the points masked, cloud 1 under-full (3 valid points) and
    cloud 2 without a valid point."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand((B, N, 3), generator=g, device=dev)
    feats = (torch.randn((B, N, F), generator=g, device=dev).to(dtype)
             if F else None)
    cents = xyz[:, :: max(1, N // S)][:, :S].contiguous()
    mask = None
    if masked:
        mask = torch.rand((B, N), generator=g, device=dev) > 0.3
        mask[1] = False
        mask[1, [0, N // 2, N - 1]] = True
        mask[2] = False
    return xyz, feats, cents, mask


@pytest.mark.parametrize("N,S,k,F,with_xyz", [(2048, 1024, 24, 64, False),
                                              (256, 128, 24, 512, False),
                                              (100, 12, 5, 7, True),
                                              (300, 40, 32, 0, True),
                                              (20, 4, 24, 3, True),
                                              (20000, 64, 24, 4, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_knn_group_matches_plain_and_is_deterministic(dev, N, S, k, F, with_xyz,
                                                      dtype, masked):
    """Bit-equal outputs: the same penalised distances (rounded intrinsics
    in the plain version's order), the same (distance, index) order, exact
    gathers; the shared-memory and global paths, k not a multiple of 8,
    k > N, no features, 16-byte and element-wise row copies."""
    xyz, feats, cents, mask = knn_case(dev, N + k, 3, N, S, F, dtype, masked)
    got = knn_group(xyz, feats, cents, mask, k, with_xyz)
    again = knn_group(xyz, feats, cents, mask, k, with_xyz)
    torch.cuda.synchronize()
    want = knn_group_reference(xyz, feats, cents, mask, k, with_xyz)
    for a, b, w in zip(got, again, want):
        assert (a is None) == (b is None) == (w is None)
        if w is not None:
            assert torch.equal(a, b)
            assert a.dtype == w.dtype and torch.equal(a, w)
    idx = got[2]
    assert idx.shape == (3, S, k) and idx.dtype == torch.int32
    if masked:  # slots past the valid count repeat slot 0
        assert (idx[1, :, min(3, k):] == idx[1, :, :1]).all()
        assert (idx[2] == idx[2, :, :1]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_xyz", [False, True])
def test_knn_group_gradient_matches_the_cpu_path(dev, dtype, with_xyz):
    """One scatter_rows launch per backward, bit-equal over two runs; fp32
    gradients 1e-5 relative to the largest (summation order), bf16 feature
    gradients within one bf16 ulp; in fp32 also against autograd through the
    plain version on the card."""
    xyz, feats, cents, mask = knn_case(dev, 4, 3, 512, 64, 6, dtype, True)
    torch.manual_seed(0)
    cws = [torch.randn((3, 64, 16, c), device=dev)
           for c in ((3, 6) if with_xyz else (6,))]

    def grads(fn, d):
        leaves = [t.to(d).clone().requires_grad_() for t in (xyz, feats)]
        gx, gf, _ = fn(*leaves, cents.to(d), mask.to(d), 16, with_xyz)
        outs = ([gx] if with_xyz else []) + [gf]
        loss = sum((o.float() * cw.to(d)).sum() for o, cw in zip(outs, cws))
        return [None if g is None else g.to(dev)
                for g in torch.autograd.grad(loss, leaves, allow_unused=True)]

    before = (knn_group.launches, scatter_rows.launches)
    got = grads(knn_group, dev)
    assert (knn_group.launches, scatter_rows.launches) == (before[0] + 1,
                                                           before[1] + 1)
    again = grads(knn_group, dev)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, again))
    refs = [grads(knn_group, "cpu")]
    if dtype == torch.float32:
        refs.append(grads(knn_group_reference, dev))
    for want in refs:
        for g, w in zip(got, want):
            if w is None or g is None:  # xyz without grouped_xyz: no gradient
                assert not with_xyz and g is None
                continue
            assert g.dtype == w.dtype
            if w.dtype == torch.bfloat16:
                ulp = torch.exp2(torch.floor(torch.log2(
                    w.float().abs().clamp_min(1e-30))) - 7)
                assert ((g.float() - w.float()).abs() <= ulp + 1e-6).all()
            else:
                assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_knn_group_counts_launches_rejects_and_keeps_the_cpu_rule(dev):
    xyz, feats, cents, mask = knn_case(dev, 5, 3, 256, 16, 3, torch.float32, True)
    before = knn_group.launches
    knn_group(xyz, feats, cents, mask, 8)
    knn_group(xyz.cpu(), feats.cpu(), cents.cpu(), mask.cpu(), 8)
    assert knn_group.launches == before + 1
    with pytest.raises(TypeError):
        knn_group(xyz, feats.half(), cents, mask, 8)
    with pytest.raises(TypeError):
        knn_group(xyz.bfloat16(), feats, cents, mask, 8)
    with pytest.raises(ValueError):
        knn_group(xyz, feats.transpose(0, 1).contiguous().transpose(0, 1), cents,
                  mask, 8)
    with pytest.raises(ValueError):
        knn_group(xyz, feats, cents, mask.cpu(), 8)
    with pytest.raises(ValueError):
        knn_group(xyz, feats, cents, mask, 0)


def legacy_ball_case(dev, seed, B, N, S, F, dtype, masked):
    """Unit-cube clouds, centroids on every (N // S)-th point, the last one
    far outside (an empty ball); with masks ~1/3 of the points masked and
    cloud 2 without a valid point (every ball empty)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand((B, N, 3), generator=g, device=dev)
    feats = (torch.randn((B, N, F), generator=g, device=dev).to(dtype)
             if F else None)
    cents = xyz[:, :: max(1, N // S)][:, :S].clone()
    cents[:, -1] += 5.0
    mask = None
    if masked:
        mask = torch.rand((B, N), generator=g, device=dev) > 0.33
        mask[2] = False
    return xyz, feats, cents.contiguous(), mask


@pytest.mark.parametrize("N,S,k,F,radius,with_xyz", [(2048, 512, 16, 3, 0.1, True),
                                                     (512, 128, 128, 320, 0.8, True),
                                                     (300, 40, 5, 7, 0.3, False),
                                                     (256, 16, 40, 0, 0.2, True),
                                                     (20, 4, 32, 3, 0.5, True),
                                                     (5000, 64, 24, 4, 0.1, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_group_gather_matches_plain_and_is_deterministic(dev, N, S, k, F, radius,
                                                         with_xyz, dtype, masked):
    """Bit-equal outputs: the same membership test (rounded intrinsics in the
    plain version's order), the first k in index order, exact gathers; the
    shared-memory and global paths, k above the in-ball count and above N,
    no features, 2-, 4- and 16-byte feature words, with_xyz both ways."""
    xyz, feats, cents, mask = legacy_ball_case(dev, N + k, 3, N, S, F, dtype,
                                               masked)
    got = group_gather(xyz, feats, cents, mask, k, radius, with_xyz)
    again = group_gather(xyz, feats, cents, mask, k, radius, with_xyz)
    torch.cuda.synchronize()
    want = group_gather_reference(xyz, feats, cents, mask, k, radius, with_xyz)
    for a, b, w in zip(got, again, want):
        assert (a is None) == (b is None) == (w is None)
        if w is not None:
            assert torch.equal(a, b)
            assert a.dtype == w.dtype and torch.equal(a, w)
    idx, valid = got[2], got[3]
    assert idx.shape == (3, S, k) and idx.dtype == torch.int32
    assert (idx[:, -1] == 0).all() and not valid[:, -1].any()  # the empty ball
    if masked:
        assert (idx[2] == 0).all() and not valid[2].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_gather_gradient_matches_the_cpu_path(dev, dtype):
    """One scatter_rows launch per backward, bit-equal over two runs; fp32
    gradients 1e-5 relative to the largest (summation order), bf16 feature
    gradients within one bf16 ulp; in fp32 also against autograd through the
    plain version on the card."""
    xyz, feats, cents, mask = legacy_ball_case(dev, 6, 3, 512, 64, 6, dtype, True)
    torch.manual_seed(0)
    cws = [torch.randn((3, 64, 16, c), device=dev) for c in (3, 6)]

    def grads(fn, d):
        leaves = [t.to(d).clone().requires_grad_() for t in (xyz, feats)]
        gx, gf, _, _ = fn(*leaves, cents.to(d), mask.to(d), 16, 0.3)
        loss = sum((o.float() * cw.to(d)).sum() for o, cw in zip((gx, gf), cws))
        return [g.to(dev) for g in torch.autograd.grad(loss, leaves)]

    before = (group_gather.launches, scatter_rows.launches)
    got = grads(group_gather, dev)
    assert (group_gather.launches, scatter_rows.launches) == (before[0] + 1,
                                                              before[1] + 1)
    again = grads(group_gather, dev)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    refs = [grads(group_gather, "cpu")]
    if dtype == torch.float32:
        refs.append(grads(group_gather_reference, dev))
    for want in refs:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            if w.dtype == torch.bfloat16:
                ulp = torch.exp2(torch.floor(torch.log2(
                    w.float().abs().clamp_min(1e-30))) - 7)
                assert ((g.float() - w.float()).abs() <= ulp + 1e-6).all()
            else:
                assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_group_gather_counts_launches_rejects_and_keeps_the_cpu_rule(dev):
    xyz, feats, cents, mask = legacy_ball_case(dev, 7, 3, 256, 16, 3, torch.float32,
                                               True)
    before = group_gather.launches
    group_gather(xyz, feats, cents, mask, 8, 0.3)
    group_gather(xyz.cpu(), feats.cpu(), cents.cpu(), mask.cpu(), 8, 0.3)
    assert group_gather.launches == before + 1
    with pytest.raises(TypeError):
        group_gather(xyz, feats.half(), cents, mask, 8, 0.3)
    with pytest.raises(TypeError):
        group_gather(xyz.bfloat16(), feats, cents, mask, 8, 0.3)
    with pytest.raises(ValueError):
        group_gather(xyz, feats.transpose(0, 1).contiguous().transpose(0, 1), cents,
                     mask, 8, 0.3)
    with pytest.raises(ValueError):
        group_gather(xyz, feats, cents, mask.cpu(), 8, 0.3)
    with pytest.raises(ValueError):
        group_gather(xyz, feats, cents, mask, 0, 0.3)


# ---- the route boundaries of the redesigned kNN and legacy groupings ----

def route_case(dev, seed, B, N, S, F, dtype, masked, ties=False, offset=0, far=False):
    """Unit-cube clouds, centroids on every (N // S)-th point (the last one
    far outside where `far`: an empty ball); `ties`: every fourth point
    copies the one before it (exact distance ties); the features start
    `offset` elements past an aligned base (offset 1 in bf16: 2-byte words);
    with masks ~30% of the points masked and the last cloud fully masked."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand((B, N, 3), generator=g, device=dev)
    if ties:
        xyz[:, 3::4] = xyz[:, 2::4][:, :xyz[:, 3::4].shape[1]]
    feats = None
    if F:
        flat = torch.randn(B * N * F + offset, generator=g, device=dev).to(dtype)
        feats = flat[offset:].view(B, N, F)
    cents = xyz[:, :: max(1, N // S)][:, :S].clone()
    if far:
        cents[:, -1] += 5.0
    mask = None
    if masked:
        mask = torch.rand((B, N), generator=g, device=dev) > 0.3
        mask[-1] = False
    return xyz, feats, cents.contiguous(), mask


def assert_equal_twice(got, again, want):
    for a, b, w in zip(got, again, want):
        assert (a is None) == (b is None) == (w is None)
        if w is not None:
            assert torch.equal(a, b)
            assert a.dtype == w.dtype and torch.equal(a, w)


def feature_word(F, dtype, feats):
    row = F * (2 if dtype == torch.bfloat16 else 4)
    return next(w for w in (16, 8, 4, 2)
                if row % w == 0 and (feats is None or feats.data_ptr() % w == 0))


# (B, N, S, k, F, dtype, masked, with_xyz, ties, offset, route); N = -1 / -2:
# the largest cloud the list route stages at this shape, and one point more
KNN_ROUTES = [
    (3, 300, 40, 32, 16, torch.bfloat16, True, True, True, 0, "list"),  # one key a lane
    (3, 300, 40, 33, 16, torch.bfloat16, True, False, True, 0, "list"),  # two keys a lane
    (3, 300, 40, 64, 16, torch.float32, True, True, False, 0, "list"),
    (3, 300, 40, 65, 16, torch.float32, True, True, True, 0, "rounds"),  # past the list
    (3, -1, 20, 24, 3, torch.bfloat16, True, False, False, 0, "list"),
    (3, -2, 20, 24, 3, torch.bfloat16, True, False, False, 0, "global"),
    (3, 500, 37, 24, 1, torch.bfloat16, False, True, True, 0, "list"),  # 2-byte rows
    (3, 500, 37, 24, 3, torch.bfloat16, True, True, False, 0, "list"),  # 6-byte rows
    (3, 500, 37, 24, 33, torch.bfloat16, True, False, False, 0, "list"),  # 66-byte rows
    (3, 700, 300, 24, 320, torch.bfloat16, True, True, False, 0, "list"),  # 640-byte rows
    (3, 700, 300, 24, 320, torch.bfloat16, False, False, True, 1, "list"),  # 2-byte base
    (8, 2048, 1000, 24, 64, torch.bfloat16, True, False, True, 0, "list"),  # prefetched
    (32, 2048, 1000, 24, 64, torch.bfloat16, True, True, True, 0, "list"),  # xyz: words
    (32, 1024, 512, 40, 0, torch.float32, True, True, False, 0, "list"),  # 2 keys
    (3, 40, 30, 24, 7, torch.float32, True, True, True, 0, "list"),  # two points a lane
]


@pytest.mark.parametrize("case", KNN_ROUTES)
def test_knn_group_route_boundaries(dev, case):
    """Both sides of the list capacity (k = 32 / 33 / 64 / 65) and of the
    shared-memory switch, feature rows of 2 to 640 bytes, a feature base 2
    bytes past a 16-byte boundary, S not a multiple of a block's centroids,
    exact ties, masks and a fully masked cloud, with_xyz both ways: every
    output equal to the plain version's, two runs bit-equal."""
    B, N, S, k, F, dtype, masked, with_xyz, ties, offset, route = case
    if N < 0:  # the list's largest cloud here (one centroid a warp): rows of 32
        # points of 16 bytes past the rest
        fixed = knn_group_plan(B, 96, S, k, F, dtype, 2).smem - 16 * 96
        N = (SMEM_LIMIT - fixed) // 512 * 32 + (N == -2)
    xyz, feats, cents, mask = route_case(dev, N + k + F, B, N, S, F, dtype, masked, ties,
                                         offset)
    p = knn_group_plan(B, N, S, k, F, dtype, feature_word(F, dtype, feats), with_xyz)
    assert p.route == route
    got = knn_group(xyz, feats, cents, mask, k, with_xyz)
    again = knn_group(xyz, feats, cents, mask, k, with_xyz)
    torch.cuda.synchronize()
    assert_equal_twice(got, again, knn_group_reference(xyz, feats, cents, mask, k, with_xyz))
    if masked:  # the fully masked cloud: every slot repeats slot 0
        assert (got[2][-1] == got[2][-1, :, :1]).all()


# (B, N, S, k, F, dtype, masked, with_xyz, offset, radius, route); N = -1 /
# -2: the largest cloud the shared route stages at this shape, and one point
# more
GATHER_ROUTES = [
    (3, -1, 20, 64, 320, torch.bfloat16, True, False, 0, 0.2, "shared"),
    (3, -2, 20, 64, 320, torch.bfloat16, True, False, 0, 0.2, "global"),
    (3, 2048, 37, 16, 1, torch.bfloat16, True, True, 0, 0.1, "shared"),  # 2-byte rows
    (3, 2048, 300, 32, 3, torch.bfloat16, True, True, 0, 0.2, "shared"),  # 6-byte rows
    (32, 2048, 300, 32, 3, torch.bfloat16, True, True, 0, 0.2, "shared"),  # 2 a warp
    (3, 512, 100, 64, 33, torch.bfloat16, False, False, 0, 0.3, "shared"),  # 66-byte
    (3, 512, 129, 128, 320, torch.bfloat16, True, True, 0, 0.8, "shared"),  # 640-byte
    (3, 512, 129, 32, 320, torch.bfloat16, False, True, 1, 0.4, "shared"),  # 2-byte base
    (3, 2048, 512, 128, 3, torch.float32, False, False, 0, 0.4, "shared"),
    (3, 20, 4, 32, 3, torch.float32, True, True, 0, 0.5, "shared"),  # k above N
]


@pytest.mark.parametrize("case", GATHER_ROUTES)
def test_group_gather_route_boundaries(dev, case):
    """Both sides of the shared-memory switch, feature rows of 2 to 640
    bytes, a feature base 2 bytes past a 16-byte boundary, S not a multiple
    of a block's centroids, one and two centroids a warp, masks, a fully
    masked cloud, an empty ball, with_xyz both ways: every output equal to
    the plain version's, two runs bit-equal."""
    B, N, S, k, F, dtype, masked, with_xyz, offset, radius, route = case
    if N < 0:
        fixed = group_gather_plan(B, 512, S, k, F * 2, 16, with_xyz).smem - 16 * 512
        N = (SMEM_LIMIT - fixed) // 16 + (N == -2)
    xyz, feats, cents, mask = route_case(dev, N + k + F, B, N, S, F, dtype, masked,
                                         offset=offset, far=True)
    row = F * (2 if dtype == torch.bfloat16 else 4)
    p = group_gather_plan(B, N, S, k, row, feature_word(F, dtype, feats), with_xyz)
    assert p.route == route and p.cents == (2 if B == 32 else 1)
    got = group_gather(xyz, feats, cents, mask, k, radius, with_xyz)
    again = group_gather(xyz, feats, cents, mask, k, radius, with_xyz)
    torch.cuda.synchronize()
    assert_equal_twice(got, again,
                       group_gather_reference(xyz, feats, cents, mask, k, radius, with_xyz))
    idx, valid = got[2], got[3]
    assert (idx[:, -1] == 0).all() and not valid[:, -1].any()  # the empty ball
    if masked:
        assert (idx[-1] == 0).all() and not valid[-1].any()


# ---- fps on a thread block cluster, the dense-pool backward on TMA + wgmma ----

def cluster_fps_case(dev, kind):
    """(xyz, mask, K) of one cluster-route case; xyz in the unit cube."""
    g = torch.Generator(device=dev).manual_seed(11)
    if kind == "sensor":  # the sensor's shape, about half its points masked
        xyz = torch.rand((1, 196608, 3), generator=g, device=dev)
        return xyz, torch.rand((1, 196608), generator=g, device=dev) > 0.5, 2048
    if kind == "cross-block ties":  # copies 20,000 apart: two blocks apart
        xyz = torch.rand((1, 40000, 3), generator=g, device=dev)
        xyz[:, 20000:] = xyz[:, :20000]
        return xyz, None, 1024
    if kind == "ragged":  # 13 blocks of 11,539 points, the last 11,533
        xyz = torch.rand((2, 150001, 3), generator=g, device=dev)
        return xyz, torch.rand((2, 150001), generator=g, device=dev) > 0.3, 512
    if kind == "first masked":
        xyz = torch.rand((2, 30000, 6), generator=g, device=dev)
        mask = torch.rand((2, 30000), generator=g, device=dev) > 0.2
        mask[:, :15000] = False  # the first valid point lies in the second block
        return xyz, mask, 256
    if kind == "all masked":
        xyz = torch.rand((2, 30000, 3), generator=g, device=dev)
        mask = torch.rand((2, 30000), generator=g, device=dev) > 0.2
        mask[1] = False
        return xyz, mask, 64
    if kind == "under-full":  # 100 valid points for 256 slots
        xyz = torch.rand((1, 50000, 3), generator=g, device=dev)
        mask = torch.zeros((1, 50000), dtype=torch.bool, device=dev)
        mask[0, torch.randperm(50000, generator=g, device=dev)[:100]] = True
        return xyz, mask, 256
    assert kind == "K = 1"
    xyz = torch.rand((3, 70000, 3), generator=g, device=dev)
    mask = torch.rand((3, 70000), generator=g, device=dev) > 0.5
    mask[1, :60000] = False
    return xyz, mask, 1


@pytest.mark.parametrize("kind", ["sensor", "cross-block ties", "ragged", "first masked",
                                  "all masked", "under-full", "K = 1"])
def test_fps_cluster_route_matches_plain_and_is_deterministic(dev, kind):
    """The cluster route: indices equal to the plain version's, two runs
    bit-equal; ties between blocks go to the lower index, slot 0 is the
    first valid point over all blocks, a cloud without one gives zeros, an
    under-full cloud repeats valid points."""
    xyz, mask, K = cluster_fps_case(dev, kind)
    assert fps_plan(xyz.shape[0], xyz.shape[1]).route == "cluster"
    got = farthest_point_sample(xyz, K, mask)
    again = farthest_point_sample(xyz, K, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, fps_reference(xyz, K, mask))
    if kind == "all masked":
        assert (got[1] == 0).all()
    if mask is not None and kind != "all masked":
        assert bool(torch.gather(mask, 1, got.long()).all())
    if kind == "first masked":
        assert (got[:, 0] >= 15000).all()
    if kind == "cross-block ties":  # both copies of a point are never taken
        assert len(set((got[0] % 20000).tolist())) == K


MSG_BRANCHES = [(32, 64, 512, 16), (64, 128, 512, 32), (96, 128, 512, 128),
                (64, 128, 128, 32), (128, 256, 128, 64), (128, 256, 128, 128)]


def check_pool_bwd(dev, seed, B, R, Cin, C, pool, dtype, masked):
    """dense_pool_stats_bwd against autograd through the plain version, at
    the forward kernel's own selection (both sides route each pooled
    gradient to the same row), two runs bit-equal: dw and db within 1e-3
    (fp32: 1e-4), dx within 2e-2 in bf16 (1e-4 in fp32), relative to the
    largest entry; bf16 db against the fp32 sum of the plain dz before its
    cast, as the kernel sums it."""
    x, w, b, s, pen = dense_case(dev, seed, B, R, Cin, C, dtype, masked)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    psel, asel, _, _ = dense_pool_stats(x, w, b, s, pen, pool)
    dp = torch.randn(psel.shape, generator=g, device=dev).to(dtype).float()
    dss = torch.randn((C,), generator=g, device=dev) / (B * R)
    dsq = torch.randn((C,), generator=g, device=dev) / (B * R)
    got = dense_pool_stats_bwd(x, w, b, s, asel, dp, dss, dsq, pool)
    again = dense_pool_stats_bwd(x, w, b, s, asel, dp, dss, dsq, pool)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    z = (torch.matmul(x.float(), w.float()) + b.float()).to(dtype).float()
    sparse = torch.zeros((B, R // pool, pool, C), device=dev)
    sparse.scatter_(2, asel.long()[:, :, None, :], (dp * s)[:, :, None, :])
    dz = dss + 2 * dsq * z + sparse.reshape(B, R, C)
    rx = (dz.to(dtype).float() @ w.float().t()).to(dtype)
    rw = x.float().reshape(-1, Cin).t() @ dz.to(dtype).float().reshape(-1, C)
    rb = dz.sum(dim=(0, 1))
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    for a, r, t in ((got[0], rx, tol if dtype == torch.float32 else 2e-2),
                    (got[1], rw, tol), (got[2], rb, tol)):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert (a.float() - r.float()).abs().max() <= t * r.float().abs().max()


@pytest.mark.parametrize("masked", [False, True])
def test_pool_bwd_pointnet_shape_matches_plain(dev, masked):
    """PointNet's 128 -> 1024 at a pool of 2048 (two clouds) on TMA +
    wgmma, with and without pen in the forward that picks asel."""
    assert pool_bwd_plan(2 * 2048, 128, 1024, True, 2048).route == "wgmma"
    check_pool_bwd(dev, 21, 2, 2048, 128, 1024, 2048, torch.bfloat16, masked)


@pytest.mark.parametrize("cin,c,S,pool", MSG_BRANCHES)
def test_pool_bwd_msg_branches_match_plain(dev, cin, c, S, pool):
    """Each MSG branch's last layer (Cin -> C at its pool, S centroids, two
    clouds), masked rows, on TMA + wgmma."""
    assert pool_bwd_plan(2 * S * pool, cin, c, True, pool).route == "wgmma"
    check_pool_bwd(dev, 22, 2, S * pool, cin, c, pool, torch.bfloat16, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pool_bwd_ragged_widths_match_plain(dev, dtype):
    """C = 200 and Cin = 72 over 450 rows (a partial 128-row tile, a partial
    64-channel chunk, Cin past one 64-channel atom): bf16 on TMA + wgmma,
    fp32 on the tile route."""
    plan = pool_bwd_plan(450, 72, 200, dtype == torch.bfloat16, 30)
    assert plan.route == ("wgmma" if dtype == torch.bfloat16 else "tile")
    check_pool_bwd(dev, 23, 3, 150, 72, 200, 30, dtype, True)


@pytest.mark.parametrize("pool,route", [(6, "wgmma"), (4, "tile")])
def test_pool_bwd_small_pools_match_plain(dev, pool, route):
    """Pools of a few rows at 128 -> 1024: on TMA + wgmma a ring stage's
    tables span many pool blocks (23 for dx at a pool of 6); smaller pools
    take the tiles."""
    assert pool_bwd_plan(2 * 480, 128, 1024, True, pool).route == route
    check_pool_bwd(dev, 26, 2, 480, 128, 1024, pool, torch.bfloat16, True)


def test_pool_bwd_fp32_pointnet_shape_matches_plain(dev):
    assert pool_bwd_plan(2 * 2048, 128, 1024, False, 2048).route == "tile"
    check_pool_bwd(dev, 24, 2, 2048, 128, 1024, 2048, torch.float32, True)


# ---- the dense-pool forward on TMA + wgmma, and the Sinkhorn sweep's plan ----

def check_pool_fwd(x, w, b, s, pen, pool, route):
    """dense_pool_stats' forward on `route`, twice (bit-equal), against the
    plain version: bf16 psel within 1 bf16 ulp of |psel| (the tensor cores'
    sum order can flip one rounding of z), asel equal wherever the
    runner-up lies more than 1 ulp below, ssum / ssq within 1e-3 relative
    to the largest entry; fp32 psel, ssum, ssq within 1e-4 relative and asel
    equal off 1e-5 gaps. Returns (kernel outputs, plain outputs)."""
    B, R, Cin = x.shape
    C = w.shape[1]
    assert pool_fwd_plan(B * R, Cin, C, x.dtype == torch.bfloat16, pool).route == route
    got = dense_pool_stats(x, w, b, s, pen, pool)
    again = dense_pool_stats(x, w, b, s, pen, pool)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = dense_pool_stats_reference(x, w, b, s, pen, pool)
    assert got[0].dtype == x.dtype and got[1].dtype == torch.int32
    assert got[0].shape == got[1].shape == (B, R // pool, C)
    z = (torch.matmul(x.float(), w.float()) + b.float()).to(x.dtype).float()
    zs = z * s - (0.0 if pen is None else pen[..., None])
    top2 = torch.topk(zs.reshape(B, R // pool, pool, C), 2, dim=2).values
    if x.dtype == torch.float32:
        tol = 1e-4 * want[0].abs().max()
        gap = top2[:, :, 0] - top2[:, :, 1] > 1e-5 * top2[:, :, 0].abs()
        assert (got[0] - want[0]).abs().max() <= tol
        stat_tol = 1e-4
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want[0].float().abs().clamp_min(1e-30))) - 7)
        assert ((got[0].float() - want[0].float()).abs() <= ulp).all()
        top_ulp = torch.exp2(torch.floor(torch.log2(top2[:, :, 0].abs().clamp_min(1e-30))) - 7)
        gap = top2[:, :, 0] - top2[:, :, 1] > top_ulp
        stat_tol = 1e-3
    assert torch.equal(got[1][gap], want[1][gap])
    for a, r in zip(got[2:], want[2:]):
        assert (a - r).abs().max() <= stat_tol * r.abs().max()
    return got, want


@pytest.mark.parametrize("masked", [False, True])
def test_pool_fwd_pointnet_shape_matches_plain(dev, masked):
    """PointNet's 128 -> 1024 at a pool of 2048 (two clouds), with and
    without pen, on TMA + wgmma."""
    check_pool_fwd(*dense_case(dev, 31, 2, 2048, 128, 1024, torch.bfloat16, masked),
                   2048, "wgmma")


@pytest.mark.parametrize("cin,c,S,pool", MSG_BRANCHES)
def test_pool_fwd_msg_branches_match_plain(dev, cin, c, S, pool):
    """Each MSG branch's last layer (Cin -> C at its pool, S centroids, two
    clouds), masked rows, on TMA + wgmma: Cin 32 / 96 padded by TMA's zero
    fill, C = 64 on one channel atom (the consumers alternate tiles),
    pools of 16 and 32 under a tile, 64 and 128 over one or two."""
    check_pool_fwd(*dense_case(dev, 32, 2, S * pool, cin, c, torch.bfloat16, True),
                   pool, "wgmma")


@pytest.mark.parametrize("cin,c,pool", [(128, 1024, 2048), (32, 64, 16), (64, 128, 32),
                                        (128, 256, 128)])
def test_pool_fwd_fully_masked_pool_block(dev, cin, c, pool):
    """Every row of pool block 1 of cloud 0 masked (pen 1e9): s z - 1e9
    rounds to -1e9 on all of them, a tie the lowest row wins (row 0), as in
    the plain version."""
    x, w, b, s, _ = dense_case(dev, 33, 2, 4 * pool, cin, c, torch.bfloat16, False)
    pen = torch.zeros((2, 4 * pool), device=dev)
    pen[0, pool:2 * pool] = 1e9
    got, want = check_pool_fwd(x, w, b, s, pen, pool, "wgmma")
    assert torch.equal(got[1][0, 1], want[1][0, 1])
    assert bool((got[1][0, 1] == 0).all())
    assert torch.equal(got[0][0, 1].float(), want[0][0, 1].float())


@pytest.mark.parametrize("cin,c,pool,rows", [
    (128, 1024, 2048, (5, 37, 84, 1500, 2047)),  # warps, tiles, the last row
    (128, 256, 128, (3, 50, 64, 127)),  # both tiles of a pool of 128
    (64, 128, 32, (17, 20, 31)),  # the two warps of a pool of 32
    (32, 64, 16, (1, 9, 15)),  # lanes of one warp; consumers alternate tiles
])
def test_pool_fwd_planted_ties_take_the_lowest_row(dev, cin, c, pool, rows):
    """Equal maxima planted in one pool block of each cloud (copies of one
    row, scaled to dominate; copies give equal z bit for bit) in different
    lanes, warps and tiles: wherever the copies are the maximum, asel is
    the lowest copy in both versions."""
    x, w, b, s, _ = dense_case(dev, 34, 2, 2 * pool, cin, c, torch.bfloat16, False)
    x[:, pool + rows[0]] *= 8.0
    for r in rows[1:]:
        x[:, pool + r] = x[:, pool + rows[0]]
    got, want = check_pool_fwd(x, w, b, s, None, pool, "wgmma")
    planted = want[1][:, 1] == rows[0]
    assert bool(planted.any())
    assert bool((got[1][:, 1][planted] == rows[0]).all())


def test_pool_fwd_negative_and_positive_zero_tie(dev):
    """A pool block whose maximum is zero, reached as -0 (s = -1, z = +0,
    pen = +0) on a lower row and as +0 (pen = -0) on a higher one: they
    compare equal, so the lower row wins, as torch.max's first index."""
    g = torch.Generator(device=dev).manual_seed(35)
    B, R, cin, c, pool = 2, 256, 64, 128, 128
    x = torch.rand((B, R, cin), generator=g, device=dev).add_(0.1).bfloat16()
    w = torch.rand((cin, c), generator=g, device=dev).add_(0.1).div_(cin).bfloat16()
    b = torch.zeros((c,), device=dev, dtype=torch.bfloat16)
    s = -torch.ones((c,), device=dev)  # s z < 0 but on the zero rows
    pen = torch.zeros((B, R), device=dev)
    zero_rows = (pool + 9, pool + 40, pool + 100)
    for r in zero_rows:
        x[:, r] = 0.0
    pen[:, zero_rows[1]] = -0.0  # -(+0) - (-0) = +0 on the middle row
    got, want = check_pool_fwd(x, w, b, s, pen, pool, "wgmma")
    assert bool((got[1][:, 1] == 9).all()) and bool((want[1][:, 1] == 9).all())
    assert bool((got[0][:, 1].float() == 0).all())


@pytest.mark.parametrize("dtype,shape", [(torch.float32, (2, 2048, 128, 1024, 2048)),
                                         (torch.bfloat16, (3, 150, 72, 200, 30)),
                                         (torch.float32, (3, 150, 72, 200, 30))])
def test_pool_fwd_tile_route_matches_plain(dev, dtype, shape):
    """fp32 (the card-vs-CPU checks) and Cin = 72, C = 200 at a pool of 30
    (a pool that no warp slice fits) keep the tile route."""
    B, R, cin, c, pool = shape
    check_pool_fwd(*dense_case(dev, 36, B, R, cin, c, dtype, True), pool, "tile")


# name: (B, N, M, eps, iters, anneal, scale, offset, split_x); the clouds
# are uniform in offset + [-scale / 2, scale / 2]^3
SINKHORN_PLANS = {
    "N != M, one cloud (8 groups)": (1, 1500, 2500, 0.005, 50, None, 1.0, 0.0, 8),
    "N and M no thread count divides": (2, 1021, 997, 0.005, 50, None, 1.0, 0.0, 8),
    "B = 1024, no split": (1024, 64, 64, 0.01, 30, None, 1.0, 0.0, 1),
    "annealed to eps 0.002": (4, 700, 700, 0.002, 60, 0.1, 1.0, 0.0, 8),
    "one iteration": (4, 256, 256, 0.005, 1, None, 1.0, 0.0, 8),
    "a cloud over [-50, 50], eps scaled with it": (2, 1024, 1024, 50.0, 50, None, 100.0,
                                                    0.0, 8),
    "a unit cloud 50 from the origin": (2, 1024, 1024, 0.005, 50, None, 1.0, 50.0, 8),
    "the AE + EMD batch's split": (128, 2048, 2048, 0.005, 50, None, 1.0, 0.0, 2),
}


@pytest.mark.parametrize("name", SINKHORN_PLANS)
def test_sinkhorn_plans_match_plain(dev, name):
    """`sinkhorn` at each geometry of `sinkhorn_plan` (q splits of 1, 2 and
    8 groups, ragged tiles and blocks), at the eps rule's ends, on a cloud
    100 wide (the unit problem scaled by 100, eps by 100^2: the same
    matching, scores and rounding 10^4 larger) and on a unit cloud 50 from
    the origin (where a distance formed as |a|^2 - 2 a.b + |b|^2 would
    round at 10^4 times the distances that matter): two runs bit-equal; at
    least 99.5% of the rows equal to the plain version's (90% after one
    iteration, whose ties are structural), the others within 1e-6 in score;
    dists within 1e-6 where the rows agree."""
    B, N, M, eps, iters, anneal, scale, offset, split_x = SINKHORN_PLANS[name]
    assert sinkhorn_plan(B, N, M).split_x == split_x
    rng = np.random.default_rng(41)
    x = torch.from_numpy((rng.random((B, N, 3), dtype=np.float32) - 0.5) * scale + offset)
    y = torch.from_numpy((rng.random((B, M, 3), dtype=np.float32) - 0.5) * scale + offset)
    x, y = x.to(dev), y.to(dev)
    got = sinkhorn(x, y, eps, iters, anneal)
    again = sinkhorn(x, y, eps, iters, anneal)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    *want, f, g = sinkhorn_reference(x, y, eps_schedule(eps, iters, anneal))
    same, gap, d_err = matching_difference(x, y, f, g, got, want)
    share = 0.9 if iters == 1 else 0.995
    assert same >= share and gap <= 1e-6 and d_err <= 1e-6, (same, gap, d_err)


@pytest.mark.parametrize("B,N", [(1, 700), (3, 512)])
def test_sinkhorn_identical_clouds_give_the_identity_when_split(dev, B, N):
    """y = x at a q split of 8 groups of warps (one cloud of 700 points,
    three of 512): the identity, every distance 0."""
    x, _ = sinkhorn_case(dev, 42, B, N, N, 3)
    assert sinkhorn_plan(B, N, N).split_x == 8
    d, a = sinkhorn(x, x, 0.002, 100)
    assert torch.equal(a, torch.arange(N, device=dev, dtype=torch.int32).expand(B, N))
    assert float(d.max()) <= 1e-6


# ---- nn_sweep on the tensor cores, fps's block route in registers ----

def direct_values(x, y, idx):
    """The direct formula's value for each query of x (B, N, C) and its
    chosen target idx (B, N) of y: fmaf(diff, diff, d) in dimension order,
    each fmaf formed in float64 (the square of an fp32 difference is exact
    there) and rounded once to fp32."""
    t = torch.gather(y, 1, idx.long()[..., None].expand(-1, -1, y.shape[-1]))
    d = torch.zeros(idx.shape, dtype=torch.float32, device=x.device)
    for c in range(x.shape[-1]):
        diff = (x[..., c] - t[..., c]).double()
        d = (diff * diff + d.double()).float()
    return d


NN_EDGES = {  # kind: (B, N, M), masks
    "ragged": ((3, 2049, 31), True),  # a one-row query tile, one 31-column product
    "two chunks": ((2, 333, 3500), True),  # C >= 2: 3500 targets in 2-3 chunks
    "x all masked": ((2, 300, 400), True),
    "y all masked": ((2, 300, 400), True),
    "one point": ((2, 1, 257), False),  # a cloud of one point
    "duplicates": ((2, 600, 2600), False),  # exact ties within and across chunks
    "far masked x[0]": ((3, 700, 900), True),  # a masked point 1e3 out is no centre
}


def nn_edge_case(dev, C, kind):
    (B, N, M), masked = NN_EDGES[kind]
    rng = np.random.default_rng(1000 + 10 * C + list(NN_EDGES).index(kind))
    x = rng.random((B, N, C), dtype=np.float32)
    y = rng.random((B, M, C), dtype=np.float32)
    xm = ym = None
    if masked:
        xm = rng.random((B, N)) > 0.1
        ym = rng.random((B, M)) > 0.1
        if kind == "x all masked":
            xm[1] = False
        if kind == "y all masked":
            ym[0] = False
        if kind == "far masked x[0]":  # y point 9 is its clear nearest
            x[:, 0] = 1e3
            xm[:, 0] = False
            y[:, 9] = 1.5
            ym[:, 9] = True
            xm[1, :5] = False  # the first valid x point is a later one
            xm[2] = False  # no valid x point: the centre is y's first valid one
    if kind == "duplicates":
        y[:, M - 1] = y[:, 5]  # chunk 0 and the last chunk at C >= 2
        x[:, 7] = y[:, 5]
        y[:, 2101] = y[:, 2100]  # two copies inside one chunk
        x[:, 9] = y[:, 2100]
        x[:, N - 1] = x[:, 3]
        y[:, 11] = x[:, 3]
    t = (lambda a: None if a is None else torch.from_numpy(a).to(dev))
    return t(x), t(y), t(xm), t(ym)


@pytest.mark.parametrize("C", [1, 3, 6, 7, 8])
@pytest.mark.parametrize("kind", list(NN_EDGES))
def test_nn_sweep_tensor_core_edges(dev, C, kind):
    """The wgmma kernel against the plain version on ragged tiles, several
    target chunks, fully masked clouds on either side, a one-point cloud,
    planted duplicates and a masked first x point 1e3 out, at depths K = 16,
    32, 48 (C = 7: no spare column) and 64: values within 1e-5, masked and target-less queries >= 1e10,
    indices equal wherever the float64 runner-up is 1e-5 farther, exact
    ties to the first index; each value is the direct formula's for the
    returned index; two runs bit-equal."""
    x, y, xm, ym = nn_edge_case(dev, C, kind)
    got = nn_sweep(x, y, xm, ym)
    again = nn_sweep(x, y, xm, ym)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = nn_sweep_reference(x, y, xm, ym)
    d64 = torch.cdist(x.double(), y.double()).square()
    for v, i, q, t, qm, tm, dd in ((0, 1, x, y, xm, ym, d64),
                                   (2, 3, y, x, ym, xm, d64.transpose(1, 2))):
        B, nq = got[v].shape
        qm = torch.ones((B, nq), dtype=torch.bool, device=dev) if qm is None else qm
        tm = (torch.ones((B, t.shape[1]), dtype=torch.bool, device=dev)
              if tm is None else tm)
        has = tm.any(dim=1, keepdim=True).expand(B, nq)
        ok = qm & has
        if bool(ok.any()):
            assert float((got[v] - want[v]).abs()[ok].max()) <= 1e-5
            assert torch.equal(got[v][ok], direct_values(q, t, got[i])[ok])
        assert bool((got[v][~ok] >= 1e10).all())
        assert bool((got[i][~has] == 0).all())  # no valid target: index 0
        masked = dd.masked_fill(~tm[:, None, :], 1e10)
        if masked.shape[2] >= 2:
            top = torch.topk(masked, 2, dim=2, largest=False)
            clear = (top.values[..., 1] - top.values[..., 0] > 1e-5) & has
            assert bool((got[i].long() == top.indices[..., 0])[clear].all())
    if kind == "duplicates":
        assert bool((got[1][:, 7] == 5).all()) and bool((got[1][:, 9] == 2100).all())
        assert bool((got[3][:, 11] == 3).all())


def test_nn_sweep_follows_its_plan(dev):
    """The eval step's shape runs in one chunk of 2,048 targets a block and
    one block a direction and batch element; a 3,500-target cloud at C = 8
    in three chunks of 1,536: both give the plain version's values."""
    assert nn_plan(512, 2048, 2048, 6)[1:4] == (2048, 1, 1)
    plan = nn_plan(2, 333, 3500, 8)
    assert (plan.chunk, plan.chunks) == (1536, 3)
    x, y, _, _ = nn_edge_case(dev, 8, "two chunks")
    got = nn_sweep(x, y)
    want = nn_sweep_reference(x, y)
    assert float((got[0] - want[0]).abs().max()) <= 1e-5
    assert float((got[2] - want[2]).abs().max()) <= 1e-5


FPS_DRIVEN_SHAPES = [(256, 2048, 512), (256, 512, 128), (32, 2048, 1024),
                     (32, 1024, 512), (32, 512, 256), (32, 256, 128), (1, 2048, 512),
                     (1, 512, 128)]


@pytest.mark.parametrize("B,N,K", FPS_DRIVEN_SHAPES)
def test_fps_block_route_at_the_driven_shapes(dev, B, N, K):
    """PointNet2's SA levels (B=256), the MSG levels and PointMLP's four
    stages (B=32) and `encode` (B=1): indices equal to the plain version's,
    two runs bit-equal, on clouds with duplicated points (exact ties)."""
    assert fps_plan(B, N).route == "block"
    xyz, _ = fps_case(dev, 100 + N, B, N, masked=False)
    got = farthest_point_sample(xyz, K)
    again = farthest_point_sample(xyz, K)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, fps_reference(xyz, K))


@pytest.mark.parametrize("N", [1, 2, 255, 256, 257, 1023, 1024, 1025, 2047, 2048, 2049,
                               4096, 4097, 12287, 12288])
def test_fps_block_route_at_slot_boundaries(dev, N):
    """Clouds of threads x slots points and one more or less (padding slots
    hold mind -1 and lose every tie), masked (point 0 of cloud 0 masked, the
    last cloud fully masked: zeros) and under-full where K > N."""
    plan = fps_plan(3, N)
    assert plan.route == "block" and plan.threads * plan.slots >= N
    K = min(300, 2 * N)
    xyz, mask = fps_case(dev, 7 + N, 3, N, masked=True)
    got = farthest_point_sample(xyz, K, mask)
    again = farthest_point_sample(xyz, K, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, fps_reference(xyz, K, mask))
    assert bool((got[-1] == 0).all())


def test_fps_block_route_one_under_full_cloud(dev):
    """B=1, 40 valid points of 600 for 128 slots: every valid point taken
    once before any repeats, as the plain version does."""
    g = torch.Generator(device=dev).manual_seed(5)
    xyz = torch.rand((1, 600, 3), generator=g, device=dev)
    mask = torch.zeros((1, 600), dtype=torch.bool, device=dev)
    mask[0, torch.randperm(600, generator=g, device=dev)[:40]] = True
    got = farthest_point_sample(xyz, 128, mask)
    assert torch.equal(got, fps_reference(xyz, 128, mask))
    assert len(set(got[0, :40].tolist())) == 40
    assert bool(torch.gather(mask, 1, got.long()).all())


# ---- bn_pool: 8 channels a thread over slices of a group's rows ----

@pytest.mark.parametrize("groups,C,pool,dtype,res", [
    (8 * 512, 128, 32, torch.bfloat16, "none"),  # SA1's width and pool
    (8 * 128, 256, 64, torch.bfloat16, "none"),  # SA2's
    (256, 1024, 128, torch.bfloat16, "none"),  # SA3 at B=256: 8 slices a group
    (32 * 1024, 128, 24, torch.bfloat16, "dense"),  # PointMLP stage 1
    (32 * 128, 1024, 24, torch.bfloat16, "dense"),  # PointMLP stage 4
    (32 * 1024, 64, 24, torch.bfloat16, "bnrelu"),  # Elite stage 1
    (40, 130, 12, torch.bfloat16, "bnrelu"),  # a ragged width: one channel a thread
    (24, 40, 32, torch.float32, "none"),  # fp32: two 16-byte loads a row
])
def test_bn_pool_matches_plain_at_driven_shapes(dev, groups, C, pool, dtype, res):
    """Planted ties (equal rows across and within slices), a group with no
    valid row (-1e9) and a group of equal rows: out, maxv, amax and hsel
    exactly the plain version's, two runs bit-equal."""
    g = torch.Generator(device=dev).manual_seed(groups + C)
    R = groups * pool
    h = torch.randn((1, R, C), generator=g, device=dev).to(dtype)
    h[0, [3, 5, pool - 1]] = h[0, pool + 1].clone()
    h[0, pool:2 * pool] = h[0, pool].clone()
    sc = torch.stack([0.1 * torch.randn(C, generator=g, device=dev),
                      0.5 + torch.rand(C, generator=g, device=dev),
                      0.1 * torch.randn(C, generator=g, device=dev),
                      torch.ones(C, device=dev)])
    pen = None
    if res == "none":
        pen = torch.where(torch.rand((1, R), generator=g, device=dev) > 0.1, 0.0, 1e9)
        pen[0, pool:2 * pool] = 0.0
        pen[0, 2 * pool:3 * pool] = 1e9
    src = torch.randn((1, R, C), generator=g, device=dev).to(dtype)
    src[0, pool:2 * pool] = src[0, pool].clone()  # group 1: every row equal
    resid = {"none": None, "dense": src, "bnrelu": (src, sc)}[res]
    p = tpf.bn_pool_plan(groups, C, pool, dtype, {"none": 0, "bnrelu": 1, "dense": 2}[res])
    assert p.vec == (8 if C % 8 == 0 else 1)
    before = bn_pool.launches
    got = bn_pool(h, sc, pen, pool, res=resid)
    again = bn_pool(h, sc, pen, pool, res=resid)
    torch.cuda.synchronize()
    assert bn_pool.launches - before == 2
    want = bn_pool_reference(h, sc, pen, pool, res=resid)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert (got[2][0, 1] == 0).all()  # equal rows: the first
    if pen is not None:
        assert (got[0][0, 2] == -1e9).all()


# ---- the MultiSegmenter's segmenting Chamfer and MLPChainPool ----

SEG_SIZES = {"cube": (1, 21), "arm": (2, 820), "gripper": (4, 103)}  # label, points


def segmenting_case(dev, seed, sizes, B=4, N=2048, absent=(), masked=False):
    """Predictions of the experts `sizes` ({name: (label, points)}) and a
    labelled target cloud; `absent` lists (cloud, label) pairs that cloud
    lacks."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pred = {c: torch.rand((B, n, 3), generator=g, device=dev)
            for c, (_, n) in sizes.items()}
    labels = torch.randint(0, 5, (B, N), generator=g, device=dev)
    for cloud, lab in absent:
        labels[cloud] = torch.where(labels[cloud] == lab, (lab + 1) % 5, labels[cloud])
    target = torch.cat([torch.rand((B, N, 3), generator=g, device=dev),
                        labels[..., None].float()], dim=-1)
    tmask = torch.rand((B, N), generator=g, device=dev) > 0.1 if masked else None
    return pred, target, tmask


@pytest.mark.parametrize("sizes,absent,masked", [
    (SEG_SIZES, (), False), (SEG_SIZES, ((0, 1), (1, 4)), False),
    (SEG_SIZES, ((2, 2),), True), ({"gripper": (4, 103)}, (), False)])
def test_segmenting_chamfer_launches_the_kernels_and_matches_plain(dev, sizes, absent,
                                                                   masked, monkeypatch):
    """The Cube scene's three experts and the Table scene's one (whose
    broadcast target is a strided view until the loss copies it, as the
    kernel needs). One nn_sweep launch forward and one chamfer_bwd backward; the value
    within 1e-5 of the plain version's relative to its size (an absent
    class puts ~1e10 into it); the gradients within 1e-5 of each tensor's
    largest entry of the plain version's taken at the kernel's own nearest
    neighbours (the CPU run's nn_sweep hands back the card's indices), and
    the card's indices equal to the plain version's off 1e-5 ties."""
    from pointcloud_tpu_torch.losses import SegmentingChamferDistance
    from pointcloud_tpu_torch.ops import chamfer as tchamfer

    pred, target, tmask = segmenting_case(dev, 3, sizes, absent=absent, masked=masked)
    loss_fn = SegmentingChamferDistance({c: lab for c, (lab, _) in sizes.items()})
    leaves = {k: v.clone().requires_grad_() for k, v in pred.items()}
    n0, c0 = nn_sweep.launches, chamfer_bwd.launches
    calls = []
    real = tchamfer.nn_sweep

    def seen(*a):
        out = real(*a)
        calls.append((a, out))
        return out

    monkeypatch.setattr(tchamfer, "nn_sweep", seen)
    loss = loss_fn(leaves, target, target_mask=tmask)
    loss.backward()
    torch.cuda.synchronize()
    assert nn_sweep.launches == n0 + 1 and chamfer_bwd.launches == c0 + 1
    (args, card), = calls
    def with_card_indices(*a):
        min_x, _, min_y, _ = nn_sweep_reference(*a)
        return min_x, card[1].cpu(), min_y, card[3].cpu()

    monkeypatch.setattr(tchamfer, "nn_sweep", with_card_indices)
    cpu = {k: v.detach().cpu().requires_grad_() for k, v in pred.items()}
    want = loss_fn(cpu, target.cpu(), target_mask=None if tmask is None else tmask.cpu())
    want.backward()
    got, want = float(loss.detach()), float(want.detach())
    assert abs(got - want) <= 1e-5 * abs(want)
    assert (want > 1e9) == bool(absent)
    for k in pred:
        g, w = leaves[k].grad.cpu(), cpu[k].grad
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), k
    plain = nn_sweep_reference(*(a.cpu() for a in args))
    x, y, xm, ym = (a.cpu() for a in args)
    d = ((x[:, :, None].double() - y[:, None].double()) ** 2).sum(-1)
    for i, qm, tm, dd in ((1, xm, ym, d), (3, ym, xm, d.transpose(1, 2))):
        two = torch.topk(dd.masked_fill(~tm[:, None, :], 1e10), 2, dim=2,
                         largest=False).values
        clear = (two[..., 1] - two[..., 0] > 1e-5) & qm & tm.any(dim=1, keepdim=True)
        assert (card[i].cpu() == plain[i])[clear].all()
        lonely = qm & ~tm.any(dim=1, keepdim=True)
        assert (card[i].cpu()[lonely] == 0).all()  # no target: index 0, as JAX


@pytest.mark.parametrize("N", [2048, 2000])
@pytest.mark.parametrize("final_relu", [False, True])
def test_mlp_chain_pool_train_matches_its_plain_chain(dev, N, final_relu):
    """MLPChainPool in train mode on the card, fp32, with one group of N
    rows a cloud: the four kernels (1 + 2 + 1 forward, 3 backward) against
    the same module on the CPU (the plain chain): output, input and
    parameter gradients and running statistics within 2e-4 of each
    tensor's largest entry; a cloud without a valid point gives -1e9."""
    from pointcloud_tpu_torch.models import MLPChainPool
    from pointcloud_tpu_torch.models.layers import init_flax_

    torch.manual_seed(N)
    mods = []
    for d in (dev, torch.device("cpu")):
        m = MLPChainPool(6, (64, 128, 256), final_relu=final_relu)
        init_flax_(m, torch.Generator().manual_seed(1))
        mods.append(m.to(d))
    x = torch.randn((4, N, 6))
    mask = torch.rand((4, N)) > 0.2
    mask[3] = False
    cw = torch.randn((4, 256))
    res = []
    counts = (mm_stats.launches, bnact_mm_stats.launches, bn_pool.launches,
              chain_bwd_pass.launches)
    for m in mods:
        d = next(m.parameters()).device
        xl = x.to(d).requires_grad_()
        out = m(xl, train=True, mask=mask.to(d))
        (torch.where(out > -5e8, out, 0.0) * cw.to(d)).sum().backward()
        res.append((out.detach().cpu(), xl.grad.cpu(),
                    {k: p.grad.cpu() for k, p in m.named_parameters()},
                    {k: b.cpu() for k, b in m.named_buffers()}))
        if d.type == "cuda":
            torch.cuda.synchronize()
            got = (mm_stats.launches, bnact_mm_stats.launches, bn_pool.launches,
                   chain_bwd_pass.launches)
            assert tuple(a - b for a, b in zip(got, counts)) == (1, 2, 1, 3)
    (out, dx, dp, st), (rout, rdx, rdp, rst) = res
    assert (out[3] == -1e9).all() and (rout[3] == -1e9).all()
    live = rout > -5e8
    assert torch.equal(out > -5e8, live)
    assert (out - rout).abs()[live].max() <= 2e-4 * rout.abs()[live].max()
    for g, w in [(dx, rdx), *zip(dp.values(), rdp.values()), *zip(st.values(), rst.values())]:
        assert (g - w).abs().max() <= 2e-4 * w.abs().max()


@pytest.mark.parametrize("scene,outside", [("Cube", 0.0), ("PegInHole", 0.25)])
def test_sensor_chain_at_the_synthetic_shape(dev, scene, outside):
    """The sensor's chain on a synthetic scene's 16,384-point raw cloud (a
    share moved outside the bbox): one fps launch on the cluster route,
    bit-equal to the plain chain on the card and on the CPU."""
    from pointcloud_tpu_torch.envs.synthetic import SyntheticPegScene, SyntheticScene
    from pointcloud_tpu_torch.transforms import FilterBBox, sensor_chain

    sim = (SyntheticPegScene(seed=2, device="cpu") if scene == "PegInHole"
           else SyntheticScene(scene, seed=2, device="cpu"))
    points, rgb, labels = sim.render_points()
    pc = torch.from_numpy(np.concatenate([points, rgb, labels[:, None].astype(np.float32)], 1))
    out = torch.rand(len(pc), generator=torch.Generator().manual_seed(3)) < outside
    pc[out, 0] += 10.0
    bbox, K = sim.cfg["bbox"], sim.cfg["sample_points"]
    assert fps_plan(1, len(pc)).route == "cluster"
    before = farthest_point_sample.launches
    got, mask = sensor_chain(bbox, K, "FPS", 0, dev)(pc.to(dev))
    torch.cuda.synchronize()
    assert farthest_point_sample.launches - before == 1 and bool(mask.all())
    _, valid = FilterBBox(bbox)(pc.to(dev))
    plain = pc.to(dev)[fps_reference(pc[None, :, :3].to(dev).contiguous(), K, valid[None])[0].long()]
    cpu, _ = sensor_chain(bbox, K, "FPS", 0, "cpu")(pc)
    assert torch.equal(got, plain) and torch.equal(got.cpu(), cpu)


def test_pointcloud_sensor_env_on_the_card_equals_the_cpu(dev):
    """RoboPush with the PointCloudSensor (Passthrough encoder) on the card
    and on the CPU: reset and 2 steps give the same observations, sensed
    clouds and goals; one fps launch an observation."""
    from pointcloud_tpu_torch.envs.envs import RoboPush
    from pointcloud_tpu_torch.vision.pc_sensor import PointCloudSensor

    res = []
    for d in (dev, torch.device("cpu")):
        env = RoboPush(sensor=PointCloudSensor, require_segmentation=True, device=d)
        before = farthest_point_sample.launches
        seq = [env.reset(seed=6)[0]]
        for t in range(2):
            seq.append(env.step(np.full(4, 0.3 - 0.2 * t, np.float32))[0])
        if d.type == "cuda":
            assert farthest_point_sample.launches - before == 4  # goal + 3 observations
        res.append((seq, dict(env.observation), dict(env.goal_obs)))
    (seq, obs, goal), (cseq, cobs, cgoal) = res
    for a, b in zip(seq, cseq):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for k in ("points", "rgb", "segmentation"):
        np.testing.assert_array_equal(obs[k], cobs[k])
        np.testing.assert_array_equal(goal[k], cgoal[k])


def test_generate_dataset_on_the_card_equals_the_cpu(dev, tmp_path):
    from pointcloud_tpu_torch.envs.synthetic import generate_dataset

    for d in ("cuda", "cpu"):
        generate_dataset(str(tmp_path / d), scene="PegInHole", frames=2, seed=4, device=d)
    for name in ("0.npz", "1.npz"):
        a = np.load(tmp_path / "cuda" / name, allow_pickle=True)
        b = np.load(tmp_path / "cpu" / name, allow_pickle=True)
        for k in ("points", "rgb", "segmentation", "boundingbox"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _rl_batch(rng, B, obs, goal, act):
    return {"obs": rng.standard_normal((B, obs)).astype(np.float32),
            "desired": rng.standard_normal((B, goal)).astype(np.float32),
            "act": rng.uniform(-1, 1, (B, act)).astype(np.float32),
            "rew": -(rng.random(B) < 0.7).astype(np.float32),
            "next_obs": rng.standard_normal((B, obs)).astype(np.float32),
            "done": (rng.random(B) < 0.1).astype(np.float32)}


def _rl_close(got, want, tol, what):
    err = float((got.detach().cpu() - want.detach()).abs().max() / want.detach().abs().max())
    assert err <= tol, f"{what}: {err:.3e} of the largest entry"


@pytest.mark.parametrize("hidden,clip", [((64, 64), False), ((512, 512, 512), False),
                                         ((64, 64), True)])
def test_squashed_actor_noise_path_card_vs_cpu(dev, hidden, clip):
    """The TQC actor with a Gaussian draw, fp32 on the card and on the CPU
    from the same weights and draw: actions and log probabilities within
    1e-5 of their largest entry (clip: log_std at its upper clip)."""
    from pointcloud_tpu_torch.rl.core import SquashedGaussianActor, init_params

    cpu = init_params(SquashedGaussianActor(24, 4, 1.0, hidden), torch.Generator().manual_seed(0))
    if clip:
        with torch.no_grad():
            getattr(cpu, f"Dense_{len(hidden) + 1}").bias.fill_(30.0)
    card = SquashedGaussianActor(24, 4, 1.0, hidden).to(dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    o, noise = torch.randn(256, 24, generator=gen), torch.randn(256, 4, generator=gen)
    a, logp = card(o.to(dev), noise.to(dev))
    ca, clogp = cpu(o, noise)
    _rl_close(a, ca, 1e-5, "action")
    _rl_close(logp, clogp, 1e-5, "logp")
    d, _ = card(o.to(dev), deterministic=True)
    _rl_close(d, cpu(o, deterministic=True)[0], 1e-5, "deterministic action")


@pytest.mark.parametrize("hidden,B", [((64, 64), 256), ((512, 512, 512), 2048)])
def test_tqc_update_card_vs_cpu(dev, hidden, B):
    """One TQC update (tqc.yml's VisionReach and RoboPush agents) on the
    card and on the CPU from the same parameters, warm Adam state (three
    CPU updates first), batch and Gaussian draws: losses within 1e-5
    relative, every parameter and log_alpha within 1e-4 of its tensor's
    largest entry."""
    import copy

    from pointcloud_tpu_torch.rl.tqc import batch_tensors, make_agent

    obs, goal, act = 19, 3, 4
    kw = dict(hidden=hidden, critic_hidden=hidden, n_critics=2, n_quantiles=25,
              top_quantiles_to_drop=2, gamma=0.95, polyak=0.95, lr=1e-3)
    cpu = make_agent(obs + goal, act, 1.0, generator=torch.Generator().manual_seed(0),
                     device="cpu", **kw)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        cpu.update(batch_tensors(_rl_batch(rng, B, obs, goal, act), "cpu"),
                   torch.randn(B, act, generator=gen), torch.randn(B, act, generator=gen))
    card = make_agent(obs + goal, act, 1.0, generator=torch.Generator().manual_seed(9),
                      device=dev, **kw)
    for name in ("actor", "critic", "critic_target", "pi_opt", "q_opt", "a_opt"):
        getattr(card, name).load_state_dict(copy.deepcopy(getattr(cpu, name).state_dict()))
    with torch.no_grad():
        card.log_alpha.copy_(cpu.log_alpha)
    batch = _rl_batch(rng, B, obs, goal, act)
    n1, n2 = torch.randn(B, act, generator=gen), torch.randn(B, act, generator=gen)
    got = card.update(batch_tensors(batch, dev), n1.to(dev), n2.to(dev))
    want = cpu.update(batch_tensors(batch, "cpu"), n1, n2)
    for g, w, what in zip(got, want, ("q_loss", "pi_loss")):
        assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w)), (what, float(g), float(w))
    for name in ("actor", "critic", "critic_target"):
        want_params = dict(getattr(cpu, name).named_parameters())
        for pname, p in getattr(card, name).named_parameters():
            _rl_close(p, want_params[pname], 1e-4, f"{name}.{pname}")
    assert abs(float(card.log_alpha.detach()) - float(cpu.log_alpha.detach())) <= 1e-6


class _DictPolicy(torch.nn.Module):
    """A stand-in for an exported sb3 policy module (what export_policy
    writes to a .pth): forward(obs dict, deterministic) -> (action, None)."""

    def __init__(self, in_dim, act):
        super().__init__()
        self.lin = torch.nn.Linear(in_dim, act)

    def forward(self, obs, deterministic=True):
        return torch.tanh(self.lin(torch.cat([obs[k] for k in sorted(obs)], dim=-1))), None


def _write_policy(path, fmt, obs, goal, act):
    import io
    import zipfile

    from pointcloud_tpu_torch.rl import core
    from pointcloud_tpu_torch.rl.ddpg import _save
    from pointcloud_tpu_torch.rl.tqc import TQC

    gen = torch.Generator().manual_seed(5)
    if fmt == "tqc.pkl":
        TQC(core.init_params(core.SquashedGaussianActor(obs + goal, act, 1.0, (64, 64)), gen),
            1.0).save(path)
    elif fmt == "ddpg.pkl":
        _save(path, core.init_params(core.Actor(obs + goal, act, 1.0, (64, 64)), gen))
    elif fmt == "policy.pth":
        torch.manual_seed(5)
        torch.save(_DictPolicy(obs + 2 * goal, act), path)
    else:
        dims, sd = [obs + 2 * goal, 64, 64], {}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            sd[f"actor.latent_pi.{2 * i}.weight"] = torch.randn(b, a, generator=gen) / a ** 0.5
            sd[f"actor.latent_pi.{2 * i}.bias"] = torch.randn(b, generator=gen)
        sd["actor.mu.weight"] = torch.randn(act, 64, generator=gen) / 8
        sd["actor.mu.bias"] = torch.randn(act, generator=gen)
        buf = io.BytesIO()
        torch.save(sd, buf)
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("policy.pth", buf.getvalue())


@pytest.mark.parametrize("fmt", ["tqc.pkl", "ddpg.pkl", "policy.pth", "model.zip"])
def test_load_policy_runs_on_the_card(dev, tmp_path, fmt):
    """load_policy(path, device='cuda') puts each format's policy on the
    card, and its actions equal those of the same file loaded on the CPU
    within 1e-5 of the largest entry."""
    from pointcloud_tpu_torch.rl.policy import Sb3TqcPolicy, load_policy

    obs, goal, act = 5, 3, 4
    path = str(tmp_path / fmt)
    _write_policy(path, fmt, obs, goal, act)
    card, cpu = load_policy(path, device="cuda"), load_policy(path, device="cpu")
    if isinstance(card, Sb3TqcPolicy):
        tensors = [t for wb in (*card.hidden, card.mu) for t in wb]
    else:
        tensors = list((getattr(card, "actor", None) or card.policy).parameters())
    assert tensors and all(t.device.type == "cuda" for t in tensors)
    rng = np.random.default_rng(0)
    for _ in range(4):
        o = {"observation": rng.standard_normal(obs).astype(np.float32),
             "achieved_goal": rng.standard_normal(goal).astype(np.float32),
             "desired_goal": rng.standard_normal(goal).astype(np.float32)}
        a, _ = card.predict(o, deterministic=True)
        b, _ = cpu.predict(o, deterministic=True)
        assert a.shape == b.shape == (act,) and a.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), (fmt, a, b)


@pytest.fixture
def nccl_group(dev):
    """A one-rank NCCL group on 127.0.0.1 (the card holds one rank), left
    after the test."""
    import socket

    import torch.distributed as dist

    from pointcloud_tpu_torch.parallel import initialize

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_ring_chamfer_on_a_one_rank_nccl_group(dev, nccl_group):
    """ring_chamfer over the group (one nn_sweep, one chamfer_bwd) against
    chamfer_distance on the same masked clouds: value and gradients within
    1e-6 relative."""
    from pointcloud_tpu_torch.parallel import ring_chamfer

    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((2, 3000, 3), generator=gen, device=dev)
    y = torch.rand((2, 5000, 3), generator=gen, device=dev)
    xm = torch.rand((2, 3000), generator=gen, device=dev) > 0.2
    ym = torch.rand((2, 5000), generator=gen, device=dev) > 0.2
    got, want = [], []
    for fn, out in ((lambda a, b: ring_chamfer(a, b, nccl_group, xm, ym), got),
                    (lambda a, b: chamfer_distance(a, b, xm, ym), want)):
        a, b = x.clone().requires_grad_(), y.clone().requires_grad_()
        nn_sweep.launches = chamfer_bwd.launches = 0
        v = fn(a, b)
        v.backward()
        out += [v.detach(), a.grad, b.grad, nn_sweep.launches, chamfer_bwd.launches]
    assert got[3:] == want[3:] == [1, 1]
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-6


def test_ring_sinkhorn_on_a_one_rank_nccl_group(dev, nccl_group):
    """ring_sinkhorn_match over the group against the sinkhorn kernel, by the
    EMD rule."""
    from pointcloud_tpu_torch.parallel import ring_sinkhorn_match

    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand((2, 1000, 3), generator=gen, device=dev)
    y = torch.rand((2, 900, 3), generator=gen, device=dev)
    got = ring_sinkhorn_match(x, y, 0.005, 50, group=nccl_group)
    want = sinkhorn(x, y, 0.005, 50)
    *_, f, g = sinkhorn_reference(x, y, eps_schedule(0.005, 50))
    same, gap, d_err = matching_difference(x, y, f, g, got, want)
    assert same >= 0.995 and gap <= 1e-6 and d_err <= 1e-6, (same, gap, d_err)


@pytest.mark.parametrize("backbone,loss", [("PointNet", "chamfer"), ("PointNet2", None)])
def test_train_step_on_a_one_rank_nccl_group_is_bit_equal(dev, nccl_group, backbone, loss):
    """make_train_step(group=) on one rank against the step without a group
    from the same init and batch (bf16): losses, logs and every parameter and
    running statistic bit-equal over two steps."""
    from pointcloud_tpu_torch.train import create_model, make_optimizer, make_train_step

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand((4, 2048, 6), generator=gen, device=dev)
    runs = []
    for group in (nccl_group, None):
        spec = create_model("Autoencoder", backbone, "Cube", loss_override=loss, device=dev)
        step = make_train_step(spec, make_optimizer(spec), group)
        out = [step(x, x) for _ in range(2)]
        runs.append((out, spec.model.state_dict()))
    (out_g, state_g), (out_n, state_n) = runs
    for (lg, logs_g), (ln, logs_n) in zip(out_g, out_n):
        assert torch.equal(lg, ln) and logs_g.keys() == logs_n.keys()
        assert all(torch.equal(logs_g[k], logs_n[k]) for k in logs_g)
    for k, v in state_g.items():
        assert torch.equal(v, state_n[k]), k


def _traced():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _events(prof, device: bool):
    """The trace's device kernels (device=True) or its host events."""
    from torch.autograd import DeviceType

    return [e for e in prof.profiler.kineto_results.events()
            if (e.device_type() == DeviceType.CUDA) == device
            and not (device and e.is_user_annotation())]


def test_device_span_reads_its_kernel(dev):
    """A device span around one product reads the product's own interval in
    the trace within 50 us. A sleep kernel keeps the stream busy as the span
    opens, so its first event fires as that earlier work ends."""
    from pointcloud_tpu_torch.utils import profiling

    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    a @ a
    torch.cuda.synchronize()
    profiling.reset()
    try:
        with _traced() as prof:
            torch.cuda._sleep(2_000_000)
            with profiling.span("step.loss", device=True) as s:
                a @ a
            torch.cuda.synchronize()
        got = s.device_ms()
        work = [e for e in _events(prof, True) if "spin" not in e.name()]
        start = min(e.start_ns() for e in work)
        end = max(e.start_ns() + e.duration_ns() for e in work)
        assert abs(got - (end - start) / 1e6) <= 0.05, (got, (end - start) / 1e6)
        assert got > 0.5  # the product, not an empty interval
    finally:
        profiling.reset()


def test_span_encloses_its_kernels_on_the_profilers_clock(dev):
    """A span that waits for its own kernel encloses that kernel's interval
    in the trace, and its record_function event starts within 1 ms of it:
    the span's in-memory stamps are on the clock of the profiler's events."""
    from pointcloud_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    profiling.reset()
    try:
        with _traced() as prof:
            with profiling.span("step.eval"):  # the first record_function's one-off cost
                pass
            with profiling.span("step.eval") as s:
                torch.cuda._sleep(1_000_000)
                torch.cuda.synchronize()
        spin = [e for e in _events(prof, True) if "spin" in e.name()]
        assert len(spin) == 1
        k = spin[0]
        assert s.start_ns <= k.start_ns() and k.start_ns() + k.duration_ns() <= s.end_ns, (
            s.start_ns, s.end_ns, k.start_ns(), k.duration_ns())
        near = min(abs(e.start_ns() - s.start_ns) for e in _events(prof, False)
                   if e.name() == "step.eval")
        assert near < 1e6, near
    finally:
        profiling.reset()
