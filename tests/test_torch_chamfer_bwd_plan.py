"""`chamfer_bwd_plan`, the kernel's sort and its order of sums, on the CPU.

csrc/chamfer_bwd.cu runs one launch of (2 * ranges, B) blocks of 512
threads: a block takes one direction of one cloud and a range of its
targets. On the shared route the other cloud's rows, cotangents and
argmins, the sort (8 warps' histograms, the bucket starts, the
permutation) and the pieces' sums live in shared memory; larger clouds
take the global route with the sort in a global scratch. Held here: the plan at every driven
shape (the PointNet and PointNet2 train steps at B=256, the PointMLP and
MSG train steps at B=32, the route check at B=4 x 4096); over a sweep of
shapes, that the ranges cover every target of both directions once and
that the shared memory as the kernel lays it out fits the card; both sides
of the shared-memory switch; shapes no launch takes raise.

`sort_model` mirrors the sort (8 warps each count a contiguous run of rows
into a histogram of their own, a prefix over warps and a scan of the bucket
lengths give each warp's first slot, the warps place their rows in run
order): every bucket holds its rows in increasing row order.
`kernel_model` mirrors the sums in numpy fp32, each operation rounded on
its own: a bucket's first 32 rows in row order from the point's own term,
every later piece of 32 rows from 0, the pieces added in piece order. It
is bit-equal to `scatter_rows_mirror` (the order the card is held to) and,
on a cloud whose y points all lie within 1e-3 of one x point (one bucket
of every y row), within 2e-6 of the plain version and of the JAX package's
gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_tpu.ops import chamfer as jch
from pointcloud_tpu_torch.ops import chamfer as tch
from pointcloud_tpu_torch.ops import chamfer_bwd, chamfer_bwd_plan, chamfer_bwd_reference
from pointcloud_tpu_torch.ops._launch import SMEM_LIMIT
from pointcloud_tpu_torch.ops.chamfer_bwd import PIECE, nn_terms
from pointcloud_tpu_torch.ops.scatter_rows import scatter_rows_mirror

# name: (B, N, M, C) -> (route, ranges, pieces, smem, scratch)
DRIVEN = {
    "PointNet / PointNet2 train, B=256": ((256, 2048, 2048, 6),
                                          ("shared", 1, 66, 111120, 0)),
    "PointMLP / MSG train, B=32": ((32, 2048, 2048, 6), ("shared", 8, 66, 85056, 0)),
    "route check, B=4 x 4096": ((4, 4096, 4096, 6), ("shared", 32, 130, 156224, 0)),
    "fp32 card vs CPU, B=2 x 512": ((2, 512, 512, 6), ("shared", 16, 18, 30400, 0)),
}


def up16(v):
    return -(-v // 16) * 16


def layout(nq, targets, C, staged):
    """csrc/chamfer_bwd.cu's Layout of a half (shared bytes, scratch
    bytes): staged, the rows (C fp32), cotangents and argmins of the nq
    summed points, a 16-bit permutation, the starts, two lists of nq // 33 +
    1 ints, then the larger of 8 x targets 16-bit counts and nq // 32 + 2
    pieces' sums with 16 tiles of 32 rows; else the tiles, and the rest
    32-bit in the scratch."""
    isize = 2 if staged else 4
    lists = 2 * up16((nq // 33 + 1) * 4)
    sort = up16(nq * isize) + up16((targets + 1) * 4) + lists
    hist = up16(8 * targets * isize)
    pieces, tiles = up16((nq // 32 + 2) * C * 4), 512 * C * 4
    if staged:
        return up16(nq * C * 4) + 2 * up16(nq * 4) + sort + max(hist, pieces + tiles), 0
    return tiles, sort + hist + pieces


@pytest.mark.parametrize("name", DRIVEN)
def test_driven_shapes_take_their_launch(name):
    shape, want = DRIVEN[name]
    p = chamfer_bwd_plan(*shape)
    assert (p.route, p.ranges, p.pieces, p.smem, p.scratch) == want
    assert p.threads == 512 and p.piece == PIECE
    assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("N,M", [(1, 1), (1, 5000), (64, 48), (1000, 2500), (2048, 2048),
                                 (4096, 4096), (6000, 100), (20000, 20000),
                                 (70000, 10)])
@pytest.mark.parametrize("C", [1, 3, 6, 8])
@pytest.mark.parametrize("B", [1, 4, 256])
def test_geometry_covers_every_target_once(B, N, M, C):
    p = chamfer_bwd_plan(B, N, M, C)
    staged = p.route == "shared"
    sizes = []
    for np_, nq in ((N, M), (M, N)):
        targets = -(-np_ // p.ranges)
        ranges = [(r * targets, min(np_, (r + 1) * targets)) for r in range(p.ranges)]
        covered = [t for lo, hi in ranges for t in range(lo, hi)]
        assert covered == list(range(np_))
        sizes.append(layout(nq, targets, C, staged))
    assert p.smem == max(s for s, _ in sizes) <= SMEM_LIMIT
    assert p.scratch == max(s for _, s in sizes)
    assert staged == (max(N, M) <= 65535 and p.scratch == 0)
    assert p.pieces == max(N, M) // PIECE + 2
    if staged and p.ranges > 1:
        # more ranges only while the histograms do not fit, or the blocks
        # fill less than a wave, and a range keeps 32 targets
        assert -(-min(N, M) // p.ranges) >= 32


def test_shared_memory_switch():
    """C = 8 clouds of 2,048 and 4,096 points on the shared route (the
    larger with fewer targets a range, so that the histograms fit), 8,192
    points and a pair past 65,535 points on the global route."""
    assert chamfer_bwd_plan(256, 2048, 2048, 8).ranges == 1
    p = chamfer_bwd_plan(256, 4096, 4096, 8)
    assert (p.route, p.ranges) == ("shared", 2)
    assert chamfer_bwd_plan(256, 8192, 8192, 8).route == "global"
    assert chamfer_bwd_plan(1, 70000, 10, 3).route == "global"


@pytest.mark.parametrize("B,N,M,C", [(0, 1, 1, 3), (65536, 1, 1, 3), (1, 0, 1, 3),
                                     (1, 1, 0, 3), (1, 1, 1, 0), (1, 1, 1, 9),
                                     (1, 1 << 27 + 1, 1, 3)])
def test_shapes_no_launch_takes_are_refused(B, N, M, C):
    with pytest.raises(ValueError):
        chamfer_bwd_plan(B, N, M, C)


def sort_model(aq, t0, nt, warps=8):
    """The kernel's sort of the rows j (targets aq[j]) into the targets t0
    .. t0 + nt - 1: (perm, start), bucket t's rows at perm[start[t] :
    start[t + 1]]."""
    nq = len(aq)
    run = (-(-nq // warps) + 31) // 32 * 32
    runs = [range(w * run, min(nq, (w + 1) * run)) for w in range(warps)]
    hist = np.zeros((warps, nt), np.int64)
    for w, rows in enumerate(runs):
        for j in rows:
            if 0 <= aq[j] - t0 < nt:
                hist[w, aq[j] - t0] += 1
    start = np.concatenate([[0], np.cumsum(hist.sum(0))])
    slot = start[:-1] + np.cumsum(hist, 0) - hist  # each warp's first slot
    perm = np.full(start[-1], -1, np.int64)
    for w, rows in enumerate(runs):
        for j in rows:
            t = aq[j] - t0
            if 0 <= t < nt:
                perm[slot[w, t]] = j
                slot[w, t] += 1
    return perm, start


@pytest.mark.parametrize("nq,nt,t0", [(1, 1, 0), (300, 40, 0), (1000, 50, 25),
                                      (2048, 2048, 0), (777, 13, 600)])
def test_sort_model_keeps_each_bucket_in_row_order(nq, nt, t0):
    rng = np.random.default_rng(nq)
    aq = rng.integers(0, t0 + nt + 5, nq)
    aq[::3] = t0  # a long bucket
    perm, start = sort_model(aq, t0, nt)
    assert (perm >= 0).all()
    for t in range(nt):
        np.testing.assert_array_equal(perm[start[t]:start[t + 1]],
                                      np.flatnonzero(aq == t0 + t))
    # the pieces after a long bucket's first land on distinct slots
    slots = [s // PIECE + q for t in range(nt)
             for s, e in [(start[t], start[t + 1])]
             for q in range(1, -(-(e - s) // PIECE))]
    assert len(slots) == len(set(slots))
    assert max(slots, default=0) < len(aq) // PIECE + 2


def kernel_model(x, y, gx, gy, ax, ay):
    """The kernel's sums (numpy fp32, each operation rounded on its own)."""
    two = np.float32(2)
    out = []
    for p, q, gp, gq, ap, aq in ((x, y, gx, gy, ax, ay), (y, x, gy, gx, ay, ax)):
        d = np.empty_like(p)
        for b in range(p.shape[0]):
            perm, start = sort_model(aq[b], 0, p.shape[1])
            for t in range(p.shape[1]):
                rows = perm[start[t]:start[t + 1]]
                acc = (two * gp[b, t]) * (p[b, t] - q[b, ap[b, t]])
                parts = []
                for lo in range(0, max(1, len(rows)), PIECE):
                    part = acc if lo == 0 else np.zeros_like(acc)
                    for r in rows[lo:lo + PIECE]:
                        part = part - (two * gq[b, r]) * (q[b, r] - p[b, t])
                    parts.append(part)
                acc = parts[0]
                for part in parts[1:]:
                    acc = acc + part
                d[b, t] = acc
        out.append(d)
    return out


def collapsed(seed, B, N, M, C):
    """x in the unit cube; every y point within 1e-3 of x point 5 (which
    is the nearest x point of every y point: one bucket of M rows)."""
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, C), dtype=np.float32)
    y = (x[:, 5:6] + 1e-3 * rng.random((B, M, C), dtype=np.float32)).astype(np.float32)
    gx = rng.standard_normal((B, N)).astype(np.float32)
    gy = rng.standard_normal((B, M)).astype(np.float32)
    return x, y, gx, gy


def argmins(x, y):
    d = ((x[:, :, None].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    return d.argmin(2).astype(np.int32), d.argmin(1).astype(np.int32)


@pytest.mark.parametrize("case", ["random", "collapsed"])
def test_kernel_model_is_the_mirror_order(case):
    """Bit-equal to scatter_rows_mirror(-ty, amin_y, N, init=tx) (and dy's),
    within 2e-6 of the plain version: buckets of 1 to 300 rows, three
    pieces on the collapsed cloud."""
    if case == "random":
        rng = np.random.default_rng(1)
        x = rng.random((2, 80, 3), dtype=np.float32)
        y = rng.random((2, 300, 3), dtype=np.float32)
        gx = rng.standard_normal((2, 80)).astype(np.float32)
        gy = rng.standard_normal((2, 300)).astype(np.float32)
        y[:, 150:] = x[:, 7:8] + 1e-3 * y[:, 150:]  # a bucket of 150 rows
    else:
        x, y, gx, gy = collapsed(2, 2, 80, 300, 3)
    ax, ay = argmins(x, y)
    if case == "collapsed":
        assert (ay == 5).all()
    got = kernel_model(x, y, gx, gy, ax, ay)
    t = [torch.from_numpy(a) for a in (x, y, gx, gy, ax, ay)]
    tx, ty = nn_terms(*t)
    mirror = (scatter_rows_mirror(-ty, t[5], 80, init=tx, piece=PIECE),
              scatter_rows_mirror(-tx, t[4], 300, init=ty, piece=PIECE))
    plain = chamfer_bwd_reference(*t)
    for g, m, w in zip(got, mirror, plain):
        np.testing.assert_array_equal(g, m.numpy())
        np.testing.assert_allclose(g, w.numpy(), atol=2e-6, rtol=0)


def test_collapsed_cloud_gradients_match_jax():
    """nearest_neighbor_dists' gradients on a collapsed cloud (every y row
    in x point 5's bucket, 1,000 rows: 8 pieces on the card) against the
    JAX package's VJP, 1e-6 absolute; the backward takes the fused kernel."""
    x, y, gx, gy = collapsed(3, 2, 64, 1000, 6)
    xm = np.ones((2, 64), bool)
    ym = np.ones((2, 1000), bool)
    ym[1, :10] = False
    gy = gy * ym
    calls = []
    real = tch.chamfer_bwd
    tch.chamfer_bwd = lambda *a: calls.append(1) or real(*a)
    try:
        tx = torch.from_numpy(x).requires_grad_()
        ty = torch.from_numpy(y).requires_grad_()
        mx, my = tch.nearest_neighbor_dists(tx, ty, torch.from_numpy(xm),
                                            torch.from_numpy(ym))
        torch.autograd.backward((mx, my), (torch.from_numpy(gx), torch.from_numpy(gy)))
    finally:
        tch.chamfer_bwd = real
    assert calls == [1] and real is chamfer_bwd
    _, vjp = jax.vjp(lambda a, b: jch.nearest_neighbor_dists(
        a, b, jnp.asarray(xm.astype(np.float32)), jnp.asarray(ym.astype(np.float32))),
        jnp.asarray(x), jnp.asarray(y))
    want_x, want_y = vjp((jnp.asarray(gx), jnp.asarray(gy)))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(want_y), atol=1e-6, rtol=0)
    assert abs(float(tx.grad[0, 5].abs().max())) > 0
