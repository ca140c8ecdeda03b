"""Ring Chamfer and ring Sinkhorn: point-sharded losses over a process group
(port of pointcloud_tpu/parallel/ring.py).

Every rank holds the same global clouds. Both functions pad the point axes
up to a multiple of the group's size (masked points for the Chamfer,
zero-mass points for the Sinkhorn), keep one shard of x's points at home on
each rank and rotate the shards of y around the ring (`ring_shift`, one
batch of point-to-point sends a step), so that after d steps every pair of
shards has met once on some rank. Each rank's work is O(N * M / d) and its
traffic O(M); no rank stores the (B, N, M) cost matrix. Both return the
global result on every rank.

`ring_chamfer` runs each step's masked nearest neighbours in both
directions through the `nn_sweep` wrapper (the kernel on the card), so even
the (B, N / d, M / d) tile of a step is never stored. Its backward is
linear in the points: it gathers every rank's nearest-neighbour indices and
runs the `chamfer_bwd` wrapper once over the global clouds, which carries
both terms of each point's gradient (its own nearest neighbour, and the
points of the other cloud, on any rank, whose nearest neighbour it is) and
gives the full gradient, the same bits, on every rank.

`ring_sinkhorn_match` keeps the JAX ring's log-domain iteration: f stays
home with its x rows, (y, g) shards rotate twice an iteration, and the
extraction takes the lowest global index on a tie. Its logsumexp tiles are
plain PyTorch, as the JAX ring's are XLA.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pointcloud_tpu_torch.ops.chamfer_bwd import chamfer_bwd
from pointcloud_tpu_torch.ops.geometry import pairwise_sqdist
from pointcloud_tpu_torch.ops.nn_sweep import nn_sweep
from pointcloud_tpu_torch.ops.sinkhorn import eps_schedule
from pointcloud_tpu_torch.parallel.distributed import (
    all_gather_cat,
    all_reduce_,
    ring_shift,
)


def _group_of(group):
    """(group, size, rank): the default group when None and one exists;
    without any group, (None, 1, 0)."""
    if group is None and not dist.is_initialized():
        return None, 1, 0
    group = dist.group.WORLD if group is None else group
    return group, dist.get_world_size(group), dist.get_rank(group)


def _shard(a, d: int, r: int, fill=0.0):
    """Rank r's shard of dim 1 of `a`, padded with `fill` up to a multiple
    of d: (shard, shard length)."""
    n = a.shape[1]
    if d == 1:
        return a.contiguous(), n
    loc = -(-n // d)
    if loc * d != n:
        pad = [0, 0] * (a.dim() - 2) + [0, loc * d - n]
        a = F.pad(a, pad, value=fill)
    return a[:, r * loc:(r + 1) * loc].contiguous(), loc


def _gather_points(a, group, n: int):
    """Every rank's shard of dim 1, concatenated and cut back to n."""
    if group is None:
        return a[:, :n]
    return all_gather_cat(a, group, 1)[:, :n]


def _nearer(val, idx, best, besti):
    """Take (val, idx) where val is smaller, or equal at a lower index."""
    take = (val < best) | ((val == best) & (idx < besti))
    return torch.where(take, val, best), torch.where(take, idx, besti)


class _RingChamfer(torch.autograd.Function):
    """(B,) per-cloud Chamfer of global clouds over the ring; the cotangent
    must be the same on every rank (a value every rank holds)."""

    @staticmethod
    def forward(ctx, group, x, y, x_mask, y_mask):
        group, d, r = _group_of(group)
        B, N, _ = x.shape
        M = y.shape[1]

        def mask(m, n):  # masks only where given or where padding needs them
            if m is None and n % d == 0:
                return None
            m = torch.ones((B, n), dtype=torch.bool, device=x.device) if m is None else m
            return _shard(m, d, r, fill=False)[0]

        x_loc, n_loc = _shard(x.float(), d, r)
        y_cur, m_loc = _shard(y.float(), d, r)
        xm_loc, ym_loc = mask(x_mask, N), mask(y_mask, M)
        ym_cur = ym_loc
        inf = torch.full((B, n_loc), math.inf, device=x.device)
        min_x, amin_x = inf, torch.zeros((B, n_loc), dtype=torch.int32, device=x.device)
        min_y = torch.full((B, m_loc), math.inf, device=x.device)
        amin_y = torch.zeros((B, m_loc), dtype=torch.int32, device=x.device)
        for s in range(d):
            q = (r - s) % d  # the visiting y shard
            mx, ax, my, ay = nn_sweep(x_loc, y_cur, xm_loc, ym_cur)
            min_x, amin_x = _nearer(mx, ax + q * m_loc, min_x, amin_x)
            min_y, amin_y = _nearer(my, ay + r * n_loc, min_y, amin_y)
            if s < d - 1:  # the running mins travel with their y shard
                travel = [y_cur, min_y, amin_y] + ([] if ym_cur is None else [ym_cur])
                y_cur, min_y, amin_y, *ym = ring_shift(travel, group)
                ym_cur = ym[0] if ym else None
            else:  # after d rotations they are home
                min_y, amin_y = ring_shift([min_y, amin_y], group)

        def masked_sums(v, m, n):  # (sum over valid points, their count)
            if m is None:
                return v.sum(1), torch.full((B,), float(n), device=v.device)
            w = m.float()
            return (v * w).sum(1), w.sum(1)

        sums = all_reduce_(torch.stack([*masked_sums(min_x, xm_loc, n_loc),
                                        *masked_sums(min_y, ym_loc, m_loc)]), group)
        cnt_x, cnt_y = sums[1].clamp(min=1.0), sums[3].clamp(min=1.0)
        ctx.group, ctx.N, ctx.M = group, N, M
        ctx.save_for_backward(x, y, x_mask, y_mask, amin_x, amin_y, cnt_x, cnt_y)
        return sums[0] / cnt_x + sums[2] / cnt_y

    @staticmethod
    def backward(ctx, g):
        x, y, x_mask, y_mask, amin_x, amin_y, cnt_x, cnt_y = ctx.saved_tensors
        N, M = ctx.N, ctx.M
        # every rank's nearest-neighbour indices, global; a point without a
        # valid counterpart points at 0 of a shard that may be padding
        amin_x = _gather_points(amin_x, ctx.group, N).clamp(max=M - 1)
        amin_y = _gather_points(amin_y, ctx.group, M).clamp(max=N - 1)
        gx = (g / cnt_x)[:, None].expand(-1, N)
        gy = (g / cnt_y)[:, None].expand(-1, M)
        if x_mask is not None:
            gx = gx * x_mask
        if y_mask is not None:
            gy = gy * y_mask
        dx, dy = chamfer_bwd(x.float().contiguous(), y.float().contiguous(),
                             gx.float().contiguous(), gy.float().contiguous(),
                             amin_x.contiguous(), amin_y.contiguous())
        return None, dx.to(x.dtype), dy.to(y.dtype), None, None


def ring_chamfer(x, y, group=None, x_mask=None, y_mask=None,
                 batch_reduction: str | None = "mean"):
    """Chamfer distance of x (B, N, C) and y (B, M, C), C <= 8, with the
    point axis sharded over the ranks of `group` (the default group when
    None; one rank without a group).

    Every rank passes the same clouds and gets the global value, and its
    gradient with respect to x and y is the full one, the same on every
    rank. Any N and M: point counts that do not divide the group's size are
    padded with masked points, which is exact. Optional bool masks (B, N) /
    (B, M) as `chamfer_distance`'s. batch_reduction 'mean' | 'sum' | None
    ((B,) per cloud)."""
    per_batch = _RingChamfer.apply(group, x, y, x_mask, y_mask)
    if batch_reduction == "mean":
        return torch.mean(per_batch)
    if batch_reduction == "sum":
        return torch.sum(per_batch)
    if batch_reduction is None:
        return per_batch
    raise ValueError(f"unknown batch_reduction {batch_reduction!r}")


@torch.no_grad()
def ring_sinkhorn_match(x, y, eps: float = 0.005, iters: int = 50,
                        anneal_from: float | None = None, group=None):
    """Point-sharded Sinkhorn-EMD matching with `sinkhorn_match`'s contract:
    (dists (B, N), assignment (B, N) int32) for x (B, N, C) and y (B, M, C),
    the same on every rank of `group` (the default group when None).

    x's rows and their potentials f stay home; (y, g) shards rotate past
    them twice an iteration (the column logsumexp of g, then the row
    logsumexp of f), accumulated shard by shard with logaddexp. Point
    counts that do not divide the group's size are padded with zero-mass
    points (log marginal -inf), which leaves the transport problem as it
    is. The assignment is the argmax of f_i + g_j - C_ij with the lowest
    global index on a tie, and dists is C there. No gradient."""
    group, d, r = _group_of(group)
    B, N, _ = x.shape
    M = y.shape[1]
    dev = x.device
    x_loc, n_loc = _shard(x.float(), d, r)
    y_loc, m_loc = _shard(y.float(), d, r)
    neg = -math.inf
    mu = torch.where(torch.arange(n_loc * d, device=dev) < N, -math.log(N), neg)
    nu = torch.where(torch.arange(m_loc * d, device=dev) < M, -math.log(M), neg)
    mu, nu = mu[r * n_loc:(r + 1) * n_loc], nu[r * m_loc:(r + 1) * m_loc]
    # pad rows must not give mass in the first column logsumexp (f = 0)
    penx = torch.where(torch.isneginf(mu), neg, 0.0)
    f = torch.zeros((B, n_loc), device=dev)
    g = torch.zeros((B, m_loc), device=dev)
    for e in eps_schedule(eps, iters, anneal_from).to(dev):
        # g: each y shard visits every rank, gathering its column logsumexp
        y_cur, acc = y_loc, torch.full((B, m_loc), neg, device=dev)
        for s in range(d):
            part = torch.logsumexp(((f + penx)[:, :, None] - pairwise_sqdist(x_loc, y_cur))
                                   / e, dim=1)
            acc = torch.logaddexp(acc, part)
            if s < d - 1:
                y_cur, acc = ring_shift([y_cur, acc], group)
            else:
                acc, = ring_shift([acc], group)
        g = e * (nu - acc)  # acc is home after d rotations
        # f: the (y, g) shards rotate past the stationary rows
        y_cur, g_cur = y_loc, g
        accf = torch.full((B, n_loc), neg, device=dev)
        for s in range(d):
            part = torch.logsumexp((g_cur[:, None, :] - pairwise_sqdist(x_loc, y_cur)) / e,
                                   dim=2)
            accf = torch.logaddexp(accf, part)
            if s < d - 1:
                y_cur, g_cur = ring_shift([y_cur, g_cur], group)
        f = e * (mu - accf)

    best = torch.full((B, n_loc), neg, device=dev)
    besti = torch.zeros((B, n_loc), dtype=torch.int32, device=dev)
    bestd = torch.zeros((B, n_loc), device=dev)
    y_cur, g_cur = y_loc, g
    for s in range(d):
        q = (r - s) % d
        cost = pairwise_sqdist(x_loc, y_cur)
        score = f[:, :, None] + g_cur[:, None, :] - cost
        loc_am = torch.argmax(score, dim=2)  # first index on ties
        loc_best = torch.gather(score, 2, loc_am[..., None])[..., 0]
        loc_d = torch.gather(cost, 2, loc_am[..., None])[..., 0]
        glob = loc_am.int() + q * m_loc
        take = (loc_best > best) | ((loc_best == best) & (glob < besti))
        best = torch.where(take, loc_best, best)
        besti = torch.where(take, glob, besti)
        bestd = torch.where(take, loc_d, bestd)
        if s < d - 1:
            y_cur, g_cur = ring_shift([y_cur, g_cur], group)
    return _gather_points(bestd, group, N), _gather_points(besti, group, N)
