"""Earth Mover's Distance matching (port of pointcloud_tpu/ops/emd.py).

Two backends with one (dists, assignment) contract: for each predicted
point, the squared distance to its assigned target and the target's index.

  * 'sinkhorn' (default): entropic optimal transport in the log domain. On a
    CUDA device `emd_match` runs the hand-written kernels of ops/sinkhorn.py
    (first three dims, direct fp32 differences), on the CPU their plain
    version. `sinkhorn_match` below is the JAX package's XLA formulation over
    a stored cost matrix from `pairwise_sqdist` (all dims, matmul expansion):
    the CPU tests hold it against the JAX package and chip_smoke.py times it
    beside the kernel; `emd_match` does not call it.
  * 'auction': the deterministic reformulation of the reference CUDA auction
    (scatter-max bids, lowest bidder on ties). It has no TPU kernel and is
    plain PyTorch here.

The gradient goes to the predicted cloud only, through the matched squared
distance with the assignment held constant: dx = 2 g (x - y[assignment]).
"""

from __future__ import annotations

import math

import torch

from pointcloud_tpu_torch.ops.chamfer_bwd import gather_rows
from pointcloud_tpu_torch.ops.geometry import pairwise_sqdist
from pointcloud_tpu_torch.ops.sinkhorn import eps_schedule, sinkhorn


def sinkhorn_match(x, y, eps: float = 0.005, iters: int = 50,
                   anneal_from: float | None = None):
    """Entropic-OT matching between equal-weight clouds x (B, N, C) and
    y (B, M, C): (dists (B, N), assignment (B, N) int32).

    `iters` iterations from f = g = 0, each g <- e (log(1/M) - logsumexp_i((f_i
    - C_ij) / e)) from the old f, then f from the new g, at the temperature
    `eps` or, with `anneal_from`, its geometric decay anneal_from -> eps; then
    the argmax of f_i + g_j - C_ij over j and C at it. The (B, N, M) cost is
    stored."""
    cost = pairwise_sqdist(x, y).float()
    B, N, M = cost.shape
    log_mu, log_nu = -math.log(N), -math.log(M)
    f = torch.zeros((B, N), dtype=torch.float32, device=cost.device)
    g = torch.zeros((B, M), dtype=torch.float32, device=cost.device)
    for e in eps_schedule(eps, iters, anneal_from).to(cost.device):
        g = e * (log_nu - torch.logsumexp((f[:, :, None] - cost) / e, dim=1))
        f = e * (log_mu - torch.logsumexp((g[:, None, :] - cost) / e, dim=2))
    scores = f[:, :, None] + g[:, None, :] - cost
    assignment = torch.argmax(scores, dim=2)  # first index on ties
    dists = torch.gather(cost, 2, assignment[..., None])[..., 0]
    return dists, assignment.int()


def auction_match(x, y, eps: float = 0.005, iters: int = 50):
    """Deterministic auction matching: (dists (B, N), assignment (B, N) int32).

    Each round every unassigned point bids for its best target with the
    increment best - second best + eps; the highest bid per target wins (the
    lowest bidder on ties) and evicts the previous owner. Points still
    unassigned after `iters` rounds fall back to their nearest target."""
    cost = pairwise_sqdist(x, y).float()
    B, N, M = cost.shape
    dev = cost.device
    NEG = -1e30
    bidder_ids = torch.arange(N, device=dev).expand(B, N)
    target_ids = torch.arange(M, device=dev).expand(B, M)
    owner = torch.full((B, M), -1, dtype=torch.long, device=dev)
    price = torch.zeros((B, M), dtype=torch.float32, device=dev)
    for _ in range(iters):
        # a point owns at most one target, so a scatter rebuilds the mask
        assigned = torch.zeros((B, N), dtype=torch.int32, device=dev).scatter_reduce_(
            1, owner.clamp_min(0), (owner >= 0).int(), "amax",
            include_self=True).bool()
        value = -cost - price[:, None, :]
        # max gives the first index on ties, as jax.lax.top_k does;
        # torch.topk promises no order among equal values
        best, target = value.max(dim=2)
        second = value.scatter(2, target[..., None], -math.inf).max(dim=2).values
        bid = torch.where(~assigned,
                          torch.gather(price, 1, target) + best - second + eps,
                          NEG)
        best_bid = torch.full((B, M), NEG, dtype=torch.float32, device=dev
                              ).scatter_reduce_(1, target, bid, "amax",
                                                include_self=True)
        is_winner = ~assigned & (bid == torch.gather(best_bid, 1, target))
        winner = torch.full((B, M), N, dtype=torch.long, device=dev).scatter_reduce_(
            1, target, torch.where(is_winner, bidder_ids, N), "amin",
            include_self=True)
        has_winner = winner < N
        owner = torch.where(has_winner, winner, owner)
        price = torch.where(has_winner, best_bid, price)
    assignment = torch.full((B, N), -1, dtype=torch.long, device=dev).scatter_reduce_(
        1, owner.clamp_min(0), torch.where(owner >= 0, target_ids, -1), "amax",
        include_self=True)
    assignment = torch.where(assignment < 0, torch.argmin(cost, dim=2), assignment)
    dists = torch.gather(cost, 2, assignment[..., None])[..., 0]
    return dists, assignment.int()


def _emd_forward(x, y, eps, iters, method, anneal_from):
    """Route one matching: 'auction' to `auction_match`, anything else to
    the `sinkhorn` wrapper, which launches its kernels on a CUDA device for
    every N and M. The JAX package's multi-chip ring route is not ported."""
    if method == "auction":
        return auction_match(x, y, eps=eps, iters=iters)
    return sinkhorn(x, y, eps=eps, iters=iters, anneal_from=anneal_from)


class _EmdMatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, eps, iters, method, anneal_from):
        dists, assignment = _emd_forward(x, y, eps, iters, method, anneal_from)
        ctx.save_for_backward(x, y, assignment)
        ctx.mark_non_differentiable(assignment)
        return dists, assignment

    @staticmethod
    def backward(ctx, g_dists, _g_assignment):
        x, y, assignment = ctx.saved_tensors
        dx = 2.0 * g_dists[..., None] * (x - gather_rows(y, assignment))
        return dx.to(x.dtype), None, None, None, None, None


def emd_match(x, y, eps: float = 0.005, iters: int = 50,
              method: str = "sinkhorn", anneal_from: float | None = None):
    """EMD matching of x (B, N, C) against y (B, M, C): (dists (B, N),
    assignment (B, N) int32). The gradient flows to `x` only, dx = 2 g (x -
    y[assignment]) over all C dims, with the assignment held constant; `y`
    gets none. The Sinkhorn backend matches on the first three dims (as the
    TPU kernel does); callers pass xyz."""
    return _EmdMatch.apply(x, y, eps, iters, method, anneal_from)
