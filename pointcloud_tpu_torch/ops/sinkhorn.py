"""Log-domain Sinkhorn matching: CUDA kernel, plain version, wrapper.

Port of pointcloud_tpu/ops/pallas_kernels.py:_sinkhorn_kernel
(`sinkhorn_match_pallas`). The kernels are in csrc/sinkhorn.cu; its note
states the design and the bound. `sinkhorn` launches them for CUDA tensors
and takes the plain version `sinkhorn_reference` only for CPU tensors.

Both take clouds x (B, N, >=3) and y (B, M, >=3) of equal weights, use the
first three dims in fp32, and return (dists (B, N) f32, assignment (B, N)
i32): `iters` log-domain iterations from f = g = 0 (g from the old f, then f
from the new g) at the temperatures of `eps_schedule`, then each x point's
argmax_j (f_i + g_j - |x_i - y_j|^2) with the lowest index on ties and its
squared distance to that target, clamped at 0.

The matching is discontinuous: where a row's two best scores lie within the
potentials' round-off, kernel, plain version and the JAX package may pick
different targets, whose distances are not close. Tests and chip_smoke.py
therefore either assert a score margin for their seed or allow a small share
of flipped rows whose two candidates score within a stated gap
(`top_two_gap` measures it in float64).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from pointcloud_tpu_torch.ops import _build
from pointcloud_tpu_torch.ops._launch import SMS, sm_count

_MAX_BATCH = 65535  # gridDim.y
_MAX_ROWS = (1 << 31) // 3  # keeps every int32 index and offset in range
_CHUNK_BYTES = 1 << 30  # cost matrices the plain version holds at a time
_THREADS = 256  # threads of a sweep block (csrc/sinkhorn.cu kThreads)
_OUTPUTS = 4  # outputs a thread (kOut)
_SPLITS = (1, 2, 4, 8)  # q splits the sweep takes


class SinkhornPlan(NamedTuple):
    """Launch geometry of one `sinkhorn` call's sweeps: the g half-step
    over y's M points (q over x), the f half-step over x's N points."""
    B: int
    N: int
    M: int
    outputs: int  # outputs a thread
    split_x: int  # q split of the sweep whose outputs are x's points
    blocks_x: int  # its blocks a cloud
    split_y: int
    blocks_y: int


def _sweep_geometry(B: int, P: int, sms: int) -> tuple:
    """(split, blocks a cloud) of a sweep over P outputs: the fewest q
    groups whose blocks reach two a streaming multiprocessor, at most 8."""
    for sp in _SPLITS:
        blocks = -(-P // (_THREADS // sp * _OUTPUTS))
        if B * blocks >= 2 * sms:
            break
    return sp, blocks


@functools.lru_cache(maxsize=256)
def sinkhorn_plan(B: int, N: int, M: int, sms: int = SMS) -> SinkhornPlan:
    """The sweeps' geometry for B clouds of N against M points: _OUTPUTS
    outputs a thread (one shared-memory read serves as many pairs), and the
    q range of each staged tile split over 1, 2, 4 or 8 groups of warps
    when B alone gives fewer than two blocks an SM (`_sweep_geometry`; the
    groups' sums are merged in a fixed order). Shapes past the kernel's
    index range (gridDim.y = B <= 65535, int32 offsets) or empty raise
    ValueError."""
    if not (1 <= B <= _MAX_BATCH and N >= 1 and M >= 1
            and B * N <= _MAX_ROWS and B * M <= _MAX_ROWS):
        raise ValueError(f"sinkhorn kernel bounds exceeded: B={B} N={N} M={M}")
    split_x, blocks_x = _sweep_geometry(B, N, sms)
    split_y, blocks_y = _sweep_geometry(B, M, sms)
    return SinkhornPlan(B, N, M, _OUTPUTS, split_x, blocks_x, split_y, blocks_y)


def eps_schedule(eps: float, iters: int, anneal_from: float | None = None):
    """The (iters,) fp32 CPU tensor of temperatures: `eps` throughout, or
    the geometric decay anneal_from (eps / anneal_from)^(t / max(iters-1, 1)).
    Kernel and plain version read the same tensor, hence the same bits."""
    if anneal_from is None:
        return torch.full((iters,), float(eps), dtype=torch.float32)
    frac = torch.arange(iters, dtype=torch.float32) / max(iters - 1, 1)
    ratio = torch.tensor(eps / anneal_from, dtype=torch.float32)
    return torch.tensor(anneal_from, dtype=torch.float32) * ratio ** frac


def _cost(x, y):
    """(B, N, M) squared distances of fp32 (B, N, 3) and (B, M, 3) clouds in
    direct differences, (dx^2 + dy^2) + dz^2 with each operation rounded on
    its own: the kernel's arithmetic in its last pass."""
    d = [(x[:, :, None, c] - y[:, None, :, c]).square_() for c in range(3)]
    return d[0].add_(d[1]).add_(d[2])


def _soft_max(potential, cost, e, dim, buf):
    """logsumexp((potential - cost) / e) over `dim`, written out (max, exp,
    sum, log) in the work buffer `buf`. The shifted exponent is clamped at
    -87, where exp leaves fp32's normal range: each clamped term adds at most
    1.6e-38 to a sum that is at least 1, which rounds away, and the CPU's exp
    is some 50 times slower on arguments that underflow."""
    torch.sub(potential, cost, out=buf).div_(e)
    m = buf.amax(dim=dim, keepdim=True)
    s = buf.sub_(m).clamp_min_(-87.0).exp_().sum(dim=dim)
    return m.squeeze(dim) + s.log_()


def _potentials(cost, schedule):
    B, N, M = cost.shape
    log_mu, log_nu = -math.log(N), -math.log(M)
    f = torch.zeros((B, N), dtype=torch.float32, device=cost.device)
    g = torch.zeros((B, M), dtype=torch.float32, device=cost.device)
    buf = torch.empty_like(cost)
    for e in schedule.to(cost.device):
        g = e * (log_nu - _soft_max(f[:, :, None], cost, e, 1, buf))
        f = e * (log_mu - _soft_max(g[:, None, :], cost, e, 2, buf))
    return f, g


def sinkhorn_reference(x, y, schedule):
    """Plain PyTorch version: the sequence of ops/emd.py `sinkhorn_match`
    (logsumexp sweeps over a stored cost matrix, argmax, gather), which it
    differs from only in how the cost is formed: here in direct fp32
    differences over the first three dims and clamped at 0 in `dists`, as the
    kernel does; there by the matmul expansion over all dims. The batch is
    walked in chunks whose cost matrices stay within 1 GiB.

    Returns (dists, assignment, f, g): the potentials too, from which
    `top_two_gap` measures how clear each row's choice was."""
    x = x[..., :3].detach().float()
    y = y[..., :3].detach().float()
    B, N, M = x.shape[0], x.shape[1], y.shape[1]
    step = max(1, _CHUNK_BYTES // (N * M * 4))
    outs = []
    for b0 in range(0, B, step):
        cost = _cost(x[b0:b0 + step], y[b0:b0 + step])
        f, g = _potentials(cost, schedule)
        scores = (f[:, :, None] + g[:, None, :]).sub_(cost)
        assignment = torch.argmax(scores, dim=2)  # first index on ties
        del scores
        dists = torch.gather(cost, 2, assignment[..., None])[..., 0].clamp_min(0.0)
        outs.append((dists, assignment.int(), f, g))
    return tuple(torch.cat(t) for t in zip(*outs))


def top_two_gap(x, y, f, g, column=None):
    """Per row of x, the float64 gap between the two best scores
    (f_i + g_j) - |x_i - y_j|^2 over j, with the cost in float64 from the
    fp32 clouds' first three dims: (B, N) float64. With `column` (B, N) int,
    the gap between the best score and that column's score instead (0 where
    it is the best)."""
    x = x[..., :3].double()
    y = y[..., :3].double()
    scores = f.double()[:, :, None] + g.double()[:, None, :]
    for c in range(3):
        scores -= (x[:, :, None, c] - y[:, None, :, c]).square_()
    if column is not None:
        other = torch.gather(scores, 2, column.long()[..., None])[..., 0]
        return scores.max(dim=2).values - other
    top = torch.topk(scores, 2, dim=2).values
    return top[..., 0] - top[..., 1]


def matching_difference(x, y, f, g, got, want):
    """How far the matching `got` = (dists, assignment) lies from `want`, the
    plain version's, whose potentials are (f, g): the share of rows with equal
    assignments, the largest `top_two_gap` between the best column and got's
    column over the rows that differ (0.0 if none), and the largest |dists
    difference| over the rows that agree. Walks the batch 8 clouds at a time
    (a float64 score matrix each)."""
    same = got[1] == want[1]
    gap = 0.0
    for b0 in range(0, x.shape[0], 8):
        sl = slice(b0, b0 + 8)
        if bool(same[sl].all()):
            continue
        gaps = top_two_gap(x[sl], y[sl], f[sl], g[sl], column=got[1][sl])
        gap = max(gap, float(gaps[~same[sl]].max()))
    d_err = (got[0] - want[0]).abs()[same]
    return (float(same.float().mean()), gap,
            float(d_err.max()) if d_err.numel() else 0.0)


@functools.cache
def _launcher():
    fn = _build.load("sinkhorn").sinkhorn_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, y, iters):
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] < 3 or y.shape[2] < 3:
        raise ValueError(
            f"sinkhorn takes x (B, N, >=3) and y (B, M, >=3); got "
            f"{tuple(x.shape)} and {tuple(y.shape)}"
        )
    if not (x.is_floating_point() and y.is_floating_point()):
        raise TypeError(f"sinkhorn takes float clouds; got {x.dtype}, {y.dtype}")
    if min(x.shape[:2]) < 1 or y.shape[1] < 1:
        raise ValueError(f"sinkhorn takes non-empty clouds; got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if int(iters) != iters or iters < 0:
        raise ValueError(f"sinkhorn takes iters >= 0; got {iters}")
    if x.device != y.device:
        raise ValueError(
            f"sinkhorn inputs lie on several devices: {x.device}, {y.device}")
    return x.device


def sinkhorn(x, y, eps: float = 0.005, iters: int = 50,
             anneal_from: float | None = None):
    """Sinkhorn matching of x (B, N, >=3) against y (B, M, >=3): (dists
    (B, N) f32, assignment (B, N) i32), not differentiable (ops/emd.py
    `emd_match` carries the gradient).

    CPU tensors take the plain version. CUDA tensors launch the kernels, for
    every N and M (the TPU kernel's N % 64 gate was a tile limit of that
    kernel) up to the int32 index range, in the geometry of `sinkhorn_plan`;
    anything else raises. `sinkhorn.launches` counts the calls that launched
    the kernels (one call enqueues 2 iters + 1 CUDA kernels).
    """
    device = _check(x, y, iters)
    schedule = eps_schedule(eps, int(iters), anneal_from)
    if device.type == "cpu":
        return sinkhorn_reference(x, y, schedule)[:2]
    if device.type != "cuda":
        raise ValueError(f"sinkhorn runs on CPU or CUDA tensors, not {device}")
    B, N, M = x.shape[0], x.shape[1], y.shape[1]
    plan = sinkhorn_plan(B, N, M, sm_count(device.index))
    x3 = x[..., :3].detach().float().contiguous()
    y3 = y[..., :3].detach().float().contiguous()
    f = torch.zeros((B, N), dtype=torch.float32, device=device)
    g = torch.empty((B, M), dtype=torch.float32, device=device)
    dists = torch.empty((B, N), dtype=torch.float32, device=device)
    assignment = torch.empty((B, N), dtype=torch.int32, device=device)
    launch = _launcher()
    with torch.cuda.device(device):  # the library launches on the current one
        err = launch(
            x3.data_ptr(), y3.data_ptr(), f.data_ptr(), g.data_ptr(),
            dists.data_ptr(), assignment.data_ptr(),
            schedule.data_ptr(), int(iters), B, N, M, plan.split_x, plan.split_y,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sinkhorn kernel launch failed: CUDA error {err}")
    sinkhorn.launches += 1
    return dists, assignment


sinkhorn.launches = 0
