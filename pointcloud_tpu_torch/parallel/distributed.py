"""Process groups and the port's collectives (port of
pointcloud_tpu/parallel/distributed.py).

The JAX package runs one process a host over all of its devices and lets
XLA compile the collectives of a sharded `jit`. The port runs one process a
device (a rank) and calls `torch.distributed` itself: `initialize` joins the
group (NCCL for a card, gloo for the CPU), and the collectives below are the
only places the port communicates.

Data parallelism. The JAX package's train step runs over a batch sharded on
its mesh, so every batch-level reduction inside it (the train-mode
BatchNorm statistics, a loss's ratios) is taken over the global batch. The
port's train step enters `sharded_batch(group)`; inside it `batch_group()`
names the group whose ranks each hold an equal slice of the batch, and the
models and losses reduce their batch sums over it (`all_reduce_sum`, whose
backward sums the cotangents, so the BatchNorm backward is the global
batch's too). Outside it `batch_group()` is None and nothing communicates.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> bool:
    """Join the default process group; False (no group) on a single process.

    The arguments default to the variables torchrun sets: MASTER_ADDR and
    MASTER_PORT (coordinator_address "host:port"), WORLD_SIZE and RANK.
    Without a coordinator and a process count there is nothing to join,
    and the call returns False, as the JAX function does. The backend is
    NCCL for a CUDA `device` and gloo for the CPU; on a card the process
    takes device LOCAL_RANK (else its rank modulo the cards it sees) as its
    current device before the group forms. Call it before any other CUDA
    work. Joining twice returns True."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if coordinator_address is None or num_processes is None:
        return False
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') needs a CUDA device; pass "
                               "device='cpu' to join over gloo")
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def world_size(group=None) -> int:
    """Ranks of `group` (the default group when None); 1 without a group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in `group`; 0 without a group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def global_mesh(axis_names=("data",), shape=None):
    """A DeviceMesh over every rank of the default group (the JAX
    function's mesh over every host's devices): 1-D by default, else
    `shape`. `mesh.get_group(axis)` is the process group of an axis."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs a process group: call initialize()")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape or (dist.get_world_size(),)),
                            mesh_dim_names=tuple(axis_names))


def process_local_batch_slice(global_batch: int, group=None) -> slice:
    """The [start, stop) rows of a global batch this rank holds."""
    per = global_batch // world_size(group)
    start = rank(group) * per
    return slice(start, start + per)


############################ data parallelism ############################

_batch_group = None  # the group of a sharded batch, while a train step runs


@contextlib.contextmanager
def sharded_batch(group):
    """Inside, `batch_group()` is `group`: every rank of it holds an equal
    slice of one batch, and batch-level reductions are taken over the
    group. A None group is a batch on one rank. Run the backward inside as
    well: the reductions of the backward ask for the group too."""
    global _batch_group
    outer, _batch_group = _batch_group, group
    try:
        yield
    finally:
        _batch_group = outer


def batch_group():
    """The process group of the batch being computed, or None."""
    return _batch_group


def batch_world() -> int:
    """Ranks the batch is split over (1 outside `sharded_batch`)."""
    return 1 if _batch_group is None else dist.get_world_size(_batch_group)


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group's ranks; backward: the sum of the
    ranks' cotangents (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


def all_reduce_sum(x, group):
    """The sum of `x` over the ranks of `group`, differentiable; `x` itself
    when `group` is None."""
    if group is None:
        return x
    return _AllReduceSum.apply(group, x)


def batch_sum(x):
    """`all_reduce_sum(x, batch_group())`: a batch's sum over its ranks."""
    return all_reduce_sum(x, _batch_group)


class _SumCotangents(torch.autograd.Function):
    """Forward: the identity; backward: the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


def sum_cotangents(x, group):
    """`x`, whose cotangent becomes the sum of every rank's: turns the
    cotangents of a value every rank holds (each rank's own share) into the
    cotangent of the value itself, which a replicated computation before it
    expects on every rank."""
    return _SumCotangents.apply(group, x)


class _GatherBatch(torch.autograd.Function):
    """Forward: the ranks' equal slices concatenated along dim 0 in rank
    order; backward: this rank's slice of the cotangent (the cotangent of
    the whole is the same on every rank)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[0] // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return None, g[r * n:(r + 1) * n]


def gather_batch(x, group):
    """The global batch (dim 0 of every rank's equal slice `x`, in rank
    order) on every rank. Its gradient is this rank's slice of the
    cotangent, which must be the same on every rank (`sum_cotangents`)."""
    return _GatherBatch.apply(group, x)


def all_gather_cat(x, group, dim: int):
    """The ranks' `x` concatenated along `dim` in rank order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_(x, group):
    """In-place sum of `x` over the ranks of `group` (no gradient); `x`."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def ring_shift(tensors, group=None):
    """Send each tensor to the next rank of `group` (the default group when
    None) and receive the previous rank's, in one batch of point-to-point operations: the ring's rotation.
    Returns the received tensors (new ones). On one rank, `tensors`."""
    if not dist.is_initialized():
        return list(tensors)
    group = dist.group.WORLD if group is None else group
    d = dist.get_world_size(group)
    if d == 1:
        return list(tensors)
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % d)
    prv = dist.get_global_rank(group, (r - 1) % d)
    got = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in got]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return got


def average_gradients(params, group):
    """Replace each parameter's gradient by its mean over the ranks of
    `group`, in one all-reduce of the gradients laid end to end. With a
    BatchNorm over the global batch, each rank's gradient holds its share
    of the global loss's (the ranks' losses summed), so the mean is the
    gradient of the global batch's mean loss."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def rank_mean(values, group):
    """The mean over the ranks of `group` of a list of scalar tensors (one
    all-reduce, no gradient), each in its own dtype."""
    flat = torch.stack([v.detach().float() for v in values])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [f.to(v.dtype) for f, v in zip(flat, values)]
