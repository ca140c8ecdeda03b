"""Run a function on several CPU ranks of a gloo process group, for the
port's multi-rank tests (tests/test_torch_ring.py, test_torch_data_parallel.py,
test_torch_multihost.py).

`run_ranks(fn, world, *args)` starts `world` processes under the 'spawn'
context on a free localhost port, each calling `fn(*args)` after joining
the group, and returns their results in rank order. `fn` must be a
module-level function of an importable module (this one, or a test helper)
and its arguments and results must pickle: pass numpy arrays, not JAX ones.
A rank that raises sends its traceback, and the parent raises with it; a
rank that does not answer within `timeout` seconds fails the call.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, args, out):
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        import torch
        import torch.distributed as dist

        from pointcloud_tpu_torch.parallel import initialize

        torch.set_num_threads(1)
        initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
        try:
            out.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout: float = 240.0):
    """[fn(*args) on rank 0, ..., on rank world - 1], each rank a process
    that has joined a `world`-rank gloo group."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, ok, value = out.get(timeout=timeout)
            except queue.Empty:
                errors.append(f"a rank gave no result within {timeout} s")
                break
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


############################ rank-side cases ############################


def ring_cases(chamfer, sinkhorn):
    """On every rank: `ring_chamfer` of each Chamfer case (name -> (x, y or
    None for x against itself, x_mask, y_mask), numpy), its value and the
    gradients with respect to x and y; `ring_sinkhorn_match` of each
    Sinkhorn case (name -> (x, y, eps, iters, anneal_from)). Returns the
    two dicts of results."""
    import torch

    from pointcloud_tpu_torch.parallel import ring_chamfer, ring_sinkhorn_match

    out, matched = {}, {}
    for name, (x, y, xm, ym) in chamfer.items():
        tx = torch.from_numpy(x).requires_grad_()
        ty = tx if y is None else torch.from_numpy(y).requires_grad_()
        value = ring_chamfer(tx, ty, x_mask=None if xm is None else torch.from_numpy(xm),
                             y_mask=None if ym is None else torch.from_numpy(ym))
        value.backward()
        out[name] = (float(value.detach()), tx.grad.numpy(),
                     None if y is None else ty.grad.numpy())
    for name, (x, y, eps, iters, anneal) in sinkhorn.items():
        d, a = ring_sinkhorn_match(torch.from_numpy(x), torch.from_numpy(y), eps, iters,
                                   anneal)
        matched[name] = (d.numpy(), a.numpy())
    return out, matched


def train_step_case(model_type, backbone, loss_override, x, y, sample_points=128,
                    emd_iters=10, seed=0, ring_min=None, local_batch=False):
    """One `make_train_step` step of create_model(model_type, backbone,
    "Cube", loss_override) on the CPU, at `sample_points` points and EMD
    at `emd_iters` iterations, from the init of `seed`, on the global batch
    (x, y) (numpy). Under a process group the step is data-parallel over
    the default group and this rank takes its slice of the batch; without
    one it runs on the whole batch. `ring_min` patches RING_MIN_ELEMENTS.
    `local_batch` plants a fault: the step leaves out `sharded_batch`, so
    statistics and loss ratios are each rank's own (the gradients are still
    averaged). Returns (loss, logs, gradients, state after the step, whether
    a group ran it), numpy, keyed by name. Restores the patched settings."""
    import contextlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from pointcloud_tpu_torch import cfg
    from pointcloud_tpu_torch.envs import scenes
    from pointcloud_tpu_torch.ops import chamfer
    from pointcloud_tpu_torch.train import harness

    saved = (dict(scenes.cfg_scene["Cube"]), cfg.emd_iterations,
             chamfer.RING_MIN_ELEMENTS, harness.sharded_batch)
    scenes.cfg_scene["Cube"] = dict(saved[0], sample_points=sample_points)
    cfg.emd_iterations = emd_iters
    if ring_min is not None:
        chamfer.RING_MIN_ELEMENTS = ring_min
    if local_batch:
        harness.sharded_batch = lambda group: contextlib.nullcontext()
    try:
        spec = harness.create_model(model_type, backbone, "Cube",
                                    loss_override=loss_override, device="cpu", seed=seed)
        opt = harness.make_optimizer(spec)
        group = harness.data_mesh(x.shape[0])
        if group is not None:
            x, y = harness.shard_batch(group, (x, y))
        step = harness.make_train_step(spec, opt, group)
        loss, logs = step(torch.from_numpy(np.ascontiguousarray(x)),
                          torch.from_numpy(np.ascontiguousarray(y)))
        grads = {k: p.grad.numpy().copy() for k, p in spec.model.named_parameters()}
        state = {k: v.numpy().copy() for k, v in spec.model.state_dict().items()}
        return (float(loss), {k: float(v) for k, v in logs.items()}, grads, state,
                dist.is_initialized())
    finally:
        (scenes.cfg_scene["Cube"], cfg.emd_iterations, chamfer.RING_MIN_ELEMENTS,
         harness.sharded_batch) = saved


def calls(*pairs):
    """[fn(*args) for (fn, args) in pairs]: several cases in one spawn."""
    return [fn(*args) for fn, args in pairs]


def routed_cases(ring_min, x, y, y_emd, eps, iters):
    """With RING_MIN_ELEMENTS at `ring_min`, on every rank holding the same
    clouds: chamfer_distance(x, y) (value, gradients) and emd_match(x,
    y_emd) (dists, assignment), and how many times each ring function ran."""
    import importlib

    import numpy as np
    import torch

    from pointcloud_tpu_torch.ops import chamfer, chamfer_distance, emd_match

    ring = importlib.import_module("pointcloud_tpu_torch.parallel.ring")
    ran = {"ring_chamfer": 0, "ring_sinkhorn_match": 0}
    originals = {k: getattr(ring, k) for k in ran}

    def counted(name):
        def fn(*a, **k):
            ran[name] += 1
            return originals[name](*a, **k)
        return fn

    saved = chamfer.RING_MIN_ELEMENTS
    chamfer.RING_MIN_ELEMENTS = ring_min
    for k in ran:
        setattr(ring, k, counted(k))
    try:
        tx = torch.from_numpy(x).requires_grad_()
        ty = torch.from_numpy(y).requires_grad_()
        value = chamfer_distance(tx, ty)
        value.backward()
        d, a = emd_match(torch.from_numpy(x[..., :3].copy()),
                         torch.from_numpy(y_emd[..., :3].copy()), eps, iters)
        return (float(value.detach()), tx.grad.numpy(), ty.grad.numpy(),
                d.numpy(), a.numpy(), dict(ran))
    finally:
        chamfer.RING_MIN_ELEMENTS = saved
        for k, fn in originals.items():
            setattr(ring, k, fn)


def multihost_train(input_root, output_root, epochs, ckpt_path=None, sample_points=128,
                    batch_size=4):
    """train(multihost=True) of the PointNet autoencoder (Chamfer) on the
    CPU at `sample_points` points on every rank of the default group.
    Returns (final loss, checkpoint dir, the epochs' numbers, the steps of
    the checkpoints this rank wrote, this rank's rank)."""
    import torch.distributed as dist

    from pointcloud_tpu_torch.envs import scenes
    from pointcloud_tpu_torch.train import harness

    saved = (dict(scenes.cfg_scene["Cube"]), harness.save_checkpoint_async)
    scenes.cfg_scene["Cube"] = dict(saved[0], sample_points=sample_points)
    wrote = []

    def recording(ckpt_dir, step, payload):
        wrote.append(step)
        return saved[1](ckpt_dir, step, payload)

    harness.save_checkpoint_async = recording
    try:
        epochs_seen = []
        loss, ckpt_dir = harness.train(
            "Autoencoder", "PointNet", "Cube", epochs=epochs, batch_size=batch_size,
            ckpt_path=ckpt_path, input_root=input_root, output_root=output_root,
            loss_override="chamfer", log_meshes=False, device="cpu", multihost=True,
            on_epoch=epochs_seen.append)
        return loss, ckpt_dir, epochs_seen, wrote, dist.get_rank()
    finally:
        scenes.cfg_scene["Cube"], harness.save_checkpoint_async = saved


def group_case(global_batch):
    """The group helpers on this rank: process_local_batch_slice, global_mesh's
    size and group, shard_batch of a dict batch, and data_mesh's refusal of
    a batch that does not divide the ranks."""
    import numpy as np
    import torch.distributed as dist

    from pointcloud_tpu_torch.parallel import (
        data_mesh,
        global_mesh,
        process_local_batch_slice,
        shard_batch,
    )

    mesh = global_mesh()
    batch = {"x": np.arange(global_batch * 2).reshape(global_batch, 2),
             "y": (np.arange(global_batch),)}
    try:
        data_mesh(global_batch + 1)
        refused = False
    except ValueError:
        refused = True
    return (process_local_batch_slice(global_batch), mesh.size(),
            dist.get_world_size(mesh.get_group("data")),
            shard_batch(data_mesh(global_batch), batch), refused)
