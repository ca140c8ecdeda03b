"""Model wiring, the steps, checkpoints and the training loop (port of
pointcloud_tpu/train/harness.py:57-153, :224-386 and :447-728).

`create_model` builds the model + loss + transforms + dataset factory of one
configuration on one device, optionally loading a checkpoint's weights
(`load_dir`, `encoder_only`); `make_optimizer` and `make_train_step` give
the training step (forward in train mode, loss, backward, Adam);
`make_eval_step` returns the eval forward + loss. `train()` runs the loop
over npz datasets with TensorBoard logging and checkpoints under the
reference's `output/{dataset}/{Model}_{Backbone}/version_N` layout, and
resumes from a checkpoint; under a process group it trains data-parallel
over the group's ranks (one process a device), the counterpart of the JAX
function's data_parallel and multihost meshes (`data_mesh`, `shard_batch`,
`shard_batch_global`, `replicate`). Every model type of cfg.models is ported on
every backbone of backbone_factory (PointNet, PointNet2, PointMLP,
PointMLPE): the Autoencoder (Earth Mover's Distance, its default loss, or
Chamfer with loss_override="chamfer"), the Segmenter (EMD with class
weights), the MultiSegmenter (per-class experts under the segmenting
Chamfer) and the StatePredictor (state heads under the per-state MSE).

Checkpoints are the port's own format (the JAX package writes orbax
directories): `step_E/checkpoint.pt`, one `torch.save` file of the model's
state_dict and the optimizer's (CPU tensors), the epoch, and the
configuration that built the model. interop.checkpoint_from_jax converts
the JAX package's train() checkpoint to it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import os
import re
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pointcloud_tpu_torch import cfg
from pointcloud_tpu_torch.data.dataset import (
    BatchLoader,
    PointCloudDataset,
    PointCloudGTDataset,
)
from pointcloud_tpu_torch.envs.scenes import scene_config
from pointcloud_tpu_torch.interop import load_state_exactly
from pointcloud_tpu_torch.losses import (
    ChamferDistance,
    EarthMoverDistance,
    SegmentingChamferDistance,
    StatePredictionLoss,
    _noop_log,
)
from pointcloud_tpu_torch.models.architectures import (
    AE,
    MultiGTEncoder,
    MultiSegAE,
    SegAE,
    backbone_factory,
)
from pointcloud_tpu_torch.models.layers import BatchNorm, Dense, init_flax_
from pointcloud_tpu_torch.models.pointnet import DenseBNMaxPool
from pointcloud_tpu_torch.parallel.distributed import (
    average_gradients,
    process_local_batch_slice,
    rank_mean,
    sharded_batch,
)
from pointcloud_tpu_torch.transforms import Normalize
from pointcloud_tpu_torch.utils import resolve_device
from pointcloud_tpu_torch.utils.profiling import count, span, trace


@dataclasses.dataclass
class TrainSpec:
    """Everything a step needs for one model configuration."""

    model: nn.Module  # on its device; steps pass train= explicitly
    loss: Any  # loss object (callable, with .log hook)
    open_dataset: Callable[[str], Any]  # input_dir -> dataset
    in_transform: Any  # (pc, mask) -> (pc, mask) for input clouds
    out_transform: Any  # the same for target clouds
    model_type: str
    backbone: str
    scene_name: str
    scene: Any  # SimpleNamespace scene config
    dict_target: bool = False  # target is a dict of states (StatePredictor)


def create_model(
    model_type: str,
    backbone: str,
    scene: str,
    loss_override: str | None = None,
    device="cuda",
    seed: int = 0,
    load_dir: str | None = None,
    encoder_only: bool = False,
) -> TrainSpec:
    """Build the TrainSpec of one configuration, its weights fresh or loaded.

    Model types (cfg.models), as the JAX package wires them:
      * Autoencoder: AE under EMD, or Chamfer with loss_override="chamfer";
      * Segmenter: SegAE under EMD with class weights;
      * MultiSegmenter: MultiSegAE with one expert per class of a latent
        dim above 0, ceil(share * sample_points) points each (computed in
        Python floats), under SegmentingChamferDistance; the target is
        xyz + the class label;
      * StatePredictor: MultiGTEncoder with one head per state of a dim
        above 0, under StatePredictionLoss, whose 3-d states are mapped
        through the scene's bbox into the unit cube (`norm_pos`); the
        target is a dict of states (dict_target), and no out_transform.
    loss_override is read by the Autoencoder alone, as in the JAX package.

    The weights follow flax's init (lecun_normal kernels, zero biases,
    BatchNorm ones/zeros, zero STN head), drawn on the CPU from a
    torch.Generator seeded with `seed`, so every device gets the same
    numbers; interop.load_flax_variables(spec.model, ...) replaces them with
    the JAX package's. Activations are bf16 on a CUDA device under
    cfg.precision == 'bf16-mixed' and fp32 on the CPU.

    load_dir: a checkpoint's step_N directory whose weights replace the
    fresh ones. With encoder_only, every key under a `decoder*` module keeps
    its fresh init (the reference's strict=False load of an encoder; the
    MultiSegmenter's bottlenecks and the StatePredictor's heads load); any
    other key the checkpoint lacks, any key the model lacks and any shape
    that differs raise. Where the JAX function returns (spec, variables),
    this one returns the spec with the weights already loaded.
    """
    with span("setup.create_model"):
        if model_type not in cfg.models:
            raise NotImplementedError(f"Unknown model type: {model_type}")
        if backbone not in backbone_factory:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported yet "
                f"(have {sorted(backbone_factory)})"
            )
        device = torch.device(device)
        sc = scene_config(scene)
        dtype = cfg.compute_dtype(device)
        encoder_backbone = backbone_factory[backbone](feature_dims=3, dtype=dtype)
        out_transform = Normalize(sc.bbox)
        dict_target = False
        if model_type == "Autoencoder":
            model = AE(
                encoder_backbone,
                out_points=sc.sample_points,
                out_dim=6,
                bottleneck=sum(sc.class_latent_dim),
                dtype=dtype,
            )
            if loss_override == "chamfer":
                loss = ChamferDistance()
            else:
                loss = EarthMoverDistance(
                    eps=cfg.emd_eps, its=cfg.emd_iterations, num_classes=None,
                    anneal_from=None,  # the constant-eps training operating point
                )
        elif model_type == "Segmenter":  # the target is (B, N, 4): xyz + label
            C = len(sc.classes)
            model = SegAE(
                encoder_backbone,
                num_classes=C,
                out_points=sc.sample_points,
                bottleneck=sum(sc.class_latent_dim),
                dtype=dtype,
            )
            loss = EarthMoverDistance(
                eps=cfg.emd_eps, its=cfg.emd_iterations, num_classes=C,
                anneal_from=None,
            )
        elif model_type == "MultiSegmenter":  # the target is (B, N, 4), as above
            name_points_dims = [
                (n, math.ceil(p * sc.sample_points), d)
                for (n, p, d) in zip(sc.classes, sc.class_distribution, sc.class_latent_dim)
                if d > 0
            ]
            class_labels = {n: sc.classes.index(n) for (n, _, _) in name_points_dims}
            model = MultiSegAE(encoder_backbone, class_labels, tuple(name_points_dims),
                               dtype=dtype)
            loss = SegmentingChamferDistance(class_labels)
        else:  # StatePredictor
            state_dims = {n: d for (n, d) in zip(sc.states, sc.state_dim) if d > 0}
            bbox = torch.tensor(sc.bbox, dtype=torch.float32, device=device)
            lo, extent = bbox[:, 0], bbox[:, 1] - bbox[:, 0]

            def norm_pos(x):
                """A 3-d position from the scene's bbox into the unit cube."""
                return (x - lo) / extent

            transforms = {n: norm_pos for n, d in state_dims.items() if d == 3}
            model = MultiGTEncoder(encoder_backbone, state_dims, dtype=dtype)
            loss = StatePredictionLoss(list(state_dims), transforms)
            out_transform = None
            dict_target = True
        init_flax_(model, torch.Generator().manual_seed(seed))
        if load_dir:
            payload = load_checkpoint_variables(load_dir, encoder_only=encoder_only)
            load_state(model, payload["model"], keep_fresh=encoder_only)
        if dict_target:
            open_dataset = lambda input_dir: PointCloudGTDataset(  # noqa: E731
                root_dir=input_dir, in_features=["rgb"])
        else:
            out_features = ["rgb"] if model_type == "Autoencoder" else ["segmentation"]
            open_dataset = lambda input_dir: PointCloudDataset(  # noqa: E731
                root_dir=input_dir, in_features=["rgb"], out_features=out_features)
        return TrainSpec(
            model=model.to(device).eval(),
            loss=loss,
            open_dataset=open_dataset,
            in_transform=Normalize(sc.bbox),
            out_transform=out_transform,
            model_type=model_type,
            backbone=backbone,
            scene_name=scene,
            scene=sc,
            dict_target=dict_target,
        )


def make_optimizer(spec: TrainSpec) -> torch.optim.Optimizer:
    """Adam over the model's parameters, as optax.adam(cfg.vision_lr): betas
    (0.9, 0.999), eps 1e-8 added outside the square root, bias-corrected."""
    return torch.optim.Adam(spec.model.parameters(), lr=cfg.vision_lr,
                            betas=(0.9, 0.999), eps=1e-8)


def make_train_step(spec: TrainSpec, optimizer: torch.optim.Optimizer, group=None):
    """step(x_raw, y_raw) -> (loss, logs): the transforms, the forward in
    train mode (BatchNorm batch statistics; the running statistics are
    updated), the loss with its `.log` hook, the backward and the optimizer
    step. Parameters, running statistics and optimizer state are updated in
    place, PyTorch's counterpart of the JAX step's donated buffers.

    group: data parallelism over its ranks, each passing its own equal
    slice of the global batch (`shard_batch`). Forward and backward run in
    `sharded_batch(group)`, so the BatchNorm statistics and the losses'
    batch ratios are the global batch's, as under the JAX package's sharded
    step; the gradients are averaged over the ranks before Adam, and the
    loss and logs returned are the global batch's (the ranks' mean), the
    same on every rank. On one rank the all-reduces change no bit."""
    params = list(spec.model.parameters())

    def step(x_raw, y_raw):
        with span("step.train"):
            with sharded_batch(group):
                with span("step.transforms"):
                    x, _ = spec.in_transform(x_raw)
                    y = y_raw if spec.dict_target else spec.out_transform(y_raw)[0]
                logs = {}
                spec.loss.log = lambda k, v: logs.__setitem__(k, v)
                with span("step.forward"):
                    out = spec.model(x, train=True)
                with span("step.loss", device=True):
                    loss = spec.loss(out, y)
                spec.loss.log = _noop_log
                with span("step.backward"):
                    optimizer.zero_grad(set_to_none=True)
                    loss.backward()
            logs = {k: torch.as_tensor(v).detach() for k, v in logs.items()}
            loss = loss.detach()
            if group is not None:
                average_gradients(params, group)
                loss, *vals = rank_mean([loss, *logs.values()], group)
                logs = dict(zip(logs, vals))
            with span("step.optimizer", device=True):
                optimizer.step()
            return loss, logs

    return step


def zero_gradient_biases(model: nn.Module) -> set[str]:
    """The state_dict names of the Dense biases that feed a train-mode
    BatchNorm: the bias of a Dense registered just before a BatchNorm in
    the same module, and every DenseBNMaxPool's bias. The batch mean removes
    such a bias, so its true gradient is exactly 0 and a computed one is
    round-off. Checks of gradients and of Adam's steps treat these apart."""
    names = set()
    for prefix, mod in model.named_modules():
        at = prefix + "." if prefix else ""
        if isinstance(mod, DenseBNMaxPool) and mod.bias is not None:
            names.add(at + "bias")
        kids = list(mod.named_children())
        for (name, a), (_, b) in zip(kids, kids[1:]):
            if isinstance(a, Dense) and isinstance(b, BatchNorm) and a.bias is not None:
                names.add(f"{at}{name}.bias")
    return names


def make_eval_step(spec: TrainSpec):
    """step(x_raw, y_raw) -> (loss, logs, out): the eval-mode forward and
    loss, without autograd. `out` doubles as the sample prediction."""

    def step(x_raw, y_raw):
        with span("step.eval"), torch.inference_mode():
            with span("step.transforms"):
                x, _ = spec.in_transform(x_raw)
                y = y_raw if spec.dict_target else spec.out_transform(y_raw)[0]
            logs = {}
            spec.loss.log = lambda k, v: logs.__setitem__(k, v)
            with span("step.forward"):
                out = spec.model(x, train=False)
            with span("step.loss", device=True):
                loss = spec.loss(out, y)
            spec.loss.log = _noop_log
        return loss, logs, out

    return step


############################ checkpoints ############################

CHECKPOINT_FILE = "checkpoint.pt"


def _map_tensors(fn, obj):
    """Apply fn to every tensor of a nested dict / list / tuple."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


def checkpoint_payload(spec: TrainSpec, optimizer: torch.optim.Optimizer,
                       epoch: int, loss_override: str | None = None) -> dict:
    """The four parts of a checkpoint, as references to the live tensors:
    the model's state_dict, the optimizer's, the epoch, and the
    configuration that built the model."""
    return {
        "model": spec.model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "epoch": int(epoch),
        "config": {"model_type": spec.model_type, "backbone": spec.backbone,
                   "scene": spec.scene_name, "loss_override": loss_override},
    }


def save_checkpoint(ckpt_dir: str, step: int, payload: dict) -> str:
    """Write `payload` (its tensors moved to the CPU) to
    ckpt_dir/step_{step}/checkpoint.pt; returns the step directory."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, CHECKPOINT_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(_map_tensors(lambda t: t.detach().cpu(), payload), tmp)
    os.replace(tmp, target)  # a reader never sees half a file
    return path


# One background writer: saves serialize among themselves but overlap with
# training.
_ckpt_executor = None
_pending_saves: list = []


def save_checkpoint_async(ckpt_dir: str, step: int, payload: dict):
    """Checkpoint without stalling the train loop.

    The payload's tensors are cloned on their device in the current stream,
    here, so the snapshot holds the weights of the step that made them and
    the next step's in-place Adam update cannot reach it; a background
    thread then copies the snapshot to the host (on a stream of its own,
    after the clones) and writes it. Call `wait_for_checkpoints()` before
    relying on the files.
    """
    global _ckpt_executor
    if _ckpt_executor is None:
        _ckpt_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt"
        )
    snap = _map_tensors(lambda t: t.detach().clone(), payload)
    devices = []
    _map_tensors(lambda t: devices.append(t.device), snap)
    device = next((d for d in devices if d.type == "cuda"), None)
    ready = None
    if device is not None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))

    def write():
        if ready is None:
            return save_checkpoint(ckpt_dir, step, snap)
        side = torch.cuda.Stream(device)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            host = _map_tensors(lambda t: t.cpu(), snap)
        return save_checkpoint(ckpt_dir, step, host)

    fut = _ckpt_executor.submit(write)
    _pending_saves.append(fut)
    return fut


def wait_for_checkpoints():
    """Block until every async checkpoint has been written (re-raises any
    writer exception)."""
    while _pending_saves:
        _pending_saves.pop().result()


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """Latest step_N dir (reference pc_encoder.py:15-26 discovery semantics)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and d[5:].isdigit()
    ]
    if not steps:
        return None
    best = max(steps, key=lambda d: int(d[5:]))
    return os.path.join(ckpt_dir, best)


def load_checkpoint_raw(path: str) -> dict:
    """A step_N directory's payload, its tensors on the CPU wherever they
    were saved."""
    return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)


def strip_decoders(state: dict) -> dict:
    """Drop the decoders' keys (reference encoder_only, train.py:85-130)."""
    return {k: v for k, v in state.items()
            if not k.split(".")[0].startswith(("decoder", "Decoder"))}


def load_checkpoint_variables(path: str, encoder_only: bool = False) -> dict:
    """A checkpoint's payload; with encoder_only, its model state_dict
    without the decoders (the caller merges it with a fresh init)."""
    payload = load_checkpoint_raw(path)
    if encoder_only:
        payload = dict(payload, model=strip_decoders(payload["model"]))
    return payload


def merge_variables(fresh: dict, loaded: dict) -> dict:
    """Overlay a loaded state_dict onto a fresh one (strict=False load)."""
    return {**fresh, **loaded}


def load_state(model: nn.Module, state: dict, keep_fresh: bool = False) -> nn.Module:
    """Load a checkpoint's state_dict into `model`: every key, exactly
    (interop.load_state_exactly); with keep_fresh, the decoders' keys keep
    the model's values."""
    if keep_fresh:
        current = model.state_dict()
        kept = strip_decoders(current)
        state = merge_variables({k: v for k, v in current.items() if k not in kept},
                                state)
    return load_state_exactly(model, state)


############################ sharding ############################


def data_mesh(batch_size: int | None = None):
    """The process group a data-parallel train step runs over: the default
    group when one is active, else None (one device). The JAX function
    takes the most devices that divide batch_size; the port runs one
    process a device and leaves none idle, so batch_size must divide the
    group's size (ValueError otherwise)."""
    if not dist.is_initialized():
        return None
    group = dist.group.WORLD
    d = dist.get_world_size(group)
    if batch_size is not None and batch_size % d:
        raise ValueError(f"global batch {batch_size} must divide the {d} ranks")
    return group


def _map_batch(fn, batch):
    """fn applied to every array or tensor of a batch (an array, or a
    tuple, list or dict of them)."""
    if isinstance(batch, dict):
        return {k: _map_batch(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_batch(fn, v) for v in batch)
    return fn(batch)


def shard_batch_global(mesh, batch, global_batch_size: int):
    """This rank's rows of a global batch that every rank of `mesh` (a
    process group) holds, from identically seeded loaders: its
    `process_local_batch_slice`, of every array or tensor of the batch."""
    sl = process_local_batch_slice(global_batch_size, mesh)
    return _map_batch(lambda a: a[sl], batch)


def shard_batch(mesh, batch):
    """This rank's rows of `batch` (held whole by every rank of `mesh`):
    the rank's equal slice of the leading axis. The JAX function places a
    host batch's shards on the mesh's devices; in the port each rank is a
    process that keeps its own."""
    first = batch
    while isinstance(first, (dict, tuple, list)):
        first = next(iter(first.values())) if isinstance(first, dict) else first[0]
    return shard_batch_global(mesh, batch, len(first))


def replicate(mesh, tree):
    """Every tensor of `tree` (a module's state, or a dict, list or tuple of
    tensors) made rank 0's on every rank of `mesh`, in place; returns
    `tree`. Without a group, `tree` as it is."""
    if mesh is None:
        return tree
    tensors = (list(tree.state_dict().values()) if isinstance(tree, nn.Module)
               else [])
    if not tensors:
        _map_tensors(tensors.append, tree)
    src = dist.get_global_rank(mesh, 0)
    for t in tensors:
        dist.broadcast(t, src=src, group=mesh)
    return tree


############################ training loop ############################


def _to_device(batch, device: torch.device):
    """numpy batch (an array, or a tuple or dict of them) -> tensors on
    `device`; to a card through pinned memory, without a host
    synchronisation."""
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(_to_device(v, device) for v in batch)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def train(
    model_type: str,
    backbone: str,
    scene: str,
    epochs: int | None = None,
    batch_size: int | None = None,
    ckpt_path: str | None = None,
    dataset_dir: str | None = None,
    output_root: str = "output",
    input_root: str = "input",
    loss_override: str | None = None,
    seed: int = 0,
    log_meshes: bool = True,
    profile: bool = False,
    device="cuda",
    on_epoch: Callable[[dict], None] | None = None,
    data_parallel: bool = True,
    multihost: bool = False,
):
    """Train a vision model (reference train.py:166-206).

    Expects input/{dataset_dir}/{train,val}/*.npz; writes TensorBoard logs
    and checkpoints under output/{dataset_dir}/{Model}_{Backbone}/version_N
    (a new N, or the N of `ckpt_path`). A checkpoint every cfg.ckpt_every
    epochs and at the last; validation every epoch; the train loss and the
    loss's sub-logs to TensorBoard every cfg.val_every steps. `ckpt_path`
    (a step_N directory) resumes: weights, running statistics, Adam's state
    and epoch + 1; the loaders start afresh from `seed`, as the JAX
    package's do. `profile` writes a trace of steps 2-5 to
    run_dir/profile/trace.json, which holds the program's spans
    (utils/profiling.py) beside the host's and the device's activity.
    `on_epoch`, if given, gets each epoch's numbers (losses, seconds,
    steps, clouds/s, host seconds waiting for the loader and in the
    checkpoint snapshot). Returns (final train loss, checkpoint dir).

    Batches come from the native loader when cfg.use_native_loader is set
    and the dataset has no host transforms (a library that does not build
    raises), else from the threaded BatchLoader.

    Data parallelism (data_parallel, multihost): under an active process
    group (parallel.initialize(); `train_torch.py --multihost` joins one
    first) the process is one rank of a data-parallel run over the group,
    one device a rank, on one host or several. multihost=True asks for
    that group and raises without one; data_parallel=True takes the group
    when there is one (False trains this rank alone). batch_size is the
    global batch and must divide the ranks. Every rank builds the same
    model from `seed` (rank 0's state broadcast to make sure), loads the
    same global batches from identically seeded loaders and keeps its
    `process_local_batch_slice` (`shard_batch_global`); the train step
    takes the global batch's BatchNorm statistics and loss and averages the
    gradients (`make_train_step(group=)`). Validation runs each whole val
    batch on every rank. Only rank 0 writes TensorBoard logs, traces and
    checkpoints; every rank resumes from `ckpt_path`.
    """
    device = resolve_device(device)
    epochs = epochs or cfg.vision_epochs
    batch_size = batch_size or cfg.vision_batch_size
    if multihost and not dist.is_initialized():
        raise RuntimeError("train(multihost=True) needs a process group: call "
                           "pointcloud_tpu_torch.parallel.initialize() first")
    group = data_mesh(batch_size) if (data_parallel or multihost) else None
    is_main = group is None or dist.get_rank(group) == 0

    spec = create_model(model_type, backbone, scene, loss_override=loss_override,
                        device=device, seed=seed)
    dataset_dir = dataset_dir or scene
    input_dir = os.path.join(input_root, dataset_dir)
    output_dir = os.path.join(output_root, dataset_dir, f"{model_type}_{backbone}")

    # version_N management (train.py:176-182)
    if ckpt_path:
        m = re.search(r"version_(\d+)", ckpt_path)
        version = int(m.group(1)) if m else 0
        print("detected version number from ckpt path:", version)
    else:
        existing = []
        if os.path.isdir(output_dir):
            existing = [
                int(d[8:])
                for d in os.listdir(output_dir)
                if d.startswith("version_") and d[8:].isdigit()
            ]
        version = max(existing) + 1 if existing else 0
    run_dir = os.path.join(output_dir, f"version_{version}")
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if group is not None:  # every rank has chosen the version before rank 0 makes it
        dist.barrier(group, device_ids=None if device.type != "cuda" else [
            torch.cuda.current_device() if device.index is None else device.index])
    if is_main:
        os.makedirs(ckpt_dir, exist_ok=True)

    train_ds = spec.open_dataset(os.path.join(input_dir, "train"))
    val_ds = spec.open_dataset(os.path.join(input_dir, "val"))

    def make_loader(ds, split_dir, shuffle, drop_last):
        if (
            cfg.use_native_loader
            and isinstance(ds, PointCloudDataset)
            and ds.in_transform is None
            and ds.out_transform is None
        ):
            from pointcloud_tpu_torch.data.native_loader import NativeCloudPairLoader

            return NativeCloudPairLoader(
                split_dir,
                in_features=ds.in_features,
                out_features=ds.out_features,
                batch_size=batch_size,
                shuffle=shuffle,
                seed=seed,
                threads=cfg.loader_threads,
                prefetch=cfg.prefetch_batches,
                drop_last=drop_last,
            )
        return BatchLoader(
            ds, batch_size, shuffle=shuffle, seed=seed,
            threads=cfg.loader_threads, prefetch=cfg.prefetch_batches,
            drop_last=drop_last,
        )

    train_loader = make_loader(
        train_ds, os.path.join(input_dir, "train"), True, True
    )
    val_loader = make_loader(val_ds, os.path.join(input_dir, "val"), False, False)

    optimizer = make_optimizer(spec)
    start_epoch = 0
    if ckpt_path:
        payload = load_checkpoint_raw(ckpt_path)
        load_state(spec.model, payload["model"])
        optimizer.load_state_dict(payload["optimizer"])
        start_epoch = int(payload["epoch"]) + 1
        print(f"resumed from {ckpt_path} at epoch {start_epoch}")
    replicate(group, spec.model)

    train_step = make_train_step(spec, optimizer, group)
    eval_step = make_eval_step(spec)
    if group is None:
        put_batch = lambda b: b  # noqa: E731
    else:
        put_batch = lambda b: shard_batch_global(group, b, batch_size)  # noqa: E731
    profile = profile and is_main

    writer = _make_writer(run_dir) if is_main else _NullWriter()
    global_step = start_epoch * max(len(train_loader), 1)
    loss = torch.tensor(float("nan"))  # defined even if no step runs
    train_loss = float("nan")

    profile_ctx = None

    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        wait_s = 0.0
        batches = iter(train_loader)
        while True:
            t1 = time.perf_counter()
            batch = next(batches, None)
            wait_s += time.perf_counter() - t1
            if batch is None:
                break
            if profile and global_step == 2:  # skip the first steps
                profile_ctx = trace(os.path.join(run_dir, "profile"))
                profile_ctx.__enter__()
            x_raw, y_raw = _to_device(put_batch(batch), device)
            loss, logs = train_step(x_raw, y_raw)
            if profile_ctx is not None and global_step == 5:
                profile_ctx.__exit__(None, None, None)
                profile_ctx = None
                print(f"profile trace written to {run_dir}/profile")
            global_step += 1
            # scalar logging every val_every steps (the reference's
            # log_every_n_steps cadence, train.py:198)
            if global_step % cfg.val_every == 0:
                writer.add_scalar("train_loss", _host_float(loss), global_step)
                for k, v in logs.items():
                    writer.add_scalar(k, _host_float(v), global_step)
        train_loss = _host_float(loss)  # waits for the epoch's last step
        dt = time.perf_counter() - t0

        # validation every epoch (Lightning default in the reference)
        t1 = time.perf_counter()
        val_losses = []
        for bi, (x_raw, y_raw) in enumerate(val_loader):
            x, y = _to_device((x_raw, y_raw), device)
            vloss, vlogs, out = eval_step(x, y)
            val_losses.append(_host_float(vloss))
            if bi == 0 and log_meshes and spec.model_type == "Autoencoder":
                _log_mesh(writer, out, y, global_step)
        val_loss = float(np.mean(val_losses)) if val_losses else float("nan")
        if val_losses:
            writer.add_scalar("val_loss", val_loss, global_step)
        val_s = time.perf_counter() - t1
        n_steps = max(len(train_loader), 1)
        print(
            f"{'' if group is None else f'rank {dist.get_rank(group)}: '}"
            f"epoch {epoch}: train_loss={train_loss:.6f} "
            f"val_loss={val_loss:.6f} "
            f"({dt:.1f}s, {dt / n_steps * 1e3:.1f} ms/step wall, "
            f"{n_steps * batch_size / dt:,.0f} clouds/s)"
        )

        # checkpoint: snapshot on the device, copy + write in the background;
        # every cfg.ckpt_every epochs and the final one
        t1 = time.perf_counter()
        saved = is_main and (epoch % cfg.ckpt_every == 0 or epoch == epochs - 1)
        if saved:
            save_checkpoint_async(ckpt_dir, epoch, checkpoint_payload(
                spec, optimizer, epoch, loss_override))
        ckpt_s = time.perf_counter() - t1
        if on_epoch is not None:
            on_epoch({"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
                      "steps": len(train_loader), "seconds": dt,
                      "clouds_per_s": len(train_loader) * batch_size / dt,
                      "loader_wait_s": wait_s, "val_seconds": val_s,
                      "checkpoint": saved, "checkpoint_s": ckpt_s,
                      "global_step": global_step})

    if profile_ctx is not None:  # the run ended before step 5
        profile_ctx.__exit__(None, None, None)
        print(f"profile trace written to {run_dir}/profile")
    wait_for_checkpoints()
    writer.close()
    return train_loss, ckpt_dir


def _host_float(t) -> float:
    """float(t): the host waits for the device (counted as `host_sync`)."""
    count("host_sync")
    return float(t)


class _NullWriter:
    """Stands in for SummaryWriter where TensorBoard is not installed."""

    def add_scalar(self, *a, **k):
        pass

    def add_mesh(self, *a, **k):
        pass

    def close(self):
        pass


def _make_writer(run_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return _NullWriter()
    return SummaryWriter(run_dir)


def _log_mesh(writer, prediction, target, step):
    """Predicted vs GT sample cloud to TensorBoard (train.py:43-53)."""
    pred = prediction[0].detach().float().cpu()
    gt = target[0].detach().float().cpu()
    pc = torch.stack([pred[:, :3], gt[:, :3]])
    col = torch.stack([pred[:, 3:6], gt[:, 3:6]]).clamp(0, 1) * 255
    writer.add_mesh("Point Cloud", vertices=pc, colors=col, global_step=step)
