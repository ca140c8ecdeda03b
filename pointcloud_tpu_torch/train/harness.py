"""Model wiring, the train step and the eval step (port of
pointcloud_tpu/train/harness.py:57-126 and :336-386).

`create_model` builds the model + loss + transforms of one configuration on
one device; `make_optimizer` and `make_train_step` give the training step
(forward in train mode, loss, backward, Adam); `make_eval_step` returns the
eval forward + loss. Only the Autoencoder / PointNet / Chamfer configuration
is ported so far; the other model types, the EMD loss, datasets, the train()
loop and checkpoints come in later slices and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from pointcloud_tpu_torch import cfg
from pointcloud_tpu_torch.envs.scenes import scene_config
from pointcloud_tpu_torch.losses import ChamferDistance, _noop_log
from pointcloud_tpu_torch.models.architectures import AE, backbone_factory
from pointcloud_tpu_torch.models.layers import init_flax_
from pointcloud_tpu_torch.transforms import Normalize


@dataclasses.dataclass
class TrainSpec:
    """Everything a step needs for one model configuration."""

    model: nn.Module  # on its device; steps pass train= explicitly
    loss: Any  # loss object (callable, with .log hook)
    in_transform: Any  # (pc, mask) -> (pc, mask) for input clouds
    out_transform: Any  # the same for target clouds
    model_type: str
    backbone: str
    scene_name: str
    scene: Any  # SimpleNamespace scene config


def create_model(
    model_type: str,
    backbone: str,
    scene: str,
    loss_override: str | None = None,
    device="cuda",
    seed: int = 0,
) -> TrainSpec:
    """Build the TrainSpec of one configuration with fresh weights.

    The weights follow flax's init (lecun_normal kernels, zero biases,
    BatchNorm ones/zeros, zero STN head), drawn on the CPU from a
    torch.Generator seeded with `seed`, so every device gets the same
    numbers; interop.load_flax_variables(spec.model, ...) replaces them with
    the JAX package's. Activations are bf16 on a CUDA device under
    cfg.precision == 'bf16-mixed' and fp32 on the CPU.
    """
    if model_type != "Autoencoder":
        raise NotImplementedError(
            f"model type {model_type!r} is not ported yet (Autoencoder only)"
        )
    if backbone not in backbone_factory:
        raise NotImplementedError(
            f"backbone {backbone!r} is not ported yet "
            f"(have {sorted(backbone_factory)})"
        )
    if loss_override != "chamfer":
        raise NotImplementedError(
            "the Autoencoder's EMD loss is not ported yet: pass "
            "loss_override='chamfer'"
        )
    device = torch.device(device)
    sc = scene_config(scene)
    dtype = cfg.compute_dtype(device)
    model = AE(
        backbone_factory[backbone](feature_dims=3, dtype=dtype),
        out_points=sc.sample_points,
        out_dim=6,
        bottleneck=sum(sc.class_latent_dim),
        dtype=dtype,
    )
    init_flax_(model, torch.Generator().manual_seed(seed))
    return TrainSpec(
        model=model.to(device).eval(),
        loss=ChamferDistance(),
        in_transform=Normalize(sc.bbox),
        out_transform=Normalize(sc.bbox),
        model_type=model_type,
        backbone=backbone,
        scene_name=scene,
        scene=sc,
    )


def make_optimizer(spec: TrainSpec) -> torch.optim.Optimizer:
    """Adam over the model's parameters, as optax.adam(cfg.vision_lr): betas
    (0.9, 0.999), eps 1e-8 added outside the square root, bias-corrected."""
    return torch.optim.Adam(spec.model.parameters(), lr=cfg.vision_lr,
                            betas=(0.9, 0.999), eps=1e-8)


def make_train_step(spec: TrainSpec, optimizer: torch.optim.Optimizer):
    """step(x_raw, y_raw) -> (loss, logs): the transforms, the forward in
    train mode (BatchNorm batch statistics; the running statistics are
    updated), the loss with its `.log` hook, the backward and the optimizer
    step. Parameters, running statistics and optimizer state are updated in
    place, PyTorch's counterpart of the JAX step's donated buffers."""

    def step(x_raw, y_raw):
        x, _ = spec.in_transform(x_raw)
        y, _ = spec.out_transform(y_raw)
        logs = {}
        spec.loss.log = lambda k, v: logs.__setitem__(k, v)
        out = spec.model(x, train=True)
        loss = spec.loss(out, y)
        spec.loss.log = _noop_log
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), logs

    return step


def zero_gradient_bias(name: str) -> bool:
    """True for the state_dict name of a Dense bias that feeds a train-mode
    BatchNorm (the PointwiseMLP and STN Dense_0/Dense_1 biases, every
    DenseBNMaxPool bias): the batch mean removes it, so its true gradient is
    exactly 0 and a computed one is round-off. Checks of gradients and of
    Adam's steps treat these apart."""
    return name.endswith("bias") and (
        ("PointwiseMLP" in name or name.startswith("encoder.backbone.mlp"))
        and ".Dense_" in name
        or ("DenseBNMaxPool" in name or "dbnpool" in name)
        or (".stn." in name or ".fstn." in name)
        and name.split(".")[-2] in ("Dense_0", "Dense_1"))


def make_eval_step(spec: TrainSpec):
    """step(x_raw, y_raw) -> (loss, logs, out): the eval-mode forward and
    loss, without autograd. `out` doubles as the sample prediction."""

    def step(x_raw, y_raw):
        with torch.inference_mode():
            x, _ = spec.in_transform(x_raw)
            y, _ = spec.out_transform(y_raw)
            logs = {}
            spec.loss.log = lambda k, v: logs.__setitem__(k, v)
            out = spec.model(x, train=False)
            loss = spec.loss(out, y)
            spec.loss.log = _noop_log
        return loss, logs, out

    return step
