"""Model wiring, the train step and the eval step (port of
pointcloud_tpu/train/harness.py:57-153 and :336-386).

`create_model` builds the model + loss + transforms of one configuration on
one device; `make_optimizer` and `make_train_step` give the training step
(forward in train mode, loss, backward, Adam); `make_eval_step` returns the
eval forward + loss. Ported: the Autoencoder (Earth Mover's Distance, its
default loss, or Chamfer with loss_override="chamfer") and the Segmenter
(EMD with class weights), on the PointNet, PointNet2, PointMLP and PointMLPE
backbones, eval and train. The MultiSegmenter, the StatePredictor, datasets,
the train() loop and checkpoints come in later slices and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from pointcloud_tpu_torch import cfg
from pointcloud_tpu_torch.envs.scenes import scene_config
from pointcloud_tpu_torch.losses import (
    ChamferDistance,
    EarthMoverDistance,
    _noop_log,
)
from pointcloud_tpu_torch.models.architectures import AE, SegAE, backbone_factory
from pointcloud_tpu_torch.models.layers import BatchNorm, Dense, init_flax_
from pointcloud_tpu_torch.models.pointnet import DenseBNMaxPool
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

    loss_override='chamfer' swaps the Autoencoder's EMD loss for Chamfer; the
    Segmenter has no other loss than EMD.
    """
    if model_type in ("MultiSegmenter", "StatePredictor"):
        missing = {
            "MultiSegmenter": "MultiSegAE and SegmentingChamferDistance",
            "StatePredictor": "MultiGTEncoder and StatePredictionLoss",
        }[model_type]
        raise NotImplementedError(
            f"model type {model_type!r} is not ported yet ({missing} are "
            f"missing; Autoencoder and Segmenter are ported)"
        )
    if model_type not in ("Autoencoder", "Segmenter"):
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
    num_classes = len(sc.classes) if model_type == "Segmenter" else None
    if model_type == "Autoencoder":
        model = AE(
            encoder_backbone,
            out_points=sc.sample_points,
            out_dim=6,
            bottleneck=sum(sc.class_latent_dim),
            dtype=dtype,
        )
    else:  # the target is (B, N, 4): xyz + the class label as a float
        model = SegAE(
            encoder_backbone,
            num_classes=num_classes,
            out_points=sc.sample_points,
            bottleneck=sum(sc.class_latent_dim),
            dtype=dtype,
        )
    if model_type == "Autoencoder" and loss_override == "chamfer":
        loss = ChamferDistance()
    else:
        loss = EarthMoverDistance(
            eps=cfg.emd_eps, its=cfg.emd_iterations, num_classes=num_classes,
            anneal_from=None,  # the constant-eps training operating point
        )
    init_flax_(model, torch.Generator().manual_seed(seed))
    return TrainSpec(
        model=model.to(device).eval(),
        loss=loss,
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


def zero_gradient_biases(model: nn.Module) -> set[str]:
    """The state_dict names of the Dense biases that feed a train-mode
    BatchNorm: the bias of a Dense registered just before a BatchNorm in
    the same module, and every DenseBNMaxPool's bias. The batch mean removes
    such a bias, so its true gradient is exactly 0 and a computed one is
    round-off. Checks of gradients and of Adam's steps treat these apart."""
    names = set()
    for prefix, mod in model.named_modules():
        at = prefix + "." if prefix else ""
        if isinstance(mod, DenseBNMaxPool):
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
