"""Model output -> displayable coloured clouds (port of
pointcloud_tpu/viewers/reconstruct.py; reference: ae_viewer.py:14-220
per-model-type pred/target assembly).

assemble_prediction(model_type, ...) returns (pred_xyz, pred_rgb, gt_xyz,
gt_rgb) numpy arrays for any of the four model types:
  Autoencoder    — xyz + RGB channels as-is
  Segmenter      — argmax the class logits (IntegerEncode) -> class colors
  MultiSegmenter — per-class decoders concatenated with their labels
                   (reconstruct_labeled) -> class colors
  StatePredictor — axis-aligned line markers (aa_lines) at the predicted and
                   GT positions
The model runs on its own device (the card by default), in eval mode; the
results come back to the host as fp32 numpy. Nothing here plots.
"""

from __future__ import annotations

import numpy as np
import torch


def aa_lines(pos, color, length: float = 0.3, n: int = 50):
    """Axis-aligned cross marker through `pos` (reference ae_viewer aa_lines):
    3 orthogonal segments of points centered at pos. Returns (3n, 3), (3n, 3)."""
    pos = np.asarray(pos, dtype=np.float32).reshape(3)
    t = np.linspace(-length / 2, length / 2, n, dtype=np.float32)
    pts = []
    for axis in range(3):
        seg = np.tile(pos, (n, 1))
        seg[:, axis] += t
        pts.append(seg)
    pts = np.concatenate(pts)
    cols = np.tile(np.asarray(color, np.float32), (len(pts), 1))
    return pts, cols


def load_viewer_model(scene: str, model_type: str, backbone: str, version=None,
                      output_root=None, device="cuda"):
    """The FULL model (decoders included) of the latest checkpoint (or the
    given version's) for viewing, on `device`, unlike pc_encoder.load_model,
    which keeps the decoders' fresh init. Returns (spec, variables): the
    spec's model holds the weights, `variables` is the state_dict it was
    given (a fresh init overlaid by the checkpoint's keys, as the JAX
    function's merge). A JAX checkpoint raises and names
    convert_checkpoint_torch.py."""
    from pointcloud_tpu_torch.train.harness import (
        create_model,
        load_checkpoint_variables,
        load_state,
        merge_variables,
    )
    from pointcloud_tpu_torch.vision.pc_encoder import _check_port_checkpoint, model_path

    ckpt = model_path(scene, model_type, backbone, version, output_root)
    _check_port_checkpoint(ckpt)
    spec = create_model(model_type, backbone, scene, device=device)
    loaded = load_checkpoint_variables(ckpt, encoder_only=False)["model"]
    variables = merge_variables(spec.model.state_dict(), loaded)
    load_state(spec.model, variables)
    return spec, variables


def _host(t):
    return t.detach().float().cpu().numpy()


def assemble_prediction(
    model_type: str,
    spec,
    variables,
    in_pc: np.ndarray,
    target,
    class_colors=None,
):
    """Run the model on one input cloud and build displayable pred/GT clouds.

    in_pc: (N, D) normalized input cloud; target: the dataset target (cloud
    or state dict). `variables`: None (the model's own weights, as
    load_viewer_model leaves them), or a state_dict loaded into spec.model
    first. Returns (pred_xyz, pred_rgb, gt_xyz, gt_rgb).
    """
    if variables is not None:
        from pointcloud_tpu_torch.train.harness import load_state

        load_state(spec.model, variables)
    model = spec.model.eval()
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(in_pc, np.float32), device=device)[None]
    colors = (
        np.asarray(class_colors, np.float32) if class_colors is not None else None
    )

    with torch.inference_mode():
        if model_type == "Autoencoder":
            out = _host(model(x, train=False))[0]
            return out[:, :3], np.clip(out[:, 3:6], 0, 1), target[:, :3], np.clip(
                target[:, 3:6], 0, 1
            )

        if model_type == "Segmenter":
            out = _host(model(x, train=False))[0]
            pred_labels = np.argmax(out[:, 3:], axis=1)
            gt_labels = np.asarray(target[:, 3], dtype=int)
            return (
                out[:, :3],
                colors[pred_labels],
                np.asarray(target[:, :3]),
                colors[gt_labels],
            )

        if model_type == "MultiSegmenter":
            labeled = _host(model.reconstruct_labeled(x, train=False))[0]
            pred_labels = labeled[:, 3].astype(int)
            gt_labels = np.asarray(target[:, 3], dtype=int)
            return (
                labeled[:, :3],
                colors[pred_labels],
                np.asarray(target[:, :3]),
                colors[gt_labels],
            )

        if model_type == "StatePredictor":
            out = model(x, train=False)
            pred_pts, pred_cols, gt_pts, gt_cols = [], [], [], []
            palette = [[1, 0, 0], [0, 0, 1], [1, 0.6, 0], [0.5, 0, 0.5]]
            for i, (name, value) in enumerate(out.items()):
                v = _host(value)[0]
                if v.shape[-1] != 3:
                    continue
                p, c = aa_lines(v, palette[i % len(palette)])
                pred_pts.append(p)
                pred_cols.append(c)
                if name in target:
                    g, gc = aa_lines(np.asarray(target[name]), [0, 1, 0])
                    gt_pts.append(g)
                    gt_cols.append(gc)

            def cat(xs):
                return np.concatenate(xs) if xs else np.zeros((0, 3), np.float32)

            return cat(pred_pts), cat(pred_cols), cat(gt_pts), cat(gt_cols)

    raise NotImplementedError(model_type)


def lerp_clouds(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """Linear morph between two same-size clouds (ae_viewer lerp animation)."""
    return (1 - t) * a + t * b
