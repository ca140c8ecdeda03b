"""Point-cloud losses (port of pointcloud_tpu/losses.py:29-45 and :132-235).

The same loss-object surface as the JAX package, including the injected
`loss.log` hook through which sub-losses reach the trainer's logs.
"""

from __future__ import annotations

import torch

from pointcloud_tpu_torch import cfg
from pointcloud_tpu_torch.ops.chamfer import chamfer_distance
from pointcloud_tpu_torch.ops.emd import emd_match


def _noop_log(name, value):
    return None


class LossBase:
    """Common bits: a `log` attribute the trainer may override to capture
    sub-losses."""

    def __init__(self):
        self.log = _noop_log


class ChamferDistance(LossBase):
    """Bidirectional chamfer over ALL C dims of the clouds (the AE's eval
    loss runs at C=6: xyz + rgb)."""

    def __call__(self, pred, target, pred_mask=None, target_mask=None):
        return chamfer_distance(pred, target, x_mask=pred_mask, y_mask=target_mask)


def _class_shares(classes, num_classes: int):
    """The share of each class among integer labels in [0, num_classes): a
    one-hot sum of fixed length. (`torch.bincount` sizes its output from the
    data's maximum, which makes the host wait for the device.)"""
    ids = torch.arange(num_classes, device=classes.device)
    counts = (classes.reshape(-1, 1) == ids).sum(dim=0).float()
    return counts / counts.sum()


class EarthMoverDistance(LossBase):
    """EMD point loss + matched feature loss.

    Matching runs on xyz only; the target is then permuted by the assignment
    so matched points align index-wise. The feature loss is the MSE on the
    remaining dims, or, with `num_classes`, weighted by inverse batch
    frequency:
      point_l   = sum(sqrt(d) * w) / sum(w),  w = class_weights[target_class]
      feature_l = feature_weight * weighted cross-entropy(pred logits,
                  target class)
    (the KL divergence between the predicted and the target class
    distributions is logged and not added to the loss). With classes the
    target carries the label in column 3 as a float.
    """

    def __init__(
        self,
        eps: float = cfg.emd_eval_eps,
        its: int = cfg.emd_eval_iterations,
        num_classes: int | None = None,
        feature_weight: float = 0.1,
        method: str | None = None,
        anneal_from: float | None = cfg.emd_anneal_from,
    ):
        """The defaults are the annealed-Sinkhorn eval operating point (eps
        0.002, 60 iterations annealed from 0.1). Training passes
        (cfg.emd_eps, cfg.emd_iterations, anneal_from=None): train/harness.py."""
        super().__init__()
        self.eps = eps
        self.iterations = its
        self.C = num_classes
        self.feature_weight = feature_weight
        self.method = method or cfg.emd_method
        self.anneal_from = anneal_from

    def __call__(self, pred, target):
        if cfg.debug:
            # EMD's precondition: coordinates normalised to the unit cube
            for name, pc in (("pred", pred), ("target", target)):
                xyz = pc[:, :, :3]
                bad = bool(xyz.min() < -1e-3) or bool(xyz.max() > 1 + 1e-3)
                print(f"DEBUG: EMD {name} coords outside [0,1]: {bad}")
        dists, assignment = emd_match(
            pred[:, :, :3], target[:, :, :3], self.eps, self.iterations,
            self.method, self.anneal_from,
        )
        # permute the target so that matched points share an index
        target = torch.gather(
            target, 1, assignment.long()[..., None].expand(-1, -1, target.shape[2]))

        if cfg.debug:
            num_points = pred.shape[1]
            hit = torch.zeros(pred.shape[:2], dtype=torch.bool, device=pred.device)
            hit.scatter_(1, assignment.long(), True)
            missing = num_points - hit.sum(dim=1).float()
            print(f"DEBUG: EMD unassigned ratio per batch = "
                  f"{(missing / num_points).tolist()}")

        weights = torch.ones_like(dists)  # (B, N)
        if self.C is not None:
            target_classes = target[:, :, 3].long()  # (B, N)
            distribution = _class_shares(target_classes, self.C)
            pred_logits = pred[:, :, 3:]  # (B, N, C)
            pred_distribution = _class_shares(pred_logits.argmax(dim=2), self.C)

            # logged only: the batch-mean KL of log_softmax(pred distribution)
            # against softmax(target distribution)
            sd = torch.softmax(distribution, dim=0)
            lp = torch.log_softmax(pred_distribution, dim=0)
            kl_div = (sd * (sd.log() - lp)).sum() / self.C

            # a class absent from the batch gets 1 / 1e-4 before normalisation
            class_weights = 1.0 / (distribution + 1e-4)
            class_weights = class_weights / class_weights.sum()
            weights = class_weights[target_classes]

            # weighted cross-entropy: sum(w_y * nll) / sum(w_y)
            logp = torch.log_softmax(pred_logits, dim=-1)
            nll = -torch.gather(logp, 2, target_classes[..., None])[..., 0]
            ce_l = (weights * nll).sum() / weights.sum()
            feature_l = self.feature_weight * ce_l
            self.log("train_loss/cross_entropy", ce_l)
            self.log("train_loss/kl_divergence", kl_div)
        else:
            feature_l = ((pred[:, :, 3:] - target[:, :, 3:]) ** 2).mean()

        point_l = (torch.sqrt(dists + 1e-12) * weights).sum() / weights.sum()
        self.log("train_loss/EMD", point_l)
        self.log("train_loss/feature", feature_l)
        return point_l + feature_l
