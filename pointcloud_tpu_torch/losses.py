"""Point-cloud losses (port of pointcloud_tpu/losses.py).

The same loss-object surface as the JAX package (ChamferDistance,
FilteringChamferDistance, SegmentingChamferDistance, EarthMoverDistance,
StatePredictionLoss), including the injected `loss.log` hook through which
sub-losses reach the trainer's logs. Ragged per-class filtering uses masks.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F

from pointcloud_tpu_torch import cfg
from pointcloud_tpu_torch.ops.chamfer import chamfer_distance
from pointcloud_tpu_torch.ops.emd import emd_match
from pointcloud_tpu_torch.parallel.distributed import batch_group, batch_sum


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


class FilteringChamferDistance(LossBase):
    """Chamfer of pred against each target cloud's xyz under a filter:
    `filter_fn` is a transform `(pc, mask) -> (pc, mask)` over the batch of
    targets, and its mask (and `target_mask`, if given) selects the
    targets' points."""

    def __init__(self, filter_fn: Callable):
        super().__init__()
        self.filter_fn = filter_fn

    def __call__(self, pred, target, pred_mask=None, target_mask=None):
        _, fmask = self.filter_fn(target, None)
        if target_mask is not None:
            fmask = fmask & target_mask
        return chamfer_distance(pred, target[..., :3].contiguous(), x_mask=pred_mask,
                                y_mask=fmask.contiguous())


class SegmentingChamferDistance(LossBase):
    """Per-class filtering Chamfer, summed over the classes.

    pred: {class_name: (B, N_c, 3)} from MultiSegAE's per-class decoders;
    target: one labelled cloud (B, N, 4+) with the integer class label as a
    float in column 3. The value is the sum over classes of each class's
    batch-mean Chamfer of its prediction against the target's points of
    that class, computed as ONE masked sweep: the per-class predictions are
    padded to the longest, Nmax, and stacked to (C*B, Nmax, 3) with masks
    of their real rows; the target's xyz is broadcast to (C*B, N, 3) with
    one label mask per class; one chamfer_distance(batch_reduction=None)
    takes it (one `nn_sweep` launch forward, one `chamfer_bwd` backward on
    the card).

    The padding stops at Nmax: the JAX package rounds Nmax up to a multiple
    of 64 (losses.py:95-98) for its TPU sweep's row tiles, which `nn_sweep`
    does not need (it masks ragged tiles itself). Padded rows are masked,
    so the value is the same.

    A class absent from a target cloud leaves all of that row's targets
    masked: each of its valid predicted points then has distance 1e10 to
    target 0, so the class adds ~1e10 to the loss and its gradient goes
    through target 0, exactly as in the JAX package.
    """

    def __init__(self, class_labels: Mapping[str, int]):
        super().__init__()
        self.class_labels = dict(class_labels)

    def __call__(self, pred: Mapping[str, torch.Tensor], target, target_mask=None):
        names = list(self.class_labels)
        C = len(names)
        B, N = target.shape[:2]
        n_max = max(pred[c].shape[1] for c in names)
        ids = torch.arange(n_max, device=target.device)
        preds, pmasks = [], []
        for c in names:
            p = pred[c][..., :3]
            n_c = p.shape[1]
            preds.append(F.pad(p, (0, 0, 0, n_max - n_c)))
            pmasks.append((ids < n_c).expand(B, n_max))
        px = torch.cat(preds, dim=0)  # (C*B, Nmax, 3)
        pm = torch.cat(pmasks, dim=0)  # (C*B, Nmax)

        labels = target[..., 3].to(torch.int32)  # (B, N)
        tms = []
        for c in names:
            m = labels == self.class_labels[c]
            if target_mask is not None:
                m = m & target_mask
            tms.append(m)
        tm = torch.cat(tms, dim=0)  # (C*B, N)
        # the kernel takes contiguous clouds (with one class the reshape is
        # a strided view of the target's xyz)
        ty = target[None, :, :, :3].expand(C, B, N, 3).reshape(C * B, N, 3).contiguous()

        per = chamfer_distance(px, ty, x_mask=pm, y_mask=tm,
                               batch_reduction=None).reshape(C, B)
        # the sum over classes of each class's batch mean
        return per.mean(dim=1).sum()


def _class_shares(classes, num_classes: int):
    """The share of each class among integer labels in [0, num_classes): a
    one-hot sum of fixed length. (`torch.bincount` sizes its output from the
    data's maximum, which makes the host wait for the device.) Inside
    `sharded_batch` the counts are the global batch's."""
    ids = torch.arange(num_classes, device=classes.device)
    counts = batch_sum((classes.reshape(-1, 1) == ids).sum(dim=0).float())
    return counts / counts.sum()


def _batch_ratios(*pairs):
    """num / den for each (num, den) of batch sums; inside `sharded_batch`
    every sum is the global batch's, all in one collective, and the
    numerators keep their gradients."""
    if batch_group() is None:
        return [num / den for num, den in pairs]
    sums = batch_sum(torch.stack([t for pair in pairs for t in pair]))
    return [sums[2 * i] / sums[2 * i + 1] for i in range(len(pairs))]


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

    Inside `sharded_batch` (data parallelism) the class shares and both
    weighted means are the global batch's, as under the JAX package's
    sharded step; the feature MSE stays this rank's mean (the train step
    averages the ranks' losses: equal slices make it the global mean).
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
            point_l, ce_l = _batch_ratios(
                ((torch.sqrt(dists + 1e-12) * weights).sum(), weights.sum()),
                ((weights * nll).sum(), weights.sum()))
            feature_l = self.feature_weight * ce_l
            self.log("train_loss/cross_entropy", ce_l)
            self.log("train_loss/kl_divergence", kl_div)
        else:
            feature_l = ((pred[:, :, 3:] - target[:, :, 3:]) ** 2).mean()
            point_l, = _batch_ratios(
                ((torch.sqrt(dists + 1e-12) * weights).sum(), weights.sum()))

        self.log("train_loss/EMD", point_l)
        self.log("train_loss/feature", feature_l)
        return point_l + feature_l


class StatePredictionLoss(LossBase):
    """The mean over `states` of each state's MSE against its target after
    that state's transform (`transforms[name]`, the identity where none is
    given). pred and target: {state_name: (B, dim)}."""

    def __init__(self, states: Sequence[str], transforms: Mapping[str, Callable]):
        super().__init__()
        self.states = list(states)
        self.t = dict(transforms)
        for s in self.states:
            if s not in self.t:
                self.t[s] = lambda x: x

    def __call__(self, pred: Mapping[str, torch.Tensor],
                 target: Mapping[str, torch.Tensor]):
        losses = [torch.mean((pred[s] - self.t[s](target[s])) ** 2)
                  for s in self.states]
        return torch.mean(torch.stack(losses))
