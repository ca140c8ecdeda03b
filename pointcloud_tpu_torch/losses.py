"""Point-cloud losses (port of pointcloud_tpu/losses.py:29-45).

The same loss-object surface as the JAX package, including the injected
`loss.log` hook through which sub-losses reach the trainer's logs.
"""

from __future__ import annotations

from pointcloud_tpu_torch.ops.chamfer import chamfer_distance


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
