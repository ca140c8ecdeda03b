"""loss_device_ms.train (ms a step): the device time of the loss's kernels
per train step in the traced window: `nn_sweep` and `chamfer_bwd` under
Chamfer, Sinkhorn's sweeps and assignment under EMD."""

from portbench import core
from portbench.counts import kernels


def read(run):
    kind = run.config["loss"]["kind"]
    pattern = kernels.CHAMFER if kind == "chamfer" else kernels.SINKHORN
    s = core.kernel_seconds(run, pattern)
    return 1e3 * s / run.steps if s > 0 and run.steps else None
