"""chain_device_ms.train (ms a step): the device time of the fused chain's
kernels (csrc/mlp_chain.cu: forward products, pool pass, backward passes)
over the traced window, per train step."""

from portbench import core
from portbench.counts import kernels


def read(run):
    s = core.kernel_seconds(run, kernels.MLP_CHAIN)
    return 1e3 * s / run.steps if s > 0 and run.steps else None
