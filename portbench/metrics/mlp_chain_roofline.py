"""mlp_chain_roofline (%): the least time of a train step's fused chains at
every SA level (portbench.counts.chain_train_bound_ms: each product and pass
at the dense bf16 rate or the HBM rate, whichever binds) over their device
time per step in the traced window."""

from portbench import core, counts
from portbench.counts import kernels


def read(run):
    s = core.kernel_seconds(run, kernels.MLP_CHAIN)
    if s <= 0 or not run.steps:
        return None
    bound_ms = counts.chain_train_bound_ms(run.config, run.traffic["batch"])
    return 100.0 * bound_ms / (1e3 * s / run.steps)
