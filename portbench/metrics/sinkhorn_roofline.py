"""sinkhorn_roofline (%): the least time of one train step's Sinkhorn
matching (portbench.counts.sinkhorn_bound: one ex2 a pair a sweep on the
special-function units, or the fp32 work, or the bytes) over its kernels'
device time per step in the traced window."""

from portbench import core, counts
from portbench.counts import kernels


def read(run):
    if run.config["loss"]["kind"] != "emd":
        return None
    s = core.kernel_seconds(run, kernels.SINKHORN)
    if s <= 0 or not run.steps:
        return None
    n = run.config["points"]
    bound_ms = counts.sinkhorn_bound(run.traffic["batch"], n, n,
                                     run.config["loss"]["iterations"])[0]
    return 100.0 * bound_ms / (1e3 * s / run.steps)
