"""mfu.train (%): the model FLOPs of the window's train steps (the forward
products counted from the configuration's widths, x3 for the backward) over
the traced window's time, as a share of one H100's dense bf16 peak."""

from portbench import counts


def read(run):
    if not run.steps:
        return None
    flops = 3 * counts.forward_flops(run.config) * run.clouds
    return 100.0 * flops / run.window_s / counts.PEAK_BF16_FLOPS
