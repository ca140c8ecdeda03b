"""fps_device_ms.observe (ms): the device time of the `fps` kernels (the
sensor's 196,608 -> 2,048 and the encoder's two SA levels) per observation
in the traced window."""

from portbench import core
from portbench.counts import kernels


def read(run):
    s = core.kernel_seconds(run, kernels.FPS)
    n = getattr(run, "observations", 0)
    return 1e3 * s / n if s > 0 and n else None
