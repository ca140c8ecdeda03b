"""optimizer_device_ms.train (ms): the device ms of the program's
`step.optimizer` span (Adam's step; a CUDA event pair) a step, over the
traced window's steps."""

from portbench import program_spans


def read(run):
    return program_spans.mean_device_ms("step.train", getattr(run, "steps", 0),
                                        "step.optimizer")
