"""encoder_device_ms.eval (ms): the device ms of the program's SA-level
spans (`encoder.SetAbstraction_<i>`, CUDA event pairs) a step, over the
traced window's eval steps."""

from portbench import program_spans


def read(run):
    return program_spans.mean_device_ms("step.eval", getattr(run, "steps", 0),
                                        "encoder.SetAbstraction")
