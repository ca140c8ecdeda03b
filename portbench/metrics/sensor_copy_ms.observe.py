"""sensor_copy_ms.observe (ms): the host ms of the program's `sensor.pack`
(the camera cloud's concatenation into contiguous float32) and `sensor.h2d`
(its copy to the card) an observation, over the traced window's
observations."""

from portbench import program_spans


def read(run):
    return program_spans.mean_host_ms("sensor.observe", getattr(run, "observations", 0),
                                      ("sensor.pack", "sensor.h2d"))
