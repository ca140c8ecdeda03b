"""sensor_wait_ms.observe (ms): the host ms of the program's `sensor.d2h`
an observation (the host waits for FilterBBox and FPS, then copies the
sensed cloud back), over the traced window's observations."""

from portbench import program_spans


def read(run):
    return program_spans.mean_host_ms("sensor.observe", getattr(run, "observations", 0),
                                      ("sensor.d2h",))
