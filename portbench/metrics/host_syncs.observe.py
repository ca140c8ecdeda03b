"""host_syncs.observe (count): the program's `host_sync` counts (its
explicit host waits on the card) under `sensor.observe` and
`encode.observe`, an observation, over the traced window's observations."""

from portbench import program_spans


def read(run):
    return program_spans.mean_count(("sensor.observe", "encode.observe"),
                                    getattr(run, "observations", 0), "host_sync")
