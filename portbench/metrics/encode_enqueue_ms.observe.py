"""encode_enqueue_ms.observe (ms): the host ms of the program's
`encode.forward` an observation (the enqueue of `model.encode` at B=1),
over the traced window's observations."""

from portbench import program_spans


def read(run):
    return program_spans.mean_host_ms("encode.observe", getattr(run, "observations", 0),
                                      ("encode.forward",))
