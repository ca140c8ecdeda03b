"""encode_wait_ms.observe (ms): the host ms of the program's `encode.d2h`
an observation (the host waits for the encoder, then copies the latent
back), over the traced window's observations."""

from portbench import program_spans


def read(run):
    return program_spans.mean_host_ms("encode.observe", getattr(run, "observations", 0),
                                      ("encode.d2h",))
