"""model_init_s.setup (s): the seconds of the program's
`setup.create_model` spans (the model built and its weights drawn),
summed over the process."""

from portbench import program_spans


def read(run):
    return program_spans.setup_seconds("setup.create_model")
