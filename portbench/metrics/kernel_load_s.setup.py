"""kernel_load_s.setup (s): the seconds of the program's `setup.kernels`
spans (nvcc building the missing CUDA libraries, and each library's first
load), summed over the process."""

from portbench import program_spans


def read(run):
    return program_spans.setup_seconds("setup.kernels")
