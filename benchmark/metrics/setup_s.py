"""Seconds from the process's start to the first measured call: imports,
inputs and weights made from the seed, the program built, every shape of the
cell warmed up (the first run in a checkout builds the CUDA kernels)."""


def read(run):
    return run.setup_s
