"""Seconds from the start of the process to the opening of the window:
imports, the build of the kernels on a checkout's first run, the weights
and inputs, the compared steps, the warm-up."""


def read(run):
    return run.setup_s
