"""Seconds from the process's start to the first timed call: imports, the
CUDA context, kernel builds or loads, data and warm calls."""


def read(run):
    return run.setup_s
