"""Seconds per learned network: the whole window over the learns it
completed."""


def read(run):
    return run.window.seconds / len(run.window.calls)
