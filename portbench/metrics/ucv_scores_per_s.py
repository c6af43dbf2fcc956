"""Families scored (10-fold CV each, UCV bandwidths) over the whole window,
per second."""


def read(run):
    return run.window.rate()
