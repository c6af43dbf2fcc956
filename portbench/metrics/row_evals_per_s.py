"""Nodes x test rows evaluated by ``slogl`` over the whole window, per
second."""


def read(run):
    return run.window.rate()
