"""Milliseconds per learn inside the score calls (both channels), from
the host spans around every score call."""


def read(run):
    if run.spans is None:
        return None
    return sum(run.spans.values()) / len(run.window.calls) * 1e3
