"""Milliseconds a learn in which the score layer blocks on the card: the
port's wait spans (``pb.*.wait``: its own read-backs and those of the
factors it refits) inside its score spans (``pb.cv.batch``,
``pb.holdout.batch``, ``pb.holdout.refit``), on the profiler's clock,
over the learns of the profiled sub-window."""

from portbench.harness import phases

SCORES = ("pb.cv.batch", "pb.holdout.batch", "pb.holdout.refit")


def read(run):
    inside = phases.span_ms(run, SCORES)
    if inside is None:
        return None
    return inside - phases.span_ms(run, SCORES, less=phases.is_wait)
