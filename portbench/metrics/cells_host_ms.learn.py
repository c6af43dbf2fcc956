"""Milliseconds a learn of the operator sets' own host work in their
rescoring passes: the spans ``pb.hc.cells`` (the walk of the cells to a
family list and the fill of the deltas) less the harness's spans nested
in them (``pb.score.cv`` and ``pb.score.validation`` around each score
call, with the port's score spans and its waits on the card inside them,
and ``pb.score.keep``, the recording of each call's families), on the
profiler's clock, over the learns of the profiled sub-window."""

from portbench.harness import phases

HARNESS = ("pb.score.cv", "pb.score.validation", "pb.score.keep")


def read(run):
    return phases.span_ms(run, ("pb.hc.cells",), less=HARNESS.__contains__)
