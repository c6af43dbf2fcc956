"""Milliseconds a call of the CV score's host work: ``pb.cv.batch`` (one
``CVLikelihood.local_score_batch``) less the waits on the card inside it
(``pb.*.wait``), on the profiler's clock, over the calls of the profiled
sub-window."""

from portbench.harness import phases


def read(run):
    return phases.span_ms(run, ("pb.cv.batch",), less=phases.is_wait)
