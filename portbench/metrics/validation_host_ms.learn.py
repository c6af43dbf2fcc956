"""Milliseconds a learn of the validation channel's host work: the
hold-out score's spans (``pb.holdout.batch``, and ``pb.holdout.refit``,
the one-family refits through which ``hc`` takes every validation
score) less the waits on the card inside them (``pb.*.wait``), on the
profiler's clock, over the learns of the profiled sub-window."""

from portbench.harness import phases


def read(run):
    return phases.span_ms(run, ("pb.holdout.batch", "pb.holdout.refit"),
                          less=phases.is_wait)
