"""Milliseconds a call of ``slogl``'s host work: ``pb.slogl`` (one
``slogl``) less the waits on the card inside it (``pb.*.wait``), on the
profiler's clock, over the calls of the profiled sub-window."""

from portbench.harness import phases


def read(run):
    return phases.span_ms(run, ("pb.slogl",), less=phases.is_wait)
