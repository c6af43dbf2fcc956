"""Milliseconds a call of the UCV searches' host packing: the
normal-reference starts (``pb.ucv.starts``: a covariance and a Cholesky a
family and fold) and the search inputs (``pb.ucv.pack``: the padded rows,
their masks and starts), on the profiler's clock, over the calls of the
profiled sub-window."""

from portbench.harness import phases


def read(run):
    return phases.span_ms(run, ("pb.ucv.starts", "pb.ucv.pack"))
