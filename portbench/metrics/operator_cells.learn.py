"""Operator cells a learn rescored (the counter ``hc.operator_cells``: the
arc operators' cells and the node-type operators' nodes of every
rescoring pass, at the first scores and at every update; n(n - 1) + n at
the first scores of n nodes), over the learns of the profiled
sub-window."""

from portbench.harness import phases


def read(run):
    return phases.per_call(run, ["hc.operator_cells"])
