"""``hc`` iterations a learn (the counter ``hc.iterations``: every
iteration a search entered, the last, which found no improving operator
or ran out of patience, included), over the learns of the profiled
sub-window."""

from portbench.harness import phases


def read(run):
    return phases.per_call(run, ["hc.iterations"])
