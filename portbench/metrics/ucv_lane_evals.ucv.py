"""UCV objective evaluations a call, summed over every search's problems
(the counter ``ucv.lane_evaluations``: what each problem's own
Nelder-Mead needed), over the calls of the profiled sub-window."""

from portbench.harness import phases


def read(run):
    return phases.per_call(run, ["ucv.lane_evaluations"])
