"""Families a learn scored, both channels (the counters
``score.families.cv`` and ``score.families.holdout``: every family a CV
or hold-out score returned, batched or alone), over the learns of the
profiled sub-window."""

from portbench.harness import phases


def read(run):
    return phases.per_call(run, ["score.families.cv",
                                 "score.families.holdout"])
