"""Cells of the benchmark cut to a size the CPU runs in seconds, through
the port's plain route (the command itself refuses to run without a
card)."""

from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import spec  # noqa: E402

# per loop: the mix's parameters at the tiny size, and the rows
MIX = {
    "learn": {"pool": 2, "warm": 1, "check": 1, "trace_calls": 1},
    "cv_batch": {"frames": 2, "trace_calls": 2, "check_calls": 1},
    "slogl": {"tests": 2, "warm": 1, "trace_calls": 2},
}
ROWS = {"learn": 240, "cv_batch": 300, "slogl": 400}
UCV = {"frames": 1, "shifts": [1]}
UCV_ROWS = 200


def cell(name, root=spec.ROOT):
    """The cell ``name`` of the benchmark at ``root``, cut to a tiny
    size."""
    c = spec.Cell(name, root)
    c.config = copy.deepcopy(c.config)
    c.mix = copy.deepcopy(c.mix)
    loop = c.mix["loop"]
    ucv = c.mix.get("selector") == "ucv"
    rows = UCV_ROWS if ucv else ROWS[loop]
    c.config["data"]["rows"] = rows
    if "model" in c.config:
        c.config["model"]["train_rows"] = rows
        c.config["model"]["test_rows"] = rows
    c.mix.update({k: v for k, v in MIX[loop].items() if k in c.mix})
    if ucv:
        c.mix.update(UCV)
    return c


def run(c, seed=2**31 + 7, seconds=0.05, trace=False):
    """One run of the cut cell on the CPU: the result's dict."""
    from portbench import run as command

    return command.execute(c, seed, seconds, trace, "cpu")
