"""The ``learn_net`` loop's cells, ``spbn46.learn`` and
``spbn8.learn_cvlik``, at a tiny size on the CPU through the port's plain
route: a run is correct, the control (the reference in bfloat16) and a
fault planted in the CV channel are not; the ``dag`` generator draws the
configuration's network; the loop's kernel #1 programs are the CKDE
families its learns scored, at their own widths. On a card, the command
runs both cells."""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys

import numpy as np
import pytest

from tiny import ROOT, run

from portbench.harness import dag, program, spec
from portbench.reference.family import CKDE

CELLS = ["spbn46.learn", "spbn8.learn_cvlik"]
SEED = 2**31 + 24680
# a tiny learn: 240 rows, and the DAG cut to 12 nodes and 16 arcs
ROWS = 240
DAG = {"columns": 12, "arcs": 16}
MIX = {"pool": 2, "warm": 1, "check": 1, "trace_calls": 1}


def cell(name):
    c = spec.Cell(name)
    c.config = copy.deepcopy(c.config)
    c.mix = copy.deepcopy(c.mix)
    c.config["data"]["rows"] = ROWS
    if c.config["data"]["generator"] == "dag":
        c.config["data"].update(DAG)
    c.mix.update(MIX)
    return c


def within(numbers, limits):
    return all(math.isfinite(v) and v <= limits["numbers"][k]["limit"]
               for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct(name):
    c = cell(name)
    result = run(c, SEED)
    assert result["correct"], result["checked"]
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert set(result["checked"]) == {"score_rel", "search_mismatch"}


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_the_operator_sets(name):
    result = run(cell(name), SEED, trace=True)
    assert result["correct"], result["checked"]
    metrics = result["metrics"]
    for m in ("operator_cells.learn", "cells_host_ms.learn",
              "hc_iterations.learn", "families_scored.learn"):
        assert metrics[m]["value"] > 0, m
    # no card: no roofline
    assert "ckde_pairs_roofline.learn" not in metrics
    assert ("validation_host_ms.learn" in metrics) == (name == CELLS[0])


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_time_leaves_the_harness_out(name):
    """``cells_host_ms.learn`` takes from ``pb.hc.cells`` each harness span
    nested in it once: the score calls and the recording of their
    families, none of which lies inside another."""
    import types

    from portbench.harness import phases, trace

    c = cell(name)
    session = c.loop().SESSION(c.config, c.mix, SEED, True, "cpu")
    session.setup()
    run_ = types.SimpleNamespace(
        profile=trace.profiled(session.sync, session.call, 1))
    reader = spec.load_module(
        f"{ROOT}/portbench/metrics/cells_host_ms.learn.py", "cells_host_ms")
    harness = sorted((s, e) for n, s, e, _ in run_.profile.host
                     if n in reader.HARNESS)
    names = {n for n, *_ in run_.profile.host}
    assert {"pb.score.cv", "pb.score.keep"} <= names
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(harness, harness[1:]))
    cells = phases.span_ms(run_, ("pb.hc.cells",))
    assert 0 < reader.read(run_) < cells


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    c = cell(name)
    session = c.loop().SESSION(c.config, c.mix, SEED, False, "cpu")
    session.setup()
    numbers = session.check(session.control())
    assert not within(numbers, c.limits), numbers


def test_a_cv_score_altered_is_not_correct(monkeypatch):
    import pybnesian_tpu_torch.learning.scores.likelihood as lik

    def altered(self, model, families, _orig=lik.CVLikelihood
                .local_score_batch):
        out = np.array(_orig(self, model, families), np.float64)
        out[0] += 0.01 * abs(out[0])
        return out
    monkeypatch.setattr(lik.CVLikelihood, "local_score_batch", altered)
    assert not run(cell("spbn8.learn_cvlik"), SEED)["correct"]


def test_the_dag_is_the_configurations():
    data = spec.Cell("spbn46.learn").config["data"]
    seed = spec.Cell("spbn46.learn").mix["data_seed"]
    net = dag.structure(data, seed)
    assert len(net.parents) == 46 and len(net.arcs()) == 70
    # parents come before their children: no cycle
    assert all(p < v for p, v in net.arcs())
    assert max(map(len, net.parents)) <= 4
    children = [v for v, ps in enumerate(net.parents) if ps]
    assert len(net.nonlinear) == len(children) // 2
    assert net.nonlinear <= set(children)


def test_the_same_seed_gives_the_same_frames():
    data = dict(spec.Cell("spbn46.learn").config["data"], rows=500)
    one = dag.frame(data, 11, 1, 0)
    assert list(one) == [f"x{v}" for v in range(46)]
    for k, v in dag.frame(data, 11, 1, 0).items():
        assert v.dtype == np.float32 and np.array_equal(v, one[k])
    other = dag.frame(data, 11, 1, 1)
    assert not np.array_equal(other["x0"], one["x0"])
    assert dag.structure(data, 11).arcs() != dag.structure(data, 12).arcs()


@pytest.mark.parametrize("name", CELLS)
def test_the_pairs_programs_are_the_scored_ckde_families(name):
    c = cell(name)
    session = c.loop().SESSION(c.config, c.mix, SEED, False, "cpu")
    session.setup()
    session.call(0)
    _, _, _, record = session.learns[-1]
    ckde = [(ch, ps) for ch, _, ps, kind, _ in program.scored(record)
            if kind == CKDE]
    assert ckde
    k = c.config["learn"]["folds"]
    # the CV rows: all 240, or the hold-out's 192 training rows (48 held
    # out), in k folds whose first n % k hold one more test row
    n = ROWS if name == CELLS[1] else ROWS - 48
    tests = [n // k + (i < n % k) for i in range(k)]
    want = []
    for ch, ps in ckde:
        if ch == "cv":
            want += [(n - t, t, 1 + len(ps), bool(ps)) for t in tests]
        else:
            want.append((ROWS - 48, 48, 1 + len(ps), bool(ps)))
    assert session.pairs_programs(0) == want


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_command_is_correct_on_the_card(card, name):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checked"]
