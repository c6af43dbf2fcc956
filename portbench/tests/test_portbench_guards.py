"""What the harness refuses and what it reckons: no JAX anywhere, no run
without a card, the roofline bound's arithmetic."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from tiny import ROOT, cell, run

from portbench import run as command
from portbench.harness import device
from portbench.loops.cv_batch import CvBatch

REFUSED = {"jax", "jaxlib", "flax", "pybnesian_tpu"}


def imported(path):
    """Top-level names of every module ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(folder):
    for dirpath, _, files in os.walk(os.path.join(ROOT, folder)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources("portbench"):
        assert not set(imported(path)) & REFUSED, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("portbench/reference"):
        names = set(imported(path))
        assert "pybnesian_tpu_torch" not in names, path
        assert "portbench" not in names, path


def test_names_are_compared_whole():
    assert command.forbidden_modules(["pybnesian_tpu_torch.ops"]) == []
    assert command.forbidden_modules(["pybnesian_tpu.ops", "jax.numpy",
                                      "jaxlib"]) == ["jax", "jaxlib",
                                                     "pybnesian_tpu"]


def test_a_rehearsal_loads_no_jax():
    run(cell("spbn8.logl"))
    assert command.forbidden_modules() == []


def test_the_command_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "kde5.cv_nr", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    if proc.returncode == 0:
        pytest.skip("a CUDA card is visible")
    assert proc.stdout.strip() == ""


def test_the_bound_at_kde5_cv_nr():
    """2.25e9 exps a call at the H100's 132 SMs and 1980 MHz: 0.5381 ms,
    the SFU's."""
    session = CvBatch.__new__(CvBatch)
    c = cell("kde5.cv_nr")
    c.config["data"]["rows"] = 10_000
    session.config, session.mix = c.config, c.mix
    session.columns = [{"x0": [0.0] * 10_000}]
    session.scores = [None] * 4
    session.d = 5
    session.seed = 1
    programs = session.pairs_programs(0)
    exps, ops, nbytes = device.pairs_work(programs)
    assert len(programs) == 150
    assert exps == 2.25e9
    card = {"sms": 132, "max_sm_hz": 1980e6}
    ms, by = device.bound_ms(card, exps, ops, nbytes)
    assert by == "sfu"
    assert round(ms, 4) == 0.5381


def test_the_bound_at_spbn8_logl():
    from portbench.loops.slogl import Slogl

    c = cell("spbn8.logl")
    session = Slogl.__new__(Slogl)
    session.config = c.config
    session.config["model"].update(train_rows=10_000, test_rows=10_000)
    exps, _, _ = device.pairs_work(session.pairs_programs(0))
    assert exps == 7e8
