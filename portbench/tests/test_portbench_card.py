"""On the card: every cell runs through the command at its own size for a
short window and comes out correct. Skips without a CUDA card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from tiny import ROOT

CELLS = ["spbn8.learn", "kde5.cv_nr", "kde5.cv_ucv", "spbn8.logl"]


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
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checked"]
    assert result["device"]["platform"] == "gpu"
    assert os.path.exists(os.path.join(ROOT, "BENCHMARK.json"))
