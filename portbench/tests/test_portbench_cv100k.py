"""The 100,000-row CV cell ``kde5.cv_nr_100k``: kernel #1's programs and
their bound at the cell's full size, the cell at a tiny size on the CPU
(correct, its metrics read, its control not correct), and on a card the
command at the cell's own size (``cuda``; skips without one)."""

from __future__ import annotations

import math

import pytest

from test_portbench_card import card  # noqa: F401  (fixture)
from test_portbench_card import (
    test_the_command_is_correct_on_the_card as on_the_card)
from tiny import cell, run

from portbench.harness import device
from portbench.loops.cv_batch import CvBatch

NAME = "kde5.cv_nr_100k"
SEED = 2**31 + 100_003
H100 = {"sms": 132, "max_sm_hz": 1980e6}


def full_size_session():
    """A session of the cell at its own size, with what
    ``pairs_programs`` reads and no data made."""
    c = cell(NAME)
    c.config["data"]["rows"] = 100_000
    session = CvBatch.__new__(CvBatch)
    session.config, session.mix = c.config, c.mix
    session.columns = [{"x0": [0.0] * 100_000}]
    session.scores = [None]
    session.d = 5
    session.seed = SEED
    return session


@pytest.mark.parametrize("i", [0, 1, 2])
def test_a_call_is_150_programs_of_90000_by_10000(i):
    programs = full_size_session().pairs_programs(i)
    assert len(programs) == 150
    assert {(ntr, nte) for ntr, nte, _, _ in programs} == {(90_000, 10_000)}
    assert sorted({cols for _, _, cols, _ in programs}) == [1, 2, 3]


def test_the_bound_at_100k_rows():
    """2.25e11 exps a call at the H100's 132 SMs and 1980 MHz: 53.8 ms,
    the SFU's, a hundred times the 10,000-row cell's."""
    exps, ops, nbytes = device.pairs_work(full_size_session()
                                          .pairs_programs(0))
    assert exps == 2.25e11
    ms, by = device.bound_ms(H100, exps, ops, nbytes)
    assert by == "sfu"
    assert ms == pytest.approx(53.8, abs=0.1)


def test_a_tiny_run_is_correct():
    c = cell(NAME)
    result = run(c, SEED)
    assert result["correct"], result["checked"]
    assert set(result["metrics"]) == {"family_scores_per_s", "setup_s"}
    assert set(result["checked"]) == {"score_rel"}


def test_a_tiny_traced_run_reads_the_host_span():
    c = cell(NAME)
    c.mix["trace_calls"] = 1
    result = run(c, SEED, trace=True)
    assert result["correct"], result["checked"]
    assert result["metrics"]["cv_host_ms.score"]["value"] > 0
    # a device metric: the card's clock is not read on the CPU
    assert "ckde_pairs_roofline.score" not in result["metrics"]


def test_the_control_is_not_correct():
    c = cell(NAME)
    session = c.loop().SESSION(c.config, c.mix, SEED, False, "cpu")
    session.setup()
    numbers = session.check(session.control())
    limit = c.limits["numbers"]["score_rel"]["limit"]
    assert not (math.isfinite(numbers["score_rel"])
                and numbers["score_rel"] <= limit), numbers


@pytest.mark.cuda
def test_the_command_is_correct_on_the_card(card):
    """The cell at its own size through the command, a short window."""
    on_the_card(card, NAME)
