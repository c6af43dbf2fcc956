"""The metrics that read the port's own spans and counters: each finds
something to read in a tiny traced run of its cell on the CPU, the UCV
search kernel's roofline (a device metric) reads nothing without a card,
and the roofline's arithmetic."""

from __future__ import annotations

import pytest

from tiny import cell, run

from portbench.harness import device, spec
from portbench.harness.phases import is_wait, span_ms

# the metric readers this file holds to their cells, by cell
READERS = {
    "spbn8.learn": ["hc_iterations.learn", "families_scored.learn",
                    "score_wait_ms.learn", "validation_host_ms.learn"],
    "kde5.cv_nr": ["cv_host_ms.score"],
    "kde5.cv_ucv": ["ucv_host_ms.ucv", "ucv_lane_evals.ucv"],
    "spbn8.logl": ["slogl_host_ms.logl"],
}
SEED = 2**31 + 54321
_RUNS = {}


def traced(name):
    """One tiny traced run of ``name`` a module (its metrics), with the
    port's counters cleared before it."""
    if name not in _RUNS:
        from pybnesian_tpu_torch.runtime import tracing

        tracing.reset_counters()
        c = cell(name)
        # one profiled call is enough to read, and a UCV call on the CPU
        # takes tens of seconds
        c.mix["trace_calls"] = 1
        result = run(c, SEED, trace=True)
        assert result["correct"], result["checked"]
        _RUNS[name] = result["metrics"]
    return _RUNS[name]


def reader(name):
    return spec.load_module(spec.Cell("spbn8.learn").path(
        "metrics", name, ".py"), "portbench_metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("cell_name, metric", [
    (c, m) for c, ms in READERS.items() for m in ms])
def test_each_reader_reads_its_cell(cell_name, metric):
    metrics = traced(cell_name)
    assert metrics[metric]["value"] > 0, metrics


def test_the_ucv_roofline_reads_nothing_without_a_card():
    assert "ucv_search_roofline.ucv" not in traced("kde5.cv_ucv")


class _Profile:
    """A profile's host events: (name, start s, end s, thread)."""

    def __init__(self, host, calls):
        self.host, self.calls = host, calls


class _Run:
    def __init__(self, profile):
        self.profile = profile


def test_spans_less_their_nested_waits():
    host = [("pb.cv.batch", 0.0, 1.0, 1), ("pb.score.wait", 0.2, 0.5, 1),
            ("pb.cv.batch", 2.0, 3.0, 1), ("pb.score.wait", 2.5, 2.6, 1),
            ("pb.score.wait", 4.0, 4.5, 1), ("aten::add", 0.1, 0.2, 1)]
    r = _Run(_Profile(host, 2))
    assert span_ms(r, ("pb.cv.batch",)) == pytest.approx(1000.0)
    assert span_ms(r, ("pb.cv.batch",), less=is_wait) == pytest.approx(800.0)
    assert span_ms(r, ("pb.slogl",)) is None


def test_the_ucv_search_bound_of_phase_9():
    """2198 lane evaluations over 10 lanes of 9,000 rows at width 3, at
    the H100's 132 SMs and 1980 MHz: 21.2851 ms, the SFU's."""
    roofline = reader("ucv_search_roofline.ucv")
    pairs = {3: 2198 * 9000 * 8999 // 2}
    card = {"sms": 132, "max_sm_hz": 1980e6}
    ms, by = device.bound_ms(card, *roofline.work(pairs))
    assert by == "sfu"
    assert round(ms, 4) == 21.2851
    # the operations a pair: 2d + 4 up to width 16, 3d + 3 wider
    assert roofline.work({16: 1})[1] == 36 and roofline.work({17: 1})[1] == 54
