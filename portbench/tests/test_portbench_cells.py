"""Each cell's loop, check and control at a tiny size on the CPU, through
the port's plain route: a sound run comes out correct, the control (the
reference in bfloat16 in the program's place) and every fault planted in
the timed path come out not correct."""

from __future__ import annotations

import math

import numpy as np
import pytest

from tiny import cell, run

CELLS = ["spbn8.learn", "kde5.cv_nr", "kde5.cv_ucv", "spbn8.logl"]
SEED = 2**31 + 12345


def within(numbers, limits):
    return all(math.isfinite(v) and v <= limits["numbers"][k]["limit"]
               for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_reports_its_metrics(name):
    c = cell(name)
    result = run(c, SEED)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checked"
    assert result["correct"], result["checked"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    want = {m["name"] for m in c.end_to_end}
    assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert m["value"] > 0
    assert set(result["checked"]) == set(c.limits["numbers"])


@pytest.mark.parametrize("name", ["spbn8.learn", "kde5.cv_nr"])
def test_a_traced_run_reports_the_trace(name):
    result = run(cell(name), SEED, trace=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    c = cell(name)
    session = c.loop().SESSION(c.config, c.mix, SEED, False, "cpu")
    session.setup()
    numbers = session.check(session.control())
    assert not within(numbers, c.limits), numbers


def plant(monkeypatch, name, fault):
    """Break the timed path underneath the harness."""
    import pybnesian_tpu_torch.learning.scores.likelihood as lik

    if fault == "answer altered":
        def altered(self, model, families, _orig=lik.CVLikelihood
                    .local_score_batch):
            out = np.array(_orig(self, model, families), np.float64)
            out[0] += 0.01 * abs(out[0])
            return out
        monkeypatch.setattr(lik.CVLikelihood, "local_score_batch", altered)
    elif fault == "half the batch":
        def half(data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx,
                 te_mask, _orig=lik._fused_cv_scores, **kw):
            te_mask = te_mask.clone()
            te_mask[:, te_mask.shape[1] // 2:] = 0
            return 2 * _orig(data, null_mask, col_idx, col_mask, tr_idx,
                             tr_mask, te_idx, te_mask, **kw)
        monkeypatch.setattr(lik, "_fused_cv_scores", half)
    elif fault == "state unchanged" and name == "spbn8.learn":
        from pybnesian_tpu_torch.learning.algorithms import hillclimbing

        monkeypatch.setattr(hillclimbing.GreedyHillClimbing, "estimate",
                            lambda self, ops, score, start, **kw:
                            start.clone())
    elif fault == "state unchanged":
        import pybnesian_tpu_torch.kde.ucv as ucv

        def unmoved(X, valid, Ns, starts, d, diagonal, _orig=ucv._minimize):
            got = _orig(X, valid, Ns, starts, d, diagonal)
            return got._replace(x=np.asarray(starts, np.float64))
        monkeypatch.setattr(ucv, "_minimize", unmoved)
    elif fault == "search cut short":
        import pybnesian_tpu_torch.kde.ucv as ucv

        def cut(X, valid, Ns, x0s, d, diagonal, max_iter,
                _orig=ucv.ucv_search_reference):
            full = _orig(X, valid, Ns, x0s, d, diagonal, max_iter)
            its = int(full.iterations.float().median())
            return _orig(X, valid, Ns, x0s, d, diagonal, max(1, its // 2))
        monkeypatch.setattr(ucv, "ucv_search_reference", cut)


FAULTS = [
    ("spbn8.learn", "answer altered"),
    ("spbn8.learn", "half the batch"),
    ("spbn8.learn", "state unchanged"),
    ("kde5.cv_nr", "answer altered"),
    ("kde5.cv_nr", "half the batch"),
    ("kde5.cv_ucv", "answer altered"),
    ("kde5.cv_ucv", "state unchanged"),
    ("kde5.cv_ucv", "search cut short"),
    ("spbn8.logl", "answer altered"),
    ("spbn8.logl", "half the batch"),
]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, name, fault):
    c = cell(name)
    if name == "spbn8.logl":
        from pybnesian_tpu_torch.models.base import BayesianNetworkBase

        orig = BayesianNetworkBase.slogl

        def broken(self, df):
            if fault == "answer altered":
                return orig(self, df) * 1.001
            half = df.take(np.arange(df.num_rows // 2))
            return 2 * orig(self, half)
        monkeypatch.setattr(BayesianNetworkBase, "slogl", broken)
    else:
        plant(monkeypatch, name, fault)
    result = run(c, SEED)
    assert not result["correct"], result["checked"]
