"""Greedy hill-climbing of the torch port against the JAX package's.

Both packages learn from the same numpy data and seed; the learned graphs
must have the same arcs and node types (compared by ``ToString()``), and
a callback that records every iteration's operator must record the same
sequence in both. Cases:

- the README anchor (tests/learning/test_hillclimbing.py: 100 rows,
  GaussianNetwork, BIC, 2 arcs), plain and with ``max_iters=1``, a
  blacklist, a whitelist, ``max_indegree=1`` and ``epsilon=1e9``;
- a KDENetwork on 300 rows of the normal chain, ``patience=0,
  max_iters=3`` (tests/learning/test_likelihood_scores.py);
- a SemiparametricBN on the 600-row sin data, ``seed=0, patience=1``,
  where y comes out CKDE (same file);
- a SemiparametricBN on a 5-node nonlinear chain of 500 rows,
  ``patience=2``;
- the default scores named as strings (``"cv-lik"``, ``"holdout-lik"``,
  ``"validated-lik"``: the port seeds and updates its validation cache
  through ``vlocal_score_batch``, where the JAX package updates it through
  ``vlocal_score``, a fitted factor; in float64 the two routes agree);
- a DiscreteBN on 2,000 rows of a 6-node categorical chain, with the
  discrete BIC (the type's default) and ``"bde"``, plain and with a
  blacklist, a whitelist, ``max_indegree=1`` and an ``epsilon``; the
  recorder's callback makes these the Python loop, and
  ``test_native_discrete_hc_learns_the_same_graph`` runs the same cases
  without a callback, through the native loop of both packages;
- a GaussianNetwork on the README frame with ``"bge"``;
- ``"validated-lik"`` on a chain with a constant column, against the same
  search whose validation channel refits every family (the port alone).

All of it float64 on the CPU; deltas compared with rtol 1e-9 / atol 1e-7.
"""

import functools

import numpy as np
import pandas as pd
import pytest

import pybnesian_tpu as pj
import pybnesian_tpu_torch as pt
from pybnesian_tpu_torch import interop

from data_gen import normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


TOL = dict(rtol=1e-9, atol=1e-7)


def readme_df():
    np.random.seed(1)
    size = 100
    a = np.random.normal(3, np.sqrt(0.5), size)
    c = -4.2 - 1.2 * a + np.random.normal(0, np.sqrt(0.75), size)
    d = 3 + 1.2 * c + np.random.normal(0, np.sqrt(0.5), size)
    e = np.random.normal(0, 1, size)
    return pd.DataFrame({"a": a, "c": c, "d": d, "e": e})


def sin_df():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 600)
    y = np.sin(2.5 * x) + rng.normal(0, 0.15, 600)
    return pd.DataFrame({"x": x, "y": y})


def chain_df(n=500, d=5, seed=3):
    rng = np.random.default_rng(seed)
    cols = {}
    prev = rng.normal(0, 1, n)
    cols["x0"] = prev
    for i in range(1, d):
        prev = np.sin(1.2 * prev) + 0.5 * prev + rng.normal(0, 0.4, n)
        cols[f"x{i}"] = prev
    return pd.DataFrame(cols)


def discrete_df(n=2000, d=6, seed=0):
    """A categorical chain: each column copies the one before it, or with
    probability 0.3 draws afresh; cardinalities 3, 2, 4, 3, 2, 4."""
    rng = np.random.default_rng(seed)
    cols = {}
    prev = rng.integers(0, 3, n)
    for i in range(d):
        k = (3, 2, 4)[i % 3]
        cur = np.where(rng.random(n) < 0.3, rng.integers(0, k, n), prev % k)
        cols[f"v{i}"] = pd.Categorical.from_codes(
            cur, [f"c{j}" for j in range(k)])
        prev = cur
    return pd.DataFrame(cols)


class Recorder:
    """Records each iteration's operator as :func:`interop.operator_state`
    (the same class serves both packages: hc calls ``call`` only)."""

    def __init__(self):
        self.steps = []

    def call(self, model, operator, score, iteration):
        self.steps.append((iteration, interop.operator_state(operator)))


def _types(pkg):
    return {"gaussian": pkg.GaussianNetworkType(),
            "kde": pkg.KDENetworkType(),
            "spbn": pkg.SemiparametricBNType(),
            "discrete": pkg.DiscreteBNType()}


CASES = {
    "readme": (readme_df, "gaussian", {}),
    "readme-max-iters-1": (readme_df, "gaussian", dict(max_iters=1)),
    "readme-blacklist": (readme_df, "gaussian",
                         dict(arc_blacklist=[("a", "c"), ("c", "a")])),
    "readme-whitelist": (readme_df, "gaussian",
                         dict(arc_whitelist=[("e", "d")])),
    "readme-max-indegree-1": (readme_df, "gaussian", dict(max_indegree=1)),
    "readme-epsilon": (readme_df, "gaussian", dict(epsilon=1e9)),
    "kde-300": (lambda: normal_chain_data(300), "kde",
                dict(patience=0, max_iters=3)),
    "spbn-sin-600": (sin_df, "spbn", dict(seed=0, patience=1)),
    "spbn-chain-500": (chain_df, "spbn", dict(patience=2)),
    "spbn-cv-lik": (sin_df, "spbn", dict(score="cv-lik", max_iters=4)),
    "spbn-holdout-lik": (sin_df, "spbn", dict(score="holdout-lik",
                                              max_iters=4)),
    "spbn-validated-lik": (chain_df, "spbn", dict(score="validated-lik",
                                                  patience=1, max_iters=6)),
    "gaussian-bge": (readme_df, "gaussian", dict(score="bge")),
}
DISCRETE_CASES = {
    f"discrete-{score}{'-' + name if name else ''}": (
        discrete_df, "discrete", dict(score=score, **kwargs))
    for score in ("bic", "bde")
    for name, kwargs in {
        "": {},
        "blacklist": dict(arc_blacklist=[("v0", "v1"), ("v1", "v0")]),
        "whitelist": dict(arc_whitelist=[("v5", "v0")]),
        "max-indegree-1": dict(max_indegree=1),
        "epsilon": dict(epsilon=600.0),
    }.items()
}
CASES.update(DISCRETE_CASES)


@functools.lru_cache(maxsize=None)
def _learn(case):
    """Both packages' learned network and recorded steps for ``case``
    (learned once per case; the tests only read them)."""
    make, kind, kwargs = CASES[case]
    df = make()
    out = {}
    for name, pkg in (("jax", pj), ("port", pt)):
        recorder = Recorder()
        model = pkg.hc(df, bn_type=_types(pkg)[kind], callback=recorder,
                       **kwargs)
        out[name] = (model, recorder.steps)
    return out


def _graph(model):
    return (sorted(model.arcs()),
            {n: model.node_type(n).ToString() for n in model.nodes()})


@pytest.mark.parametrize("case", list(CASES))
def test_hc_learns_the_jax_graph(case):
    out = _learn(case)
    (jmodel, jsteps), (tmodel, tsteps) = out["jax"], out["port"]
    assert _graph(tmodel) == _graph(jmodel)
    assert type(tmodel).__name__ == type(jmodel).__name__
    # the same operators, iteration by iteration, with the same deltas
    assert [(i, s and s[:3]) for i, s in tsteps] == [
        (i, s and s[:3]) for i, s in jsteps]
    np.testing.assert_allclose([s[3] for _, s in tsteps if s],
                               [s[3] for _, s in jsteps if s], **TOL)


@pytest.mark.parametrize("case", list(DISCRETE_CASES))
def test_native_discrete_hc_learns_the_same_graph(case):
    """Without a callback both packages run the whole search in the native
    core; it must learn the graph that the Python loop learnt."""
    from pybnesian_tpu_torch.learning.scores import discrete_native

    make, kind, kwargs = CASES[case]
    df = make()
    jmodel = pj.hc(df, bn_type=_types(pj)[kind], **kwargs)
    before = discrete_native.hc_discrete.calls
    tmodel = pt.hc(df, bn_type=_types(pt)[kind], **kwargs)
    assert discrete_native.hc_discrete.calls == before + 1
    assert _graph(tmodel) == _graph(jmodel)
    assert _graph(tmodel) == _graph(_learn(case)["port"][0])
    assert tmodel.num_arcs() >= 3


@pytest.mark.parametrize("make", [pt.BIC, pt.BDe], ids=["bic", "bde"])
def test_a_search_stays_on_its_scores_tier(make):
    """On the device's tier the search runs the Python loop with or
    without a callback, every batch on the device, and learns one graph;
    it is the native tier's graph up to exact ties."""
    from pybnesian_tpu_torch.learning.scores import discrete_native

    df = discrete_df()
    before = discrete_native.hc_discrete.calls
    score = make(df, native=False)
    plain = pt.hc(df, bn_type=pt.DiscreteBNType(), score=score)
    assert discrete_native.hc_discrete.calls == before
    assert score._native_cache is None
    watched = pt.hc(df, bn_type=pt.DiscreteBNType(),
                    score=make(df, native=False), callback=Recorder())
    assert _graph(plain) == _graph(watched)
    native = pt.hc(df, bn_type=pt.DiscreteBNType(),
                   score=make(df, native=True))
    assert discrete_native.hc_discrete.calls == before + 1
    assert ({frozenset(a) for a in native.arcs()}
            == {frozenset(a) for a in plain.arcs()})


def test_discrete_restrictions_hold():
    assert not {("v0", "v1"), ("v1", "v0")} & set(
        _learn("discrete-bic-blacklist")["port"][0].arcs())
    assert ("v5", "v0") in _learn("discrete-bde-whitelist")["port"][0].arcs()
    capped = _learn("discrete-bde-max-indegree-1")["port"][0]
    assert max(len(capped.parents(n)) for n in capped.nodes()) == 1
    assert (_learn("discrete-bic-epsilon")["port"][0].num_arcs()
            < _learn("discrete-bic")["port"][0].num_arcs())


def test_readme_anchor_learns_two_arcs():
    out = _learn("readme")
    assert out["port"][0].num_arcs() == 2


def test_spbn_sin_makes_y_ckde():
    out = _learn("spbn-sin-600")
    assert out["port"][0].node_type("y") == pt.CKDEType()


def test_blacklist_and_whitelist_hold():
    blacklisted = _learn("readme-blacklist")["port"][0]
    assert not {("a", "c"), ("c", "a")} & set(blacklisted.arcs())
    assert ("e", "d") in _learn("readme-whitelist")["port"][0].arcs()


def test_greedy_hill_climbing_estimate_matches_jax():
    """The class entry point with explicit operators, score and start."""
    df = sin_df()
    jscore = pj.ValidatedLikelihood(df, test_ratio=0.2, k=5, seed=2)
    tscore = pt.ValidatedLikelihood(df, test_ratio=0.2, k=5, seed=2)
    jops = pj.OperatorPool([pj.ArcOperatorSet(), pj.ChangeNodeTypeSet()])
    tops = pt.OperatorPool([pt.ArcOperatorSet(), pt.ChangeNodeTypeSet()])
    jm = pj.GreedyHillClimbing().estimate(
        jops, jscore, pj.SemiparametricBN(["x", "y"]), patience=1)
    tm = pt.GreedyHillClimbing().estimate(
        tops, tscore, pt.SemiparametricBN(["x", "y"]), patience=1)
    assert _graph(tm) == _graph(jm)


class RefitRoute(pt.ValidatedLikelihood):
    """A validation channel that refits a factor for every family:
    ``ValidatedScore``'s loop over ``vlocal_score_node_type``."""

    def vlocal_score_batch(self, model, families):
        from pybnesian_tpu_torch.learning.scores.base import ValidatedScore

        return ValidatedScore.vlocal_score_batch(self, model, families)


def test_validated_hc_with_a_constant_column(monkeypatch):
    """The constant column z's hold-out batch value is −inf; ``hc`` takes
    the fitted factor's value for it, so the search learns what it learns
    when every validation family is refitted, no validation delta is NaN,
    and ``hc.validation_refits`` counts z's seed."""
    from torch.profiler import ProfilerActivity, profile

    from pybnesian_tpu_torch.learning.algorithms import hillclimbing
    from pybnesian_tpu_torch.runtime import tracing

    deltas, changed = [], []
    delta_score = hillclimbing._validation_delta_score

    def recorded(model, score, nodes_changed, cache):
        changed.extend(nodes_changed)
        deltas.append(delta_score(model, score, nodes_changed, cache))
        return deltas[-1]

    monkeypatch.setattr(hillclimbing, "_validation_delta_score", recorded)
    df = chain_df(d=4).assign(z=0.0)
    kwargs = dict(bn_type=pt.SemiparametricBNType(), patience=1,
                  max_iters=6)
    runs = {}
    for name, score in (("batch", "validated-lik"),
                        ("refit", RefitRoute(df, 0.2, 10, 0))):
        recorder = Recorder()
        deltas.clear()
        changed.clear()
        tracing.reset_counters()
        with np.errstate(divide="ignore", invalid="ignore"), \
                profile(activities=[ProfilerActivity.CPU]):
            model = pt.hc(df, score=score, callback=recorder, **kwargs)
        runs[name] = (model, recorder.steps, list(deltas), len(changed),
                      tracing.counters())
    tracing.reset_counters()
    model, steps, vdeltas, n_changed, counted = runs["batch"]
    want, wsteps, wdeltas, _, wcounted = runs["refit"]
    assert _graph(model) == _graph(want)
    assert not [a for a in model.arcs() if "z" in a]
    assert [(i, s and s[:3]) for i, s in steps] == [
        (i, s and s[:3]) for i, s in wsteps]
    assert len(vdeltas) == len(wdeltas) >= 3
    assert not np.any(np.isnan(vdeltas))
    np.testing.assert_allclose(vdeltas, wdeltas, **TOL)
    # z's family is seeded once and never changed; refitted in the batch,
    # it is finite there
    assert counted["hc.validation_refits"] == 1
    assert wcounted["hc.validation_refits"] == 0
    assert counted["hc.validation_batched"] == len(df.columns) + n_changed
