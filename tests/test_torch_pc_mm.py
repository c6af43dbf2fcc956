"""The torch port's constraint-based learners (``PC``, ``MeekRules``,
``MMPC``, ``MMHC``, ``DMMHC``) against the JAX package, on the cases of
tests/learning/test_pc.py, test_mm_algorithms.py, test_pvalue_batch.py and
test_dmmhc_clg.py.

The same seeded frames go through both packages, and every learned graph
(PDAG arcs and edges, DAG arcs and node types, a dynamic network's static
and transition arcs) equals the reference's.
"""

import numpy as np
import pandas as pd
import pytest

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu_torch.learning.algorithms.pc import (
    _batched_assoc_sweep, _batched_sepset_search)

from data_gen import (discrete_data, mixed_data, normal_chain_data,
                      normal_indep_data)
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


def _pdag(g):
    return (sorted(g.arcs()), sorted(tuple(sorted(e)) for e in g.edges()))


def _dag(model):
    return (sorted(model.arcs()),
            {n: model.node_type(n).ToString() for n in model.nodes()})


def _collider(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    x, y = rng.normal(0, 1, n), rng.normal(0, 1, n)
    return pd.DataFrame({"x": x, "y": y,
                         "z": x + y + rng.normal(0, 0.5, n)})


class _SerialOnly(tpb.IndependenceTest):
    """A test of the port that keeps the base class's one-at-a-time
    ``pvalue_batch``, so that PC and MMPC take the serial route."""

    def __init__(self, inner):
        self.inner = inner

    def pvalue(self, x, y, *z):
        return self.inner.pvalue(x, y, *z)

    def variable_names(self):
        return self.inner.variable_names()

    def num_variables(self):
        return self.inner.num_variables()

    def name(self, i):
        return self.inner.name(i)

    def has_variables(self, v):
        return self.inner.has_variables(v)


PC_CASES = {
    "chain": (lambda: normal_chain_data(2000), "LinearCorrelation", {}),
    "collider": (_collider, "LinearCorrelation", {}),
    "independent": (lambda: normal_indep_data(2000), "LinearCorrelation",
                    {"alpha": 0.01}),
    "sepsets": (lambda: normal_chain_data(2000), "LinearCorrelation",
                {"use_sepsets": True}),
    "discrete": (lambda: discrete_data(4000), "ChiSquare", {}),
    "mixed": (lambda: mixed_data(1500), "MutualInformation", {}),
    "whitelist": (lambda: normal_chain_data(1500), "LinearCorrelation",
                  {"arc_whitelist": [("a", "b")]}),
    "blacklist": (lambda: normal_chain_data(1500), "LinearCorrelation",
                  {"edge_blacklist": [("a", "b")]}),
}


@pytest.mark.parametrize("name", list(PC_CASES))
def test_pc_matches_jax(name):
    make, test, kw = PC_CASES[name]
    df = make()
    kw = {"alpha": 0.05, **kw}
    got = tpb.PC().estimate(getattr(tpb, test)(df), **kw)
    want = jpb.PC().estimate(getattr(jpb, test)(df), **kw)
    assert type(got) is tpb.PartiallyDirectedGraph
    assert _pdag(got) == _pdag(want)


def test_pc_recovers_chain_and_collider():
    pdag = tpb.PC().estimate(tpb.LinearCorrelation(normal_chain_data(3000)),
                             alpha=0.05)
    skeleton = {frozenset(e) for e in pdag.edges()} | {
        frozenset(a) for a in pdag.arcs()}
    assert {frozenset(p) for p in [("a", "b"), ("b", "c"), ("c", "d")]} <= (
        skeleton)
    assert frozenset(("a", "d")) not in skeleton
    assert pdag.to_dag().is_dag()
    col = tpb.PC().estimate(tpb.LinearCorrelation(_collider()), alpha=0.05)
    assert col.has_arc("x", "z") and col.has_arc("y", "z")
    assert not col.has_connection("x", "y")


@pytest.mark.parametrize("use_sepsets", [False, True])
def test_pc_batched_equals_serial_path(use_sepsets):
    lc = tpb.LinearCorrelation(normal_chain_data(2000))
    g1 = tpb.PC().estimate(lc, alpha=0.05, use_sepsets=use_sepsets)
    g2 = tpb.PC().estimate(_SerialOnly(lc), alpha=0.05,
                           use_sepsets=use_sepsets)
    assert _pdag(g1) == _pdag(g2)


class _ClassBatch:
    """A duck-typed test with ``pvalue_batch`` on the class."""

    def pvalue_batch(self, triples):
        return np.ones(len(list(triples)))


class _InstanceBatch:
    """A duck-typed test with ``pvalue_batch`` set on the instance only."""

    def __init__(self):
        self.pvalue_batch = lambda triples: np.ones(len(list(triples)))


@pytest.mark.parametrize("make, batched", [
    (lambda pkg: pkg.LinearCorrelation(normal_chain_data(200)), True),
    (lambda pkg: pkg.ChiSquare(discrete_data(200)), True),
    (lambda pkg: _SerialOnly(None), False),
    (lambda pkg: _ClassBatch(), True),
    (lambda pkg: _InstanceBatch(), False),
], ids=["linearcorrelation", "chisquare", "base-class", "class-method",
        "instance-attribute"])
def test_pc_route_follows_the_class(make, batched):
    # PC reads ``pvalue_batch`` from the test's class, as the JAX package's
    # PC does: a method set on the instance alone leaves it on the serial
    # route
    from pybnesian_tpu.learning.algorithms.pc import (
        _has_real_batch as jax_route)
    from pybnesian_tpu_torch.learning.algorithms.pc import _has_real_batch

    assert _has_real_batch(make(tpb)) is batched
    if not isinstance(make(tpb), _SerialOnly):
        assert jax_route(make(jpb)) is batched


def test_pc_chisquare_batched_equals_serial_path():
    t = tpb.ChiSquare(discrete_data(3000, seed=7))
    assert _pdag(tpb.PC().estimate(t, alpha=0.05)) == _pdag(
        tpb.PC().estimate(_SerialOnly(t), alpha=0.05))


def test_pc_conditional_matches_jax():
    df = normal_chain_data(2000)
    got = tpb.PC().estimate_conditional(tpb.LinearCorrelation(df),
                                        ["c", "d"], ["a", "b"], alpha=0.05)
    want = jpb.PC().estimate_conditional(jpb.LinearCorrelation(df),
                                         ["c", "d"], ["a", "b"], alpha=0.05)
    assert set(got.interface_nodes()) == {"a", "b"}
    assert _pdag(got) == _pdag(want)


class _Scripted:
    """p-values looked up from a dict keyed by (x, y, zs); records the
    evaluation order."""

    def __init__(self, table, default=0.0):
        self.table, self.default, self.calls = table, default, []

    def pvalue_batch(self, triples):
        out = []
        for x, y, zs in triples:
            self.calls.append((x, y, tuple(zs)))
            out.append(self.table.get((x, y, tuple(zs)), self.default))
        return np.array(out)


def test_batched_sepset_search_takes_first_passing_candidate():
    t = _Scripted({("u", "v", ("c2",)): 0.9, ("u", "v", ("c3",)): 0.95})
    resolved = _batched_sepset_search(
        {("u", "v"): iter([("c1",), ("c2",), ("c3",)])}, t, alpha=0.05)
    assert resolved == {("u", "v"): ({"c2"}, 0.9)}


def test_batched_assoc_sweep_exact_max_for_survivors():
    t = _Scripted({("x", "y", ("a",)): 0.01, ("x", "y", ("b",)): 0.04,
                   ("x", "z", ("a",)): 0.2}, default=0.001)
    vals = _batched_assoc_sweep(
        {("x", "y"): iter([("a",), ("b",), ("c",)]),
         ("x", "z"): iter([("a",), ("b",)])},
        t, alpha=0.05, init={("x", "y"): 0.0, ("x", "z"): 0.0})
    assert vals[("x", "y")] == 0.04
    assert vals[("x", "z")] > 0.05


MEEK = [
    ("rule1", ["a", "b", "c"], [("a", "b")], [("b", "c")]),
    ("rule2", ["a", "b", "c"], [("a", "c"), ("c", "b")], [("a", "b")]),
    ("rule3", ["a", "b", "c1", "c2"], [("c1", "a"), ("c2", "a")],
     [("b", "a"), ("b", "c1"), ("b", "c2")]),
]


@pytest.mark.parametrize("rule,nodes,arcs,edges", MEEK,
                         ids=[m[0] for m in MEEK])
def test_meek_rules_match_jax(rule, nodes, arcs, edges):
    graphs = []
    for pkg in (jpb, tpb):
        g = pkg.PartiallyDirectedGraph(nodes, arcs, edges)
        assert getattr(pkg.MeekRules, rule)(g)
        graphs.append(_pdag(g))
    assert graphs[0] == graphs[1]


def test_meek_rules_to_fixpoint_koller_3_13():
    g = tpb.PartiallyDirectedGraph(
        ["A", "B", "C", "D", "E", "F", "G"], [("B", "E"), ("C", "E")],
        [("A", "B"), ("B", "D"), ("C", "F"), ("E", "F"), ("F", "G")])
    changed = True
    while changed:
        changed = (tpb.MeekRules.rule1(g) or tpb.MeekRules.rule2(g)
                   or tpb.MeekRules.rule3(g))
    assert {tuple(sorted(e)) for e in g.edges()} == {("A", "B"), ("B", "D")}
    assert set(g.arcs()) == {("B", "E"), ("C", "E"), ("E", "F"), ("C", "F"),
                             ("F", "G")}


# --------------------------------------------------------------------- MMPC
@pytest.mark.parametrize("name", ["chain", "independent", "discrete", "mixed"])
def test_mmpc_matches_jax(name):
    make, test, kw = PC_CASES[name]
    df = make()
    kw = {"alpha": 0.05, **kw}
    got = tpb.MMPC().estimate(getattr(tpb, test)(df), **kw)
    want = jpb.MMPC().estimate(getattr(jpb, test)(df), **kw)
    assert _pdag(got) == _pdag(want)


def test_mmpc_batched_equals_serial_path():
    lc = tpb.LinearCorrelation(normal_chain_data(2000))
    assert _pdag(tpb.MMPC().estimate(lc, alpha=0.05)) == _pdag(
        tpb.MMPC().estimate(_SerialOnly(lc), alpha=0.05))


# --------------------------------------------------------------------- MMHC
MMHC_CASES = {
    "gaussian-bic": (lambda: normal_chain_data(2000), "LinearCorrelation",
                     "GaussianNetworkType", "bic"),
    "spbn-validated": (lambda: normal_chain_data(400), "LinearCorrelation",
                       "SemiparametricBNType", "validated-lik"),
    "clg-bic": (lambda: mixed_data(1500), "MutualInformation",
                "CLGNetworkType", "bic"),
    "discrete-bde": (lambda: discrete_data(3000), "ChiSquare",
                     "DiscreteBNType", "bde"),
}


@pytest.mark.parametrize("name", list(MMHC_CASES))
def test_mmhc_matches_jax(name):
    make, test, bn_type, score = MMHC_CASES[name]
    df = make()
    models = [pkg.MMHC().estimate(getattr(pkg, test)(df),
                                  bn_type=getattr(pkg, bn_type)(),
                                  score=score, alpha=0.05, seed=0,
                                  patience=2)
              for pkg in (jpb, tpb)]
    assert type(models[1]).__module__.startswith("pybnesian_tpu_torch")
    assert _dag(models[1]) == _dag(models[0])
    if name == "gaussian-bic":
        skeleton = {frozenset(a) for a in models[1].arcs()}
        assert frozenset(("b", "d")) not in skeleton


# -------------------------------------------------------------------- DMMHC
def _ar_series(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    a, b = np.zeros(n), np.zeros(n)
    for t in range(1, n):
        a[t] = 0.8 * a[t - 1] + rng.normal(0, 0.5)
        b[t] = 0.7 * a[t - 1] + 0.2 * b[t - 1] + rng.normal(0, 0.5)
    return pd.DataFrame({"a": a, "b": b})


def _regime_series(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    s = np.zeros(n)
    regime = np.empty(n, object)
    regime[0] = "low"
    for t in range(1, n):
        regime[t] = ("high" if (s[t - 1] > 0.5) ^ (rng.random() < 0.1)
                     else "low")
        drift = 0.5 if regime[t] == "high" else -0.2
        s[t] = 0.7 * s[t - 1] + drift + rng.normal(0, 0.3)
    return pd.DataFrame({"regime": pd.Categorical(regime.tolist()), "s": s})


DMMHC_CASES = {
    "gaussian-bic": (_ar_series, "DynamicLinearCorrelation",
                     "GaussianNetworkType", "DynamicBIC", 1),
    "clg-bic": (_regime_series, "DynamicMutualInformation", "CLGNetworkType",
                "DynamicBIC", 1),
    "spbn-validated": (lambda: _ar_series(300), "DynamicLinearCorrelation",
                       "SemiparametricBNType", "DynamicValidatedLikelihood",
                       2),
}


@pytest.mark.parametrize("name", list(DMMHC_CASES))
def test_dmmhc_matches_jax(name):
    make, test, bn_type, score, order = DMMHC_CASES[name]
    df = make()
    models = []
    for pkg in (jpb, tpb):
        ddf = pkg.DynamicDataFrame(df, order)
        kw = {"seed": 0} if score == "DynamicValidatedLikelihood" else {}
        models.append(pkg.DMMHC().estimate(
            getattr(pkg, test)(ddf), bn_type=getattr(pkg, bn_type)(),
            markovian_order=order, score=getattr(pkg, score)(ddf, **kw),
            alpha=0.05, patience=2))
    want, got = models
    assert got.markovian_order() == order
    assert _dag(got.static_bn()) == _dag(want.static_bn())
    assert _dag(got.transition_bn()) == _dag(want.transition_bn())
    if name == "gaussian-bic":
        assert ("a_t_1", "a_t_0") in got.transition_bn().arcs()
        assert ("a_t_1", "b_t_0") in got.transition_bn().arcs()
    got.fit(tpb.DynamicDataFrame(df, order))
    want.fit(jpb.DynamicDataFrame(df, order))
    head = df.head(100)
    np.testing.assert_allclose(got.logl(head), want.logl(head), rtol=1e-9,
                               atol=1e-7)
    sample = got.sample(40, seed=0).to_pandas()
    assert list(sample.columns) == list(df.columns) and len(sample) == 40
