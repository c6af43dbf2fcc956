"""The operator sets of the torch port against the JAX package's.

A 4-node semiparametric network (two arcs, one CKDE node) scored with the
same CV likelihood in both packages: the arc and node-type delta matrices
after ``cache_scores``, the operator ``find_max`` and ``find_max_tabu``
choose, and the deltas again after that operator is applied and the
scores updated. Deltas are quantized at ``DELTA_RESOLUTION`` (1e-9) in
both packages; float64: rtol 1e-9 / atol 1e-7.
"""

import numpy as np
import pytest

import pybnesian_tpu as pj
import pybnesian_tpu_torch as pt
from pybnesian_tpu.learning import operators as jops
from pybnesian_tpu_torch import interop
from pybnesian_tpu_torch.learning import operators as tops
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


TOL = dict(rtol=1e-9, atol=1e-7)
NAMES = ["a", "b", "c", "d"]
ARCS = [("a", "b"), ("c", "b")]


def _columns(n=240, seed=2):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, n)
    c = rng.normal(0, 1, n)
    b = np.sin(1.5 * a) + 0.5 * c + rng.normal(0, 0.3, n)
    d = 0.8 * b + rng.normal(0, 0.5, n)
    return dict(a=a, b=b, c=c, d=d)


def _setup(kind):
    """(JAX model, port model, JAX score, port score, JAX operators, port
    operators) for an operator set of ``kind``."""
    cols = _columns()
    jmodel = pj.SemiparametricBN(NAMES, ARCS)
    for n in NAMES:
        jmodel.set_node_type(
            n, pj.CKDEType() if n == "b" else pj.LinearGaussianCPDType())
    tmodel = interop.network(
        "SemiparametricBN", NAMES, ARCS,
        {n: jmodel.node_type(n).ToString() for n in NAMES})
    jscore = pj.CVLikelihood(cols, k=3, seed=1)
    tscore = pt.CVLikelihood(cols, k=3, seed=1)
    if kind == "arcs":
        jset, tset = jops.ArcOperatorSet(), tops.ArcOperatorSet()
    elif kind == "node_type":
        jset, tset = jops.ChangeNodeTypeSet(), tops.ChangeNodeTypeSet()
    else:
        jset = jops.OperatorPool([jops.ArcOperatorSet(),
                                  jops.ChangeNodeTypeSet()])
        tset = tops.OperatorPool([tops.ArcOperatorSet(),
                                  tops.ChangeNodeTypeSet()])
    return jmodel, tmodel, jscore, tscore, jset, tset


def _members(op_set):
    return getattr(op_set, "_op_sets", [op_set])


def _assert_deltas_equal(jset, tset):
    for jm, tm in zip(_members(jset), _members(tset)):
        if isinstance(tm, tops.ArcOperatorSet):
            np.testing.assert_array_equal(tm.valid_op, jm.valid_op)
            np.testing.assert_allclose(tm.delta, jm.delta, **TOL)
            assert np.isfinite(tm.delta[tm.valid_op]).all()
        else:
            assert list(tm._deltas) == list(jm._deltas)
            for node in tm._deltas:
                got, want = tm._deltas[node], jm._deltas[node]
                assert [t.ToString() for t, _ in got] == [
                    t.ToString() for t, _ in want]
                np.testing.assert_allclose([d for _, d in got],
                                           [d for _, d in want], **TOL)


def _assert_same_operator(got, want):
    g, w = interop.operator_state(got), interop.operator_state(want)
    assert g is not None and g[:3] == w[:3]
    np.testing.assert_allclose(g[3], w[3], **TOL)


@pytest.mark.parametrize("kind", ["arcs", "node_type", "pool"])
def test_cached_deltas_match_jax(kind):
    jmodel, tmodel, jscore, tscore, jset, tset = _setup(kind)
    jset.cache_scores(jmodel, jscore)
    tset.cache_scores(tmodel, tscore)
    _assert_deltas_equal(jset, tset)


@pytest.mark.parametrize("kind", ["arcs", "node_type", "pool"])
def test_find_max_and_tabu_match_jax(kind):
    jmodel, tmodel, jscore, tscore, jset, tset = _setup(kind)
    jset.cache_scores(jmodel, jscore)
    tset.cache_scores(tmodel, tscore)
    want = jset.find_max(jmodel)
    got = tset.find_max(tmodel)
    _assert_same_operator(got, want)
    # tabu the best operator: both packages move on to the same second one
    jtabu, ttabu = jops.OperatorTabuSet(), tops.OperatorTabuSet()
    jtabu.insert(want)
    ttabu.insert(got)
    _assert_same_operator(tset.find_max_tabu(tmodel, ttabu),
                          jset.find_max_tabu(jmodel, jtabu))


@pytest.mark.parametrize("kind", ["arcs", "node_type", "pool"])
def test_deltas_after_apply_and_update_match_jax(kind):
    jmodel, tmodel, jscore, tscore, jset, tset = _setup(kind)
    jset.cache_scores(jmodel, jscore)
    tset.cache_scores(tmodel, tscore)
    for _ in range(2):
        jop, top = jset.find_max(jmodel), tset.find_max(tmodel)
        _assert_same_operator(top, jop)
        jop.apply(jmodel)
        top.apply(tmodel)
        jset.update_scores(jmodel, jscore, jop.nodes_changed(jmodel))
        tset.update_scores(tmodel, tscore, top.nodes_changed(tmodel))
        assert sorted(tmodel.arcs()) == sorted(jmodel.arcs())
        _assert_deltas_equal(jset, tset)


def test_operator_surface_matches_jax():
    ops = [(jops.AddArc("a", "b", 1.5), tops.AddArc("a", "b", 1.5)),
           (jops.RemoveArc("a", "b", -2.0), tops.RemoveArc("a", "b", -2.0)),
           (jops.FlipArc("c", "b", 0.25), tops.FlipArc("c", "b", 0.25)),
           (jops.ChangeNodeType("b", pj.CKDEType(), 3.0),
            tops.ChangeNodeType("b", pt.CKDEType(), 3.0))]
    jmodel = pj.SemiparametricBN(NAMES, ARCS)
    tmodel = interop.network("SemiparametricBN", NAMES, ARCS)
    for jop, top in ops:
        assert top.ToString() == jop.ToString()
        assert interop.operator_state(top) == interop.operator_state(jop)
        assert (interop.operator_state(top.opposite(tmodel))
                == interop.operator_state(jop.opposite(jmodel)))
        assert top.nodes_changed(tmodel) == jop.nodes_changed(jmodel)
    assert tops.DELTA_RESOLUTION == jops.DELTA_RESOLUTION == 1e-9
