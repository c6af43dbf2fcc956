"""Greedy hill-climbing of a semiparametric network over a random DAG: the
torch port against the JAX package.

The frame is 500 rows of a 12-node, 16-arc network drawn by the rule of
the benchmark's 46-node configuration (``torch_dag.dag_data``). Cases:

- ``hc`` with ``ValidatedLikelihood(df, 0.2, 10, seed)`` and patience 5,
  and with ``CVLikelihood(df, 10, seed)`` (the loop's non-validated
  branch): the same operators in order with the same deltas, the same
  returned network and node types;
- one ``local_score_batch`` of CKDE families of widths 2 to 9, the widths
  such a network's search reaches, against the JAX package's float64
  scores (the float32 bits of each family alone and in that mixed batch
  are the card route's promise, held in ``test_torch_hc_dag_cuda.py``);
- the counter ``hc.operator_cells`` at the first scores: 12 x 11 arc cells
  and 12 nodes while a profiler records, nothing counted without one.

All of it on the CPU; deltas compared with rtol 1e-9 / atol 1e-7, as in
``test_torch_hillclimbing.py``.
"""

import functools

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import pybnesian_tpu as pj
import pybnesian_tpu_torch as pt
from pybnesian_tpu_torch import interop
from pybnesian_tpu_torch.runtime import tracing

from torch_dag import dag_data, dag_families
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

TOL = dict(rtol=1e-9, atol=1e-7)
NODES, SEED = 12, 3


def dag_frame(rows=500):
    return dag_data(NODES, 16, rows, SEED)


class Recorder:
    def __init__(self):
        self.steps = []

    def call(self, model, operator, score, iteration):
        self.steps.append((iteration, interop.operator_state(operator)))


SCORES = {
    "validated": lambda pkg, df: pkg.ValidatedLikelihood(df, 0.2, 10, SEED),
    "cv": lambda pkg, df: pkg.CVLikelihood(df, 10, SEED),
}


@functools.lru_cache(maxsize=None)
def _learn(score):
    df = dag_frame()
    out = {}
    for name, pkg in (("jax", pj), ("port", pt)):
        recorder = Recorder()
        model = pkg.hc(df, bn_type=pkg.SemiparametricBNType(),
                       score=SCORES[score](pkg, df), callback=recorder,
                       patience=5, seed=SEED)
        out[name] = (model, recorder.steps)
    return out


def _graph(model):
    return (sorted(model.arcs()),
            {n: model.node_type(n).ToString() for n in model.nodes()})


@pytest.mark.parametrize("score", list(SCORES))
def test_hc_on_a_dag_learns_the_jax_network(score):
    out = _learn(score)
    (jmodel, jsteps), (tmodel, tsteps) = out["jax"], out["port"]
    assert _graph(tmodel) == _graph(jmodel)
    assert [(i, s and s[:3]) for i, s in tsteps] == [
        (i, s and s[:3]) for i, s in jsteps]
    np.testing.assert_allclose([s[3] for _, s in tsteps if s],
                               [s[3] for _, s in jsteps if s], **TOL)
    # a search of this size: many arcs, and a node learned as CKDE
    assert len(tsteps) > 10 and tmodel.num_arcs() >= 10
    assert "CKDEFactor" in _graph(tmodel)[1].values()


def test_a_batch_of_widths_2_to_9_scores_as_the_jax_package():
    df = dag_frame()
    fams = dag_families(range(2, 10))
    got = pt.CVLikelihood(df, 10, SEED).local_score_batch(
        pt.KDENetwork(list(df.columns)),
        [(v, ps, pt.CKDEType()) for v, ps in fams])
    want = pj.CVLikelihood(df, 10, SEED).local_score_batch(
        pj.KDENetwork(list(df.columns)),
        [(v, ps, pj.CKDEType()) for v, ps in fams])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _seed_only(df):
    """``hc`` that stops after its first scores."""
    return pt.hc(df, bn_type=pt.SemiparametricBNType(),
                 score=pt.ValidatedLikelihood(df, 0.2, 10, SEED),
                 patience=5, max_iters=0)


def test_the_operator_cells_counted_at_the_first_scores():
    df = dag_frame(rows=200)
    tracing.reset_counters()
    _seed_only(df)
    assert "hc.operator_cells" not in tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _seed_only(df)
    assert tracing.counters()["hc.operator_cells"] == NODES * (NODES - 1) \
        + NODES
    tracing.reset_counters()


def test_a_removed_arcs_reverse_cell_is_rescored():
    """Removing x1 -> x5 changes only x5's family, and the cell (x5, x1)
    that held the arc's flip delta now holds the delta of adding x5 -> x1:
    after the update every cell is what a fresh cache gives."""
    df = dag_frame(rows=200)
    score = pt.CVLikelihood(df, 10, SEED)
    model = pt.GaussianNetwork(list(df.columns), [("x1", "x5"), ("x2", "x5")])
    arcs = pt.ArcOperatorSet()
    arcs.cache_scores(model, score)
    model.remove_arc("x1", "x5")
    arcs.update_scores(model, score, ["x5"])
    fresh = pt.ArcOperatorSet()
    fresh.cache_scores(model, score)
    np.testing.assert_allclose(arcs.delta, fresh.delta, rtol=0, atol=2e-9)


def test_after_a_removal_the_deltas_are_the_jax_packages_but_one():
    """The same removal in both packages: every cell the JAX package's
    update writes is the port's, to the float tolerances above, except
    the reverse cell (x5, x1). The JAX package leaves the removed arc's
    flip delta there; the port holds the delta of adding x5 -> x1."""
    df = dag_frame(rows=200)
    out = {}
    for name, pkg in (("jax", pj), ("port", pt)):
        score = pkg.CVLikelihood(df, 10, SEED)
        model = pkg.GaussianNetwork(list(df.columns),
                                    [("x1", "x5"), ("x2", "x5")])
        arcs = pkg.ArcOperatorSet()
        arcs.cache_scores(model, score)
        before = np.array(arcs.delta)
        model.remove_arc("x1", "x5")
        arcs.update_scores(model, score, ["x5"])
        out[name] = (before, np.array(arcs.delta), arcs)
    (jbefore, jdelta, jarcs), (tbefore, tdelta, tarcs) = out["jax"], \
        out["port"]
    stale = (tarcs._spos["x5"], tarcs._tpos["x1"])
    assert stale == (jarcs._spos["x5"], jarcs._tpos["x1"])
    others = np.ones(tdelta.shape, dtype=bool)
    others[stale] = False
    np.testing.assert_allclose(tbefore, jbefore, **TOL)
    np.testing.assert_allclose(tdelta[others], jdelta[others], **TOL)
    # the JAX package's reverse cell is the flip delta it held before
    assert jdelta[stale] == jbefore[stale]
    fresh = pt.ArcOperatorSet()
    fresh.cache_scores(model, pt.CVLikelihood(df, 10, SEED))
    assert abs(tdelta[stale] - jdelta[stale]) > 1e-3
    np.testing.assert_allclose(tdelta[stale], fresh.delta[stale],
                               rtol=0, atol=2e-9)
