"""Holdout and validated scores, and ``hc``, over CKDE families with
UCV-selected bandwidths: the torch port against the JAX package.

The second half of tests/test_torch_cv_ucv.py's cases (a file of its own so
that the two halves run side by side): ``HoldoutLikelihood`` and both
channels of ``ValidatedLikelihood`` with UCV arguments against the JAX
package's, rtol 1e-5, and against a serially fitted factor; and ``hc`` on a
small KDENetwork with UCV arguments taking the JAX package's steps. Float64
on the CPU.
"""

import math

import numpy as np
import pytest

import pybnesian_tpu as pj
import pybnesian_tpu_torch as pt
from pybnesian_tpu_torch import interop

from data_gen import normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

NODES = ["a", "b", "c", "d"]
FAMS = [("a", []), ("b", ["a"]), ("c", ["a", "b"]), ("d", ["c"])]


def _args(pkg, selector, nodes=NODES):
    return pkg.Arguments({v: pkg.Kwargs(bandwidth_selector=selector())
                          for v in nodes})


def _scores(df, k=3, seed=0, nodes=NODES):
    """CVLikelihood of both packages with UCV on every node."""
    return (pj.CVLikelihood(df, k=k, seed=seed,
                            construction_args=_args(pj, pj.UCV, nodes)),
            pt.CVLikelihood(df, k=k, seed=seed,
                            construction_args=_args(pt, pt.UCV, nodes)))


def _models(nodes=NODES):
    return pj.KDENetwork(nodes), pt.KDENetwork(nodes)


@pytest.mark.parametrize("fam", [("b", ["a"]), ("b", [])],
                         ids=["one-parent", "no-parent"])
def test_holdout_matches_jax(fam):
    df = normal_chain_data(200)
    v, ps = fam
    jscore = pj.HoldoutLikelihood(
        df, test_ratio=0.3, seed=0, construction_args=_args(pj, pj.UCV))
    tscore = pt.HoldoutLikelihood(
        df, test_ratio=0.3, seed=0, construction_args=_args(pt, pt.UCV))
    jmodel, tmodel = _models()
    want = jscore.local_score_batch(jmodel, [(v, ps, None)])[0]
    got = tscore.local_score_batch(tmodel, [(v, ps, None)])[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the serial route fits one CKDE on the training split
    f = pt.CKDE(v, ps, bandwidth_selector=pt.UCV())
    f.fit(tscore.training_data())
    np.testing.assert_allclose(got, f.slogl(tscore.test_data()), rtol=5e-3)
    np.testing.assert_allclose(tscore.local_score(tmodel, v, ps), got,
                               rtol=5e-3)


def test_validated_likelihood_takes_ucv_on_both_channels():
    df = normal_chain_data(150)
    jscore = pj.ValidatedLikelihood(
        df, test_ratio=0.25, k=3, seed=1,
        construction_args=_args(pj, pj.UCV))
    tscore = pt.ValidatedLikelihood(
        df, test_ratio=0.25, k=3, seed=1,
        construction_args=_args(pt, pt.UCV))
    jmodel, tmodel = _models()
    fams = [("b", ["a"], None), ("c", [], None)]
    np.testing.assert_allclose(tscore.local_score_batch(tmodel, fams),
                               jscore.local_score_batch(jmodel, fams),
                               rtol=1e-5)
    np.testing.assert_allclose(tscore.vlocal_score_batch(tmodel, fams),
                               jscore.vlocal_score_batch(jmodel, fams),
                               rtol=1e-5)


class _Recorder:
    def __init__(self):
        self.steps = []

    def call(self, model, operator, score, iteration):
        self.steps.append((iteration, interop.operator_state(operator)))


def test_hc_kdenetwork_with_ucv_arguments_takes_the_jax_steps():
    df = normal_chain_data(90)[["a", "b"]]
    nodes = ["a", "b"]
    out = {}
    for name, pkg in (("jax", pj), ("port", pt)):
        score = pkg.CVLikelihood(df, k=2, seed=0,
                                 construction_args=_args(pkg, pkg.UCV, nodes))
        rec = _Recorder()
        model = pkg.GreedyHillClimbing().estimate(
            pkg.ArcOperatorSet(), score, pkg.KDENetwork(nodes),
            callback=rec, max_iters=1)
        out[name] = (sorted(model.arcs()), rec.steps)
    (jarcs, jsteps), (tarcs, tsteps) = out["jax"], out["port"]
    assert tarcs == jarcs and len(tarcs) == 1
    assert [(i, s and s[:3]) for i, s in tsteps] == [
        (i, s and s[:3]) for i, s in jsteps]
    np.testing.assert_allclose([s[3] for _, s in tsteps if s],
                               [s[3] for _, s in jsteps if s], rtol=1e-4)
