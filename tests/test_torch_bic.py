"""BIC of the torch port against the JAX package's.

Linear-Gaussian families with 0–3 parents through the batched route
(``local_score_batch``) and the host route (``local_score``), a frame with
nulls, degenerate families (a constant column), and CLG
families (a discrete parent) on a frame with a categorical column; one
discrete family and the ``"bge"`` / ``"bde"`` score names (the discrete
scores proper are in test_torch_discrete_scores.py). Float64: rtol 1e-9 /
atol 1e-7.
"""

import numpy as np
import pandas as pd
import pytest

import pybnesian_tpu as pj
import pybnesian_tpu_torch as pt
from pybnesian_tpu_torch import interop
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


TOL = dict(rtol=1e-9, atol=1e-7)
ARCS = [("a", "b"), ("b", "c")]


def _frame(n=400, seed=0, nulls=False):
    rng = np.random.default_rng(seed)
    a = rng.normal(3.0, 0.7, n)
    b = 2.1 - 1.3 * a + rng.normal(0.0, 0.9, n)
    c = -0.4 + 0.5 * a + 1.1 * b + rng.normal(0.0, 0.6, n)
    d = 1.5 - 0.7 * c + rng.normal(0.0, 0.8, n)
    cols = dict(a=a, b=b, c=c, d=d)
    if nulls:
        for i, k in enumerate(cols):
            cols[k][rng.random(n) < 0.04 * (i + 1)] = np.nan
    cols["z"] = np.full(n, 2.0)
    return cols


FAMILIES = [("a", []), ("b", ["a"]), ("c", ["a", "b"]), ("d", ["a", "b", "c"]),
            ("a", ["d"]), ("d", ["c"]), ("c", ["d", "a"])]
DEGENERATE = [("z", []), ("a", ["z"])]


@pytest.mark.parametrize("nulls", [False, True])
def test_local_score_batch_matches_jax(nulls):
    cols = _frame(nulls=nulls)
    names = list(cols)
    jmodel = pj.GaussianNetwork(names, ARCS)
    tmodel = interop.network("GaussianNetwork", names, ARCS)
    fams = FAMILIES + DEGENERATE
    want = pj.BIC(cols).local_score_batch(jmodel, fams)
    got = pt.BIC(cols).local_score_batch(tmodel, fams)
    assert np.all(np.isfinite(got[: len(FAMILIES)]))
    # a constant variable is −inf; a constant parent makes the design
    # singular, which the Cholesky of both packages flags (−inf) or not
    # (a finite score) depending on rounding: the port follows JAX
    assert got[len(FAMILIES)] == -np.inf
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variable, parents", FAMILIES)
def test_local_score_matches_jax_and_the_batch(variable, parents):
    cols = _frame(nulls=True)
    names = list(cols)
    jmodel = pj.GaussianNetwork(names, ARCS)
    tmodel = interop.network("GaussianNetwork", names, ARCS)
    score = pt.BIC(cols)
    got = score.local_score(tmodel, variable, parents)
    np.testing.assert_allclose(
        got, pj.BIC(cols).local_score(jmodel, variable, parents), **TOL)
    np.testing.assert_allclose(
        got, score.local_score_batch(tmodel, [(variable, parents)])[0], **TOL)


def _mixed(n=300, seed=1):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, n)
    x = rng.normal(0, 1, n)
    y = np.array([-1.0, 0.5, 2.0])[g] + (0.3 + 0.4 * g) * x + rng.normal(
        0, 0.5, n)
    return pd.DataFrame({
        "g": pd.Categorical(np.array(["u", "v", "w"])[g]),
        "x": x,
        "y": y,
    })


@pytest.mark.parametrize("parents", [["g"], ["g", "x"]])
def test_clg_family_matches_jax(parents):
    df = _mixed()
    jmodel = pj.GaussianNetwork(["x", "y"])
    tmodel = interop.network("GaussianNetwork", ["x", "y"])
    lg_j, lg_t = pj.LinearGaussianCPDType(), pt.LinearGaussianCPDType()
    want = pj.BIC(df).local_score_node_type(jmodel, lg_j, "y", parents)
    score = pt.BIC(df)
    got = score.local_score_node_type(tmodel, lg_t, "y", parents)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, **TOL)
    batch = score.local_score_batch(tmodel, [("y", parents, lg_t),
                                             ("y", ["x"], lg_t)])
    np.testing.assert_allclose(batch[0], want, **TOL)
    np.testing.assert_allclose(
        batch[1],
        pj.BIC(df).local_score_node_type(jmodel, lg_j, "y", ["x"]), **TOL)


def test_discrete_families_are_not_ported():
    """(The name dates from when the discrete route raised.) The discrete
    count form is ported: it equals the JAX package's, by the node-type
    route and the batch."""
    df = _mixed()
    score = pt.BIC(df)
    model = interop.network("GaussianNetwork", ["x", "y"])
    jmodel = pj.GaussianNetwork(["x", "y"])
    dt = pt.DiscreteFactorType()
    want = pj.BIC(df).local_score_node_type(
        jmodel, pj.DiscreteFactorType(), "g", [])
    np.testing.assert_allclose(
        score.local_score_node_type(model, dt, "g", []), want, **TOL)
    np.testing.assert_allclose(
        score.local_score_batch(model, [("g", [], dt)]), [want], **TOL)
    # a discrete child of a continuous parent stays impossible, as in JAX
    assert score.local_score_node_type(model, dt, "g", ["x"]) == -np.inf


def test_bge_and_bde_are_not_ported():
    """(The name dates from when the two score names raised.) ``"bge"``
    learns the JAX package's graph; ``"bde"`` names a score that a
    Gaussian network is not compatible with, in both packages."""
    df = pd.DataFrame({k: v for k, v in _frame().items() if k != "z"})
    want = pj.hc(df, bn_type=pj.GaussianNetworkType(), score="bge")
    got = pt.hc(df, bn_type=pt.GaussianNetworkType(), score="bge")
    assert sorted(got.arcs()) == sorted(want.arcs()) and got.num_arcs() > 0
    for pkg in (pj, pt):
        with pytest.raises(ValueError):
            pkg.hc(df, bn_type=pkg.GaussianNetworkType(), score="bde")
