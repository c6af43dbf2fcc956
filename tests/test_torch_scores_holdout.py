"""HoldoutLikelihood and ValidatedLikelihood of the torch port against the
JAX package's.

Both packages split the same frame from the same seed (the split code is
the same, numpy's RNG); the tests first hold the split indices equal, then
score the same families on the same graph. Linear-Gaussian (LG) and CKDE
families with 0–2 parents; the constant column ``z`` gives degenerate
families whose score is −inf in both packages; a frame with nulls in every
column checks the null handling of both channels. Float64: rtol 1e-9 /
atol 1e-7.
"""

import numpy as np
import pytest

import pybnesian_tpu as pj
from pybnesian_tpu.learning.scores import likelihood as jlik
from pybnesian_tpu_torch import CKDEType, LinearGaussianCPDType, interop
from pybnesian_tpu_torch.learning.scores import likelihood as tlik
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


TOL = dict(rtol=1e-9, atol=1e-7)
ARCS = [("x0", "x1"), ("x1", "x2"), ("x0", "x2")]


def _columns(n=300, seed=0, nulls=False):
    rng = np.random.default_rng(seed)
    cols = {}
    prev = rng.normal(0, 1, n)
    for i in range(4):
        prev = np.sin(0.8 * prev) + 0.5 * prev + rng.normal(0, 0.6, n)
        cols[f"x{i}"] = prev
    if nulls:
        for i, c in enumerate(cols):
            cols[c][rng.random(n) < 0.03 * (i + 1)] = np.nan
    cols["z"] = np.zeros(n)
    return cols


def _families():
    fams = []
    for v, ps in [("x0", []), ("x1", ["x0"]), ("x2", ["x0", "x1"]),
                  ("x3", ["x2"]), ("x3", ["x1", "x2"])]:
        fams += [(v, ps, "LinearGaussianFactor"), (v, ps, "CKDEFactor")]
    # degenerate: a constant variable, and a constant parent
    fams += [("z", [], "LinearGaussianFactor"), ("z", [], "CKDEFactor"),
             ("x1", ["z"], "LinearGaussianFactor"), ("x1", ["z"], "CKDEFactor")]
    return fams


def _both(cols, seed=3):
    """(JAX score, port score, JAX network, port network) of
    ValidatedLikelihood over ``cols`` with 4 folds, on an SPBN with
    ``ARCS``, x1 CKDE."""
    names = list(cols)
    jscore = jlik.ValidatedLikelihood(cols, test_ratio=0.25, k=4, seed=seed)
    tscore = tlik.ValidatedLikelihood(cols, test_ratio=0.25, k=4, seed=seed)
    jmodel = pj.SemiparametricBN(names, ARCS)
    jmodel.set_node_type("x1", pj.CKDEType())
    tmodel = interop.network("SemiparametricBN", names, ARCS,
                             {"x1": "CKDEFactor"})
    return jscore, tscore, jmodel, tmodel


def _typed(fams, jax):
    if jax:
        types = {"LinearGaussianFactor": pj.LinearGaussianCPDType(),
                 "CKDEFactor": pj.CKDEType()}
    else:
        types = {"LinearGaussianFactor": LinearGaussianCPDType(),
                 "CKDEFactor": CKDEType()}
    return [(v, ps, types[t]) for v, ps, t in fams]


@pytest.mark.parametrize("nulls", [False, True])
def test_splits_equal_jax(nulls):
    cols = _columns(nulls=nulls)
    jscore, tscore, _, _ = _both(cols)
    jh, th = jscore.holdout_lik.holdout, tscore.holdout_lik.holdout
    np.testing.assert_array_equal(th._train_idx, jh._train_idx)
    np.testing.assert_array_equal(th._test_idx, jh._test_idx)
    for i in range(4):
        for got, want in zip(tscore.cv_lik.cv.fold_indices(i),
                             jscore.cv_lik.cv.fold_indices(i)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channel", ["holdout", "cv", "validation"])
@pytest.mark.parametrize("nulls", [False, True])
def test_local_score_batch_matches_jax(channel, nulls):
    cols = _columns(nulls=nulls)
    jscore, tscore, jmodel, tmodel = _both(cols)
    fams = _families()
    if channel == "holdout":
        want = jscore.holdout_lik.local_score_batch(jmodel, _typed(fams, True))
        got = tscore.holdout_lik.local_score_batch(tmodel, _typed(fams, False))
    elif channel == "cv":
        want = jscore.local_score_batch(jmodel, _typed(fams, True))
        got = tscore.local_score_batch(tmodel, _typed(fams, False))
    else:
        want = jscore.vlocal_score_batch(jmodel, _typed(fams, True))
        got = tscore.vlocal_score_batch(tmodel, _typed(fams, False))
    assert np.all(np.isneginf(got[-4:])) and np.all(np.isneginf(want[-4:]))
    assert np.all(np.isfinite(got[:-4]))
    np.testing.assert_allclose(got, want, **TOL)


def test_untyped_families_take_the_model_types():
    cols = _columns()
    jscore, tscore, jmodel, tmodel = _both(cols)
    fams = [(v, ps) for v, ps, _ in _families()[::2]]
    np.testing.assert_allclose(tscore.vlocal_score_batch(tmodel, fams),
                               jscore.vlocal_score_batch(jmodel, fams), **TOL)
    np.testing.assert_allclose(tscore.local_score_batch(tmodel, fams),
                               jscore.local_score_batch(jmodel, fams), **TOL)


@pytest.mark.parametrize("node", ["x0", "x1", "x2", "x3", "z"])
def test_vlocal_score_matches_jax(node):
    """The validation update of one node: factor fit on the holdout's
    training part, slogl on its test part. For the constant node z both
    packages' linear-Gaussian factors fit a zero variance and their slogl
    gives 0.0 (the batched route gives −inf): the port keeps the
    reference's value."""
    cols = _columns()
    jscore, tscore, jmodel, tmodel = _both(cols)
    want = jscore.vlocal_score(jmodel, node)
    with np.errstate(divide="ignore", invalid="ignore"):
        got = tscore.vlocal_score(tmodel, node)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("node", ["x1", "x2"])
def test_vlocal_score_agrees_with_the_holdout_batch(node):
    """The two routes of the validation channel — the batched holdout
    engine and the fitted factor — give the same score."""
    cols = _columns()
    _, tscore, _, tmodel = _both(cols)
    batch = tscore.vlocal_score_batch(tmodel, [(node, tmodel.parents(node))])
    np.testing.assert_allclose(tscore.vlocal_score(tmodel, node), batch[0],
                               **TOL)


def test_holdout_likelihood_alone_matches_jax():
    cols = _columns(n=250, seed=4)
    jscore = jlik.HoldoutLikelihood(cols, test_ratio=0.3, seed=1)
    tscore = tlik.HoldoutLikelihood(cols, test_ratio=0.3, seed=1)
    names = list(cols)
    jmodel = pj.KDENetwork(names, ARCS)
    tmodel = interop.network("KDENetwork", names, ARCS)
    fams = [(v, ps) for v, ps, _ in _families()[1::2]]
    np.testing.assert_allclose(tscore.local_score_batch(tmodel, fams),
                               jscore.local_score_batch(jmodel, fams), **TOL)
    assert tscore.ToString() == jscore.ToString() == "HoldoutLikelihood"


DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32],
                                 ids=["f64", "f32"])


@DTYPES
def test_validation_cache_holds_vlocal_score(dtype):
    """The validation cache that hc seeds (``cache_vlocal_scores``) holds
    the hold-out batch's values (``vlocal_score_batch``) bit for bit for
    the continuous nodes, in both dtypes; for the constant node z, whose
    batch value is −inf, the fitted factor's 0.0 (``vlocal_score``)."""
    from pybnesian_tpu_torch.learning.operators import LocalScoreCache

    cols = {k: v.astype(dtype) for k, v in _columns().items()}
    _, tscore, _, tmodel = _both(cols)
    nodes = tmodel.nodes()
    cache = LocalScoreCache()
    with np.errstate(divide="ignore", invalid="ignore"):
        cache.cache_vlocal_scores(tmodel, tscore)
        batch = tscore.vlocal_score_batch(
            tmodel, [(n, tmodel.parents(n)) for n in nodes]).tolist()
        fitted_z = tscore.vlocal_score(tmodel, "z")
    got = {n: cache.local_score(tmodel, n) for n in nodes}
    assert {n: v for n, v in got.items() if n != "z"} == {
        n: v for n, v in zip(nodes, batch) if n != "z"}
    assert batch[nodes.index("z")] == -np.inf
    assert got["z"] == fitted_z == 0.0
    assert np.all(np.isfinite(list(got.values())))


@DTYPES
def test_validation_update_equals_the_seed(dtype):
    """``update_vlocal_scores`` gives a changed family, in a batch of its
    own, the bits that seeding a cache on the changed network gives it in
    the batch of every node; the constant node z keeps the fitted 0.0."""
    from pybnesian_tpu_torch.learning.operators import LocalScoreCache

    cols = {k: v.astype(dtype) for k, v in _columns().items()}
    _, tscore, _, tmodel = _both(cols)
    changed = interop.network("SemiparametricBN", list(cols),
                              ARCS + [("x2", "x3")],
                              {"x1": "CKDEFactor", "x3": "CKDEFactor"})
    updated, seeded = LocalScoreCache(), LocalScoreCache()
    with np.errstate(divide="ignore", invalid="ignore"):
        updated.cache_vlocal_scores(tmodel, tscore)
        before = updated.local_score(tmodel, "x3")
        tmodel.add_arc("x2", "x3")
        tmodel.set_node_type("x3", CKDEType())
        updated.update_vlocal_scores(tmodel, tscore, ["x3", "z"])
        seeded.cache_vlocal_scores(changed, tscore)
    assert updated.local_score(tmodel, "x3") != before
    for n in changed.nodes():
        assert updated.local_score(tmodel, n) == seeded.local_score(changed, n)
    assert updated.local_score(tmodel, "z") == 0.0
