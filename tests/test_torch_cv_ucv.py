"""CV scores of CKDE families with UCV-selected and user-selected
bandwidths, the torch port against the JAX package.

The cases of tests/learning/test_ucv_batched_cv.py and
tests/factors/test_ucv.py, each run in both packages on the same float64
frame, folds and graph, on the CPU:

- given the SAME per-fold bandwidths, the port's fused scoring path equals
  the JAX package's host-whitened one, rtol 1e-9 (the port permutes each
  bandwidth to evidence-first order and takes one Cholesky, the JAX
  package whitens joint and marginal apart);
- end to end (search, then score) rtol 1e-5;
- a batch equals its families scored one by one, and a batch that mixes
  rule, UCV and custom-selector families equals the three scored apart,
  rtol 1e-9;
- nulls are dropped per family, a degenerate family is −inf;
- a user-defined selector;
- a float32 batch (its searches' starts and rows formed by ``ucv_starts``,
  the searches in float32) against the JAX package's float64 scores on the
  same values and folds, rtol 5e-4 / atol 5e-3.

The holdout and validated scores and ``hc`` with UCV arguments are in
tests/test_torch_cv_ucv_hc.py.
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


def _random_h_maps(fams, K, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _v, ps in fams:
        dj = len(ps) + 1
        hs = []
        for _ in range(K):
            A = rng.normal(size=(dj, dj)) * 0.3 + np.eye(dj) * 0.6
            hs.append(A @ A.T)
        out.append(hs)
    return out


@pytest.mark.parametrize("nulls", [False, True], ids=["full", "nulls"])
def test_given_the_same_bandwidths_scores_match(nulls):
    df = normal_chain_data(180)
    if nulls:
        df.loc[np.arange(0, 180, 7), "b"] = np.nan
        df.loc[np.arange(3, 180, 11), "c"] = np.nan
    jscore, tscore = _scores(df)
    fams = [(v, ps, None) for v, ps in FAMS]
    h_maps = _random_h_maps(FAMS, 3)
    want = jscore._engine._ckde_host_batch(fams, 256, h_maps=h_maps)
    got = tscore._engine._ckde_host_batch(fams, h_maps=h_maps)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert np.all(np.isfinite(got))


def test_a_singular_fold_makes_the_family_minus_inf():
    df = normal_chain_data(120)
    _, tscore = _scores(df)
    h_maps = _random_h_maps(FAMS, 3)
    h_maps[2][1] = np.zeros((3, 3))              # family c, fold 1
    h_maps[1][0] = np.array([[1.0, 2.0], [2.0, 1.0]])   # indefinite
    got = tscore._engine._ckde_host_batch(
        [(v, ps, None) for v, ps in FAMS], h_maps=h_maps)
    assert got[1] == -math.inf and got[2] == -math.inf
    assert np.isfinite(got[0]) and np.isfinite(got[3])


def test_end_to_end_matches_jax_and_batch_equals_singles():
    df = normal_chain_data(120)
    jscore, tscore = _scores(df)
    jmodel, tmodel = _models()
    fams = [(v, ps, None) for v, ps in FAMS[:3]]
    want = jscore.local_score_batch(jmodel, fams)
    got = tscore.local_score_batch(tmodel, fams)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    singles = np.array([tscore.local_score(tmodel, v, ps)
                        for v, ps, _ in fams])
    np.testing.assert_allclose(got, singles, rtol=1e-9)
    # UCV picked other bandwidths than the normal-reference rule
    nr = pt.CVLikelihood(df, k=3, seed=0).local_score_batch(tmodel, fams)
    assert np.all(got != nr)


def test_one_batched_search_per_family_width():
    df = normal_chain_data(100)
    args = pt.Arguments({v: pt.Kwargs(bandwidth_selector=pt.UCV())
                         for v in NODES})
    score = pt.CVLikelihood(df, k=2, seed=0, construction_args=args)
    h_maps, searches = score._engine._ucv_bandwidths(
        [("a", [], None), ("b", ["a"], None), ("c", ["b"], None)])
    assert sorted(h_maps) == [0, 1, 2]
    assert [h_maps[i][0].shape for i in range(3)] == [(1, 1), (2, 2), (2, 2)]
    # 1 family x 2 folds of one column, then 2 x 2 of two
    assert [s.x.shape for s in searches] == [(2, 1), (4, 3)]
    assert all(len(s.iterations) == len(s.x) and s.evaluations > 0
               for s in searches)


def test_matches_serial_factor_fits():
    """The batched search against a CKDE fitted per fold (reference
    cv_likelihood.cpp:11-25 with kde/UCV.cpp selection)."""
    df = normal_chain_data(150)
    _, tscore = _scores(df)
    _, tmodel = _models()
    got = tscore.local_score(tmodel, "b", ["a", "c"])
    ref = 0.0
    for i in range(3):
        tr, te = tscore.cv.fold_indices(i)
        f = pt.CKDE("b", ["a", "c"], bandwidth_selector=pt.UCV())
        f.fit(tscore.df.take(tr))
        ref += f.slogl(tscore.df.take(te))
    np.testing.assert_allclose(got, ref, rtol=5e-3)


def test_nulls_and_a_degenerate_family():
    df = normal_chain_data(180)
    df.loc[np.arange(0, 180, 7), "b"] = np.nan
    df["z"] = 0.0
    nodes = NODES + ["z"]
    jscore, tscore = _scores(df, nodes=nodes)
    jmodel, tmodel = _models(nodes)
    fams = [("b", ["a"], None), ("z", [], None), ("a", ["z"], None)]
    want = jscore.local_score_batch(jmodel, fams)
    got = tscore.local_score_batch(tmodel, fams)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert np.isfinite(got[0])
    assert got[1] == want[1] == -math.inf
    assert got[2] == want[2] == -math.inf


def test_a_float32_batch_agrees_with_float64():
    """The tolerance of test_torch_cvlikelihood.py's float32 cases. The
    searches of the two packages stop at other points of a flat objective:
    at 203 rows and 5 folds even the port's float64 scores lie up to 9e-4
    from the JAX package's, at 400 rows and 4 folds within 1e-4 (float32
    within 9e-5)."""
    df = normal_chain_data(400)
    jscore, _ = _scores(df, k=4)
    folds = [jscore.cv.fold_indices(i) for i in range(4)]
    tscore = interop.cv_likelihood(
        {c: df[c].to_numpy(np.float32) for c in NODES}, folds,
        construction_args=_args(pt, pt.UCV), device="cpu")
    jmodel, tmodel = _models()
    fams = [(v, ps, None) for v, ps in
            [*FAMS, ("c", ["b"]), ("b", ["c", "d"]), ("d", ["a"]),
             ("a", ["b"])]]
    want = jscore.local_score_batch(jmodel, fams)
    got = tscore.local_score_batch(tmodel, fams)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-3)
    assert np.all(np.isfinite(got))


def _half_covariance(pkg):
    class HalfCovariance(pkg.BandwidthSelector):
        """A user's selector: a scaled covariance of the fold's rows."""

        calls = []

        def bandwidth(self, df, variables):
            self.calls.append((len(df), list(variables)))
            return 0.5 * np.atleast_2d(df.cov(list(variables)))

    return HalfCovariance


def test_custom_selector_matches_jax():
    df = normal_chain_data(200)
    JSel, TSel = _half_covariance(pj), _half_covariance(pt)
    jscore = pj.CVLikelihood(df, k=3, seed=0,
                             construction_args=_args(pj, JSel))
    tscore = pt.CVLikelihood(df, k=3, seed=0,
                             construction_args=_args(pt, TSel))
    jmodel, tmodel = _models()
    fams = [(v, ps, None) for v, ps in FAMS]
    want = jscore.local_score_batch(jmodel, fams)
    got = tscore.local_score_batch(tmodel, fams)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    # one call per fold and family, on the fold's rows, variable first
    assert len(TSel.calls) == 3 * len(FAMS)
    assert TSel.calls == JSel.calls
    assert TSel.calls[-1][1] == ["d", "c"]


def test_mixed_batch_equals_the_three_scored_apart():
    df = normal_chain_data(160)
    Half = _half_covariance(pt)
    args = pt.Arguments({
        "a": pt.Kwargs(bandwidth_selector=pt.UCV()),
        "b": pt.Kwargs(bandwidth_selector=Half()),
        "c": pt.Kwargs(bandwidth_selector=pt.ScottsBandwidth()),
    })                                   # d: the normal-reference default
    score = pt.CVLikelihood(df, k=3, seed=0, construction_args=args)
    _, model = _models()
    fams = [("c", ["a", "b"], None), ("a", ["b"], None), ("b", ["a"], None),
            ("d", ["c"], None), ("a", [], None), ("b", ["c", "d"], None)]
    mixed = score.local_score_batch(model, fams)
    assert np.all(np.isfinite(mixed))
    by_node = {}
    for v in "abcd":
        idx = [i for i, f in enumerate(fams) if f[0] == v]
        by_node[v] = (idx, score.local_score_batch(
            model, [fams[i] for i in idx]))
    for idx, apart in by_node.values():
        np.testing.assert_allclose(mixed[idx], apart, rtol=1e-9)
    # and each kind is what its selector alone gives
    ucv_only = pt.CVLikelihood(
        df, k=3, seed=0, construction_args=_args(pt, pt.UCV))
    np.testing.assert_allclose(
        mixed[[1, 4]],
        ucv_only.local_score_batch(model, [fams[1], fams[4]]), rtol=1e-9)
    nr_only = pt.CVLikelihood(df, k=3, seed=0)
    np.testing.assert_allclose(
        mixed[3], nr_only.local_score(model, "d", ["c"]), rtol=1e-9)
