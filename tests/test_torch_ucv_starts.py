"""The UCV searches' starts and padded rows of a CV score, formed where the
frame lives (``ops/cv_whiten_kernel.py``: ``ucv_starts`` and its plain
version ``ucv_starts_reference``), against the host route they replace:
per (family, fold) ``_fold_trains``, ``np.cov`` and ``np.linalg.cholesky``
for the normal-reference start, then the padded block the search took.

On the CPU (the kernel ``ucv_starts_f32`` is held to the plain version on
the card in ``tests/test_torch_cv_whiten_cuda.py``):

- the starts within rtol 1e-9 / atol 1e-7 of the host's (float64 sums in
  another order), at widths 1, 2 and 3, float32 and float64 frames, with
  and without nulls;
- the compacted rows, the mask and the row counts equal to the host's
  block exactly (rows past the host's widest problem are zeros);
- a fold with too few rows and a constant column give ``ok`` 0 and a NaN
  start where the host route left the family out, and the family scores
  −inf; every fold of such a family starts its search from NaN, and the
  search counters count the families kept alone;
- the search's result from device starts equals the one from the same
  starts given as a host array.
"""

import math

import numpy as np
import pytest
import torch

import pybnesian_tpu_torch as pt
from pybnesian_tpu_torch.kde import ucv
from pybnesian_tpu_torch.kde.ucv import vech
from pybnesian_tpu_torch.learning.scores import likelihood
from pybnesian_tpu_torch.ops import cv_whiten_kernel as cvw
from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
    ucv_starts, ucv_starts_reference)

from data_gen import normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

FAMILIES = {1: [("a", []), ("c", [])],
            2: [("b", ["a"]), ("d", ["c"]), ("a", ["d"])],
            3: [("c", ["a", "b"]), ("b", ["d", "a"])]}
TOL = dict(rtol=1e-9, atol=1e-7)


def host_route(engine, fams):
    """Per family, None where the host route left it out, else (the K
    fold's train rows, (K, nv) starts): ``_fold_trains``, then
    vech(chol(k·np.cov)) per fold, as the score formed them on the host."""
    out = []
    for v, ps in fams:
        trains = engine._fold_trains(v, ps)
        if trains is None:
            out.append(None)
            continue
        dj = len(ps) + 1
        starts = []
        for _rows, train in trains:
            n_k = len(train)
            knr = (4.0 / (n_k * (dj + 2.0))) ** (2.0 / (dj + 4.0))
            H0 = knr * np.cov(train, rowvar=False, ddof=1).reshape(dj, dj)
            try:
                starts.append(vech(np.linalg.cholesky(H0)))
            except np.linalg.LinAlgError:
                starts = None
                break
        out.append(None if starts is None
                   else ([t for _r, t in trains], np.array(starts)))
    return out


def host_block(entries):
    """The host's padded block of the kept families: (Xpad, validm, Ns)."""
    npad = max(len(t) for trains, _s in entries for t in trains)
    dj = entries[0][0][0].shape[1]
    rows = [t for trains, _s in entries for t in trains]
    Xpad = np.zeros((len(rows), npad, dj))
    validm = np.zeros((len(rows), npad))
    for b, t in enumerate(rows):
        Xpad[b, : len(t)] = t
        validm[b, : len(t)] = 1.0
    return Xpad, validm, np.array([len(t) for t in rows], np.float64)


def engine_of(df, k, seed=1):
    """A CV engine over ``k`` folds of all of ``df``'s rows, null rows
    included (a ``CVLikelihood`` drops rows with a null from its folds), so
    each family drops its own: the folds of ``interop.cv_likelihood``."""
    rows = np.random.default_rng(seed).permutation(len(df))
    folds = [(np.sort(np.setdiff1d(rows, te)), np.sort(te))
             for te in np.array_split(rows, k)]
    return likelihood._KFoldEngine(pt.DataFrame.wrap(df), folds,
                                   torch.device("cpu"))


def device_route(engine, fams):
    """``ucv_starts_reference`` on the score's own device tensors."""
    pos, data, null_mask, tr_idx, tr_mask, _te, _tm = (
        engine._device_cv_cache())
    cols = torch.tensor([[pos[c] for c in (v, *ps)] for v, ps in fams])
    return ucv_starts_reference(data, null_mask, cols, tr_idx, tr_mask)


def frame(dtype, nulls, n=157):
    df = normal_chain_data(n, dtype=dtype)
    if nulls:
        df.loc[np.arange(2, n, 5), "b"] = np.nan
    return df


def _as_host(t):
    return t.to(torch.float64).numpy()


@pytest.mark.parametrize("nulls", [False, True], ids=["full", "nulls"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_the_starts_and_rows_are_the_host_routes(d, dtype, nulls):
    engine = engine_of(frame(dtype, nulls), 4)
    fams = FAMILIES[d]
    want = host_route(engine, fams)
    assert all(w is not None for w in want)
    X, valid, Ns, starts, ok = device_route(engine, fams)
    K = len(engine.folds)
    assert X.dtype == valid.dtype == Ns.dtype == ok.dtype == getattr(
        torch, dtype)
    assert starts.dtype == torch.float64
    np.testing.assert_allclose(
        starts.numpy(), np.concatenate([s for _t, s in want]), **TOL)
    assert np.all(_as_host(ok) == 1.0)
    Xpad, validm, want_ns = host_block(want)
    npad = Xpad.shape[1]
    # the host packed float64 rows that the search then cast to its dtype
    np.testing.assert_array_equal(
        _as_host(X[:, :npad]), Xpad.astype(dtype).astype(np.float64))
    np.testing.assert_array_equal(_as_host(valid[:, :npad]), validm)
    np.testing.assert_array_equal(_as_host(Ns), want_ns)
    assert not X[:, npad:].any() and not valid[:, npad:].any()
    assert X.shape == (len(fams) * K, engine._device_cv_cache()[3].shape[1],
                       d)
    # nulls in "b" drop rows: where every family has it, the block is
    # wider than its widest problem
    uses_b = all("b" in (v, *ps) for v, ps in fams)
    assert (npad < X.shape[1]) == (nulls and uses_b)


def test_a_fold_with_too_few_rows_has_no_start():
    n, k = 40, 4
    df = normal_chain_data(n)
    tests = [te for _tr, te in engine_of(df, k).folds]
    # "c" counts on 5 rows: 3 in fold 0's test rows, so its train rows
    # hold 2, fewer than a family of 2 or 3 columns needs
    keep = [*tests[0][:3], *tests[1][:1], *tests[2][:1]]
    df.loc[np.setdiff1d(np.arange(n), keep), "c"] = np.nan
    engine = engine_of(df, k)
    fams = [("c", ["a"]), ("b", ["a"]), ("c", ["a", "b"])]
    want = host_route(engine, fams)
    assert want[0] is None and want[1] is not None and want[2] is None
    _X, _valid, Ns, starts, ok = device_route(engine, fams[:2])
    ok = _as_host(ok).reshape(2, k)
    starts = starts.numpy().reshape(2, k, -1)
    assert ok[0, 0] == 0.0 and np.all(np.isnan(starts[0, 0]))
    assert _as_host(Ns).reshape(2, k)[0, 0] == 2.0
    assert np.all(ok[1] == 1.0)
    np.testing.assert_allclose(starts[1], want[1][1], **TOL)
    _X, _valid, Ns, starts, ok = device_route(engine, fams[2:])
    assert _as_host(ok)[0] == 0.0 and np.all(np.isnan(starts[0].numpy()))
    assert _as_host(Ns)[0] == 2.0


def test_a_family_with_one_fold_of_no_start_searches_none_of_its_folds():
    """Its good folds' lanes start from NaN too: they end at once, the
    family is left out, and the counters count the kept family alone."""
    from torch.profiler import ProfilerActivity, profile

    from pybnesian_tpu_torch.runtime import tracing

    n, k = 40, 4
    df = normal_chain_data(n)
    tests = [te for _tr, te in engine_of(df, k).folds]
    keep = [*tests[0][:3], *tests[1][:1], *tests[2][:1]]
    df.loc[np.setdiff1d(np.arange(n), keep), "c"] = np.nan
    engine = engine_of(df, k)
    fams = [("c", ["a"], None), ("b", ["a"], None)]
    _X, _valid, _Ns, _starts, ok = device_route(engine, [f[:2] for f in fams])
    assert _as_host(ok)[:k].tolist() == [0.0, 1.0, 1.0, 1.0]
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        h_maps, (search,) = engine._ucv_bandwidths(fams)
    counted = tracing.counters()
    tracing.reset_counters()
    assert sorted(h_maps) == [1]
    assert np.all(np.isnan(search.x0[:k])) and np.all(np.isnan(search.x[:k]))
    assert search.iterations[:k].tolist() == [0] * k
    assert np.all(search.iterations[k:] > 0)
    np.testing.assert_allclose(search.x0[k:], host_route(
        engine, [fams[1][:2]])[0][1], **TOL)
    assert counted["ucv.searches"] == k
    assert counted["ucv.iterations"] == int(search.iterations[k:].sum())
    assert counted["ucv.lane_evaluations"] == int(
        search.lane_evaluations[k:].sum())


@pytest.mark.parametrize("const", [0.0, 2.0])
def test_a_constant_column_has_no_start_and_scores_minus_inf(const):
    df = normal_chain_data(120)
    df["z"] = const
    nodes = ["a", "b", "c", "d", "z"]
    args = pt.Arguments({v: pt.Kwargs(bandwidth_selector=pt.UCV())
                         for v in nodes})
    score = pt.CVLikelihood(df, k=3, seed=0, construction_args=args)
    engine = score._engine
    fams = [("z", []), ("a", ["z"]), ("b", ["a"])]
    want = host_route(engine, fams)
    assert want[0] is None and want[1] is None and want[2] is not None
    for fs, bad in [(fams[:1], 3), (fams[1:], 3)]:
        _X, _valid, _Ns, starts, ok = device_route(engine, fs)
        assert np.all(_as_host(ok)[:bad] == 0.0)
        assert np.all(_as_host(ok)[bad:] == 1.0)
        assert np.all(np.isnan(starts[:bad].numpy()))
    h_maps, searches = engine._ucv_bandwidths(
        [(v, ps, None) for v, ps in fams])
    assert sorted(h_maps) == [2]
    # the NaN starts' lanes end before their first iteration
    assert searches[0].iterations.tolist() == [0, 0, 0]
    assert searches[1].iterations[:3].tolist() == [0, 0, 0]
    assert np.all(searches[1].iterations[3:] > 0)
    got = score.local_score_batch(pt.KDENetwork(nodes),
                                  [(v, ps, pt.CKDEType()) for v, ps in fams])
    assert got[0] == got[1] == -math.inf and np.isfinite(got[2])


def test_device_starts_search_as_host_starts():
    engine = engine_of(frame("float32", True), 4)
    X, valid, Ns, starts, _ok = device_route(engine, FAMILIES[2])
    from_tensor = ucv._minimize(X, valid, Ns, starts, 2, False)
    from_host = ucv._minimize(X, valid, Ns, starts.numpy(), 2, False)
    for a, b in zip(from_tensor, from_host):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    engine = engine_of(frame("float32", True), 4)
    pos, data, null_mask, tr_idx, tr_mask, _te, _tm = (
        engine._device_cv_cache())
    cols = torch.tensor([[pos["c"], pos["a"], pos["b"]]])
    before = ucv_starts.launches
    got = ucv_starts(data, null_mask, cols, tr_idx, tr_mask)
    want = ucv_starts_reference(data, null_mask, cols, tr_idx, tr_mask)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert ucv_starts.launches == before


@pytest.mark.parametrize("bad", ["wide", "int data", "mask dtype",
                                 "split", "shape"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    n, D, K, ntr = 30, 17, 3, 20
    data = torch.zeros((n, D))
    null_mask = torch.zeros((n, D))
    cols = torch.zeros((2, 17 if bad == "wide" else 2), dtype=torch.int64)
    tr_idx = torch.zeros((K, ntr), dtype=torch.int64)
    tr_mask = torch.ones((K, ntr + (bad == "shape")))
    kw = {"split": 3} if bad == "split" else {}
    if bad == "int data":
        data = data.to(torch.int32)
    if bad == "mask dtype":
        null_mask = null_mask.double()
    with pytest.raises((ValueError, TypeError)):
        cvw.ucv_starts(data, null_mask, cols, tr_idx, tr_mask, **kw)


def test_a_score_counts_its_starts_by_route():
    from torch.profiler import ProfilerActivity, profile

    from pybnesian_tpu_torch.runtime import tracing

    df = normal_chain_data(90)
    args = pt.Arguments({v: pt.Kwargs(bandwidth_selector=pt.UCV())
                         for v in "abcd"})
    score = pt.CVLikelihood(df, k=3, seed=0, construction_args=args)
    fams = [("a", [], pt.CKDEType()), ("b", ["a"], pt.CKDEType()),
            ("c", ["b", "a"], pt.CKDEType()), ("d", ["c"], pt.CKDEType())]
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        score.local_score_batch(pt.KDENetwork(list("abcd")), fams)
    counted = tracing.counters()
    tracing.reset_counters()
    assert counted["ucv.host_starts"] == 4 * 3
    assert "ucv.device_starts" not in counted
    assert counted["ucv.searches"] == 4 * 3


def test_a_frame_of_even_folds_and_no_nulls_searches_without_a_mask(
        monkeypatch):
    seen = []

    def spy(X, valid, Ns, starts, d, diagonal, _orig=ucv._minimize):
        seen.append(valid is None)
        return _orig(X, valid, Ns, starts, d, diagonal)

    monkeypatch.setattr(ucv, "_minimize", spy)
    df = normal_chain_data(90)
    df.loc[[4, 40], "c"] = np.nan
    engine = engine_of(df, 3)
    engine._ucv_bandwidths([("a", [], None), ("b", ["a"], None),
                            ("c", ["b", "a"], None)])
    assert seen == [True, True, False]
