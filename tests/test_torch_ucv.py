"""UCV bandwidth selection of the torch port against the JAX package's.

Float64 on the CPU, inputs from a numpy seed. The pair sums are held to the
JAX function and to a brute-force triangle (rtol 1e-10, with invalid rows
and a row count that no block divides); the UCV objective to the JAX
scorer (rtol 1e-9); the selected bandwidths to the JAX selector's (rtol
1e-5) — and should the two searches ever branch apart, the test demands
instead that both results score within 1e-6 relative of each other, rather
than a looser tolerance on the bandwidths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pybnesian_tpu as pj
import pybnesian_tpu_torch as pt
from pybnesian_tpu.kde import ucv as jucv
from pybnesian_tpu.ops.kde import ucv_pair_sums as jax_pair_sums
from pybnesian_tpu_torch import interop
from pybnesian_tpu_torch.kde import ucv as tucv
from pybnesian_tpu_torch.ops import kde as tkde

from data_gen import normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


def _brute(W, valid):
    keep = W[valid > 0]
    d2 = ((keep[:, None, :] - keep[None, :, :]) ** 2).sum(-1)
    iu = np.triu_indices(len(keep), 1)
    return np.exp(-0.25 * d2[iu]).sum(), np.exp(-0.5 * d2[iu]).sum()


@pytest.mark.parametrize("n,d,block", [(257, 1, 1 << 25), (300, 2, 4096),
                                       (131, 3, 1000), (64, 4, 1 << 25)])
def test_pair_sums_match_jax_and_brute_force(n, d, block, monkeypatch):
    rng = np.random.default_rng(n)
    W = rng.normal(size=(n, d))
    valid = (rng.random(n) > 0.15).astype(np.float64)
    monkeypatch.setattr(tkde, "_UCV_BLOCK", block)   # ragged row blocks
    s2h, sh = tkde.ucv_pair_sums(torch.as_tensor(W), torch.as_tensor(valid))
    np.testing.assert_allclose([float(s2h), float(sh)], _brute(W, valid),
                               rtol=1e-10)
    # the JAX function wants rows padded to a multiple of its chunk
    npad = -(-n // 64) * 64
    Wp = np.zeros((npad, d))
    Wp[:n] = W
    vp = np.zeros(npad)
    vp[:n] = valid
    want = jax_pair_sums(jnp.asarray(Wp), jnp.asarray(vp), chunk=64)
    np.testing.assert_allclose([float(s2h), float(sh)],
                               [float(want[0]), float(want[1])], rtol=1e-10)


def test_pair_sums_batch_equals_singles():
    rng = np.random.default_rng(1)
    W = rng.normal(size=(5, 90, 2))
    valid = (rng.random((5, 90)) > 0.2).astype(np.float64)
    valid[3, 40:] = 0.0                        # a much shorter problem
    s2h, sh = tkde.ucv_pair_sums_batch(torch.as_tensor(W),
                                       torch.as_tensor(valid))
    for b in range(5):
        np.testing.assert_allclose([float(s2h[b]), float(sh[b])],
                                   _brute(W[b], valid[b]), rtol=1e-10)
    w32 = torch.as_tensor(W, dtype=torch.float32)
    s32, _ = tkde.ucv_pair_sums_batch(w32, torch.as_tensor(valid).float())
    assert s32.dtype == torch.float32
    np.testing.assert_allclose(s32.numpy(), s2h.numpy(), rtol=1e-5)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_vech_round_trips(d):
    rng = np.random.default_rng(d)
    L = np.tril(rng.normal(size=(d, d)))
    v = tucv.vech(L)
    np.testing.assert_array_equal(v, jucv.vech(L))
    np.testing.assert_array_equal(tucv.invvech_triangular(v), L)
    rows, cols = tucv._vech_indices(d)
    L2 = np.zeros((d, d))
    L2[rows, cols] = v
    np.testing.assert_array_equal(L2, L)      # column-major, not tril order


@pytest.mark.parametrize("cols", [["a"], ["a", "b"], ["b", "c", "d"]],
                         ids=lambda c: "".join(c))
def test_scorer_matches_jax(cols):
    df = normal_chain_data(200)
    js, ts = jucv.UCVScorer(df, cols), tucv.UCVScorer(df, cols)
    H = pj.NormalReferenceRule().bandwidth(df, cols)
    for scale in (1.0, 0.4, 2.5):
        np.testing.assert_allclose(ts.score_unconstrained(scale * H),
                                   js.score_unconstrained(scale * H),
                                   rtol=1e-9)
    diag = np.diag(H) * 0.7
    np.testing.assert_allclose(ts.score_diagonal(diag),
                               js.score_diagonal(diag), rtol=1e-9)
    assert ts.score_unconstrained(-H) == np.inf


def _same_or_equally_good(got, want, score):
    if np.allclose(got, want, rtol=1e-5, atol=0):
        return
    a, b = score(got), score(want)
    assert abs(a - b) <= 1e-6 * abs(b), (got, want, a, b)


@pytest.mark.parametrize("cols", [["a"], ["a", "b"], ["b", "c", "d"]],
                         ids=lambda c: "".join(c))
def test_bandwidths_match_jax(cols):
    df = normal_chain_data(150, seed=2)
    scorer = tucv.UCVScorer(df, cols)
    start = pt.NormalReferenceRule().bandwidth(df, cols)

    got = pt.UCV().bandwidth(df, cols)
    _same_or_equally_good(got, pj.UCV().bandwidth(df, cols),
                          scorer.score_unconstrained)
    np.testing.assert_allclose(got, got.T)
    assert np.all(np.linalg.eigvalsh(got) > 0)
    s0 = scorer.score_unconstrained(start)
    assert scorer.score_unconstrained(got) <= s0 + 1e-6 * abs(s0)

    got = pt.UCV().diag_bandwidth(df, cols)
    _same_or_equally_good(got, pj.UCV().diag_bandwidth(df, cols),
                          scorer.score_diagonal)
    assert got.shape == (len(cols),) and np.all(got > 0)


def test_float32_frame_searches_in_float32():
    df = normal_chain_data(150, dtype="float32")
    selector = pt.UCV()
    h32 = selector.bandwidth(df, ["a", "b"])
    assert selector.last_search.dtype == "float32"
    h64 = pt.UCV().bandwidth(df.astype("float64"), ["a", "b"])
    np.testing.assert_allclose(h32, h64, rtol=5e-2)


def test_selector_keeps_its_last_search():
    df = normal_chain_data(120)
    selector = pt.UCV()
    assert selector.last_search is None
    selector.bandwidth(df, ["a", "b"])
    search = selector.last_search
    assert search.x.shape == (1, 3) and search.dtype == "float64"
    assert search.iterations.shape == (1,) and search.iterations[0] > 0
    # the start and the initial simplex: 4; then two per iteration, two
    # more whenever the search shrank
    assert search.evaluations >= 4 + 2 * search.iterations[0]
    selector.diag_bandwidth(df, ["a", "b"])
    assert selector.last_search.x.shape == (1, 2)


def test_empty_variable_list():
    assert pt.UCV().bandwidth(normal_chain_data(20), []).shape == (0, 0)
    assert pt.UCV().diag_bandwidth(normal_chain_data(20), []).shape == (0,)


def test_kde_with_ucv_selector_matches_jax():
    df = normal_chain_data(200)
    test = normal_chain_data(40, seed=5)
    jk = pj.KDE(["a", "b"], pj.UCV())
    jk.fit(df)
    tk = pt.KDE(["a", "b"], pt.UCV())
    tk.fit(df)
    np.testing.assert_allclose(tk.bandwidth, jk.bandwidth, rtol=1e-5)
    np.testing.assert_allclose(tk.logl(test), jk.logl(test), rtol=1e-5)
    pk = pt.ProductKDE(["a", "b"], pt.UCV())
    pk.fit(df)
    jpk = pj.ProductKDE(["a", "b"], pj.UCV())
    jpk.fit(df)
    np.testing.assert_allclose(pk.logl(test), jpk.logl(test), rtol=1e-5)


def test_ckde_with_ucv_selector_crosses_interop():
    """A UCV-fitted CKDE of the JAX package becomes the port's fitted
    factor (same rows, same bandwidth, selector by name), and a CKDE
    fitted by the port with UCV gives the same log-likelihood."""
    df = normal_chain_data(160)
    test = normal_chain_data(30, seed=7)
    jc = pj.CKDE("b", ["a"], bandwidth_selector=pj.UCV())
    jc.fit(df)
    state = interop.cpd_state(jc)
    assert state["bandwidth_selector"] == "UCV"
    carried = interop.fitted_cpd("b", state)
    assert isinstance(carried.bandwidth_selector(), pt.UCV)
    np.testing.assert_allclose(carried.logl(test), jc.logl(test), rtol=1e-9)
    tc = pt.CKDE("b", ["a"], bandwidth_selector=pt.UCV())
    tc.fit(df)
    np.testing.assert_allclose(tc.logl(test), jc.logl(test), rtol=1e-5)
    back = interop.cpd_state(tc)
    np.testing.assert_allclose(back["bandwidth"], state["bandwidth"],
                               rtol=1e-5)
