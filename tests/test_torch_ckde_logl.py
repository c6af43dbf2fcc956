"""The torch port's fitted KDE, ProductKDE and CKDE factors against the JAX
package's, on the cases of tests/factors/test_kde.py and
tests/factors/test_batched_many.py.

KDE and ProductKDE fit on the same data in both packages (the fit is the
same host numpy code); CKDE factors are fitted in JAX and carried into the
port through ``interop.cpd_state`` / ``interop.fitted_cpd``, so neither
side refits. Tolerances: float64 rtol 1e-9 / atol 1e-7; float32 data (the
port computes in float32, JAX under x64 in float64) rtol 5e-4 / atol 5e-3.
Sampling draws its noise from the same host generator in both packages, so
samples agree to float64 rounding.
"""

import pickle

import numpy as np
import pytest

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu.factors.ckde import (
    batched_ckde_logl_many as jax_batched_many,
)
from pybnesian_tpu_torch import interop
from pybnesian_tpu_torch.factors.ckde import batched_ckde_logl_many

from data_gen import normal_chain_data, with_nulls
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


F64 = dict(rtol=1e-9, atol=1e-7)
F32 = dict(rtol=5e-4, atol=5e-3)


def _same(got, want, tol=F64):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **tol)


def _carry(jcpd):
    return interop.fitted_cpd(jcpd.variable(), interop.cpd_state(jcpd))


@pytest.mark.parametrize("cols", [["a"], ["a", "b"], ["a", "b", "c"]])
def test_kde_logl_matches_jax(cols):
    df = normal_chain_data(300)
    test = normal_chain_data(100, seed=7)
    jk = jpb.KDE(cols, jpb.ScottsBandwidth())
    jk.fit(df)
    tk = tpb.KDE(cols, tpb.ScottsBandwidth())
    tk.fit(df)
    _same(tk.logl(test), jk.logl(test))
    assert tk.slogl(test) == pytest.approx(jk.slogl(test), rel=1e-12)


def test_kde_float32():
    df = normal_chain_data(300, dtype="float32")
    test = normal_chain_data(50, seed=3, dtype="float32")
    jk = jpb.KDE(["a", "b"])
    jk.fit(df)
    tk = tpb.KDE(["a", "b"])
    tk.fit(df)
    assert str(tk.data_type()) == "float"
    assert str(tk.whitened_training().dtype) == "torch.float32"
    got = tk.logl(test)
    assert got.dtype == np.float64
    _same(got, jk.logl(test), F32)


def test_kde_nulls():
    df = with_nulls(normal_chain_data(400), frac=0.1)
    test = with_nulls(normal_chain_data(80, seed=5), frac=0.2)
    jk = jpb.KDE(["a", "b"])
    jk.fit(df)
    tk = tpb.KDE(["a", "b"])
    tk.fit(df)
    got = tk.logl(test)
    nulls = (test["a"].isna() | test["b"].isna()).to_numpy()
    assert np.isnan(got[nulls]).all() and not np.isnan(got[~nulls]).any()
    _same(got, jk.logl(test))


def test_product_kde_matches_jax():
    df = normal_chain_data(300)
    test = normal_chain_data(60, seed=9)
    jp = jpb.ProductKDE(["a", "b", "c"])
    jp.fit(df)
    tp = tpb.ProductKDE(["a", "b", "c"])
    tp.fit(df)
    np.testing.assert_array_equal(tp.bandwidth, jp.bandwidth)
    _same(tp.logl(test), jp.logl(test))
    assert tp.slogl(test) == pytest.approx(jp.slogl(test), rel=1e-12)


@pytest.mark.parametrize("evidence", [[], ["a"], ["a", "c"]])
def test_ckde_logl_matches_jax(evidence):
    df = normal_chain_data(300)
    test = with_nulls(normal_chain_data(70, seed=11), frac=0.05)
    jc = jpb.CKDE("b", evidence)
    jc.fit(df)
    tc = _carry(jc)
    _same(tc.logl(test), jc.logl(test))
    assert tc.slogl(test) == pytest.approx(jc.slogl(test), rel=1e-12)


def test_ckde_fit_matches_carried_state():
    """Fitting in the port gives the state the JAX fit carries across."""
    df = with_nulls(normal_chain_data(300), frac=0.05)
    jc = jpb.CKDE("c", ["a", "b"])
    jc.fit(df)
    tc = tpb.CKDE("c", ["a", "b"])
    tc.fit(df)
    want, got = interop.cpd_state(jc), interop.cpd_state(tc)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_ckde_float32():
    df = normal_chain_data(300, dtype="float32")
    test = normal_chain_data(70, seed=4, dtype="float32")
    jc = jpb.CKDE("c", ["a", "b"])
    jc.fit(df)
    tc = _carry(jc)
    assert str(tc.kde_marg().whitened_training().dtype) == "torch.float32"
    _same(tc.logl(test), jc.logl(test), F32)


def test_pickle_roundtrip():
    df = normal_chain_data(200)
    test = normal_chain_data(30, seed=1)
    for obj in (tpb.KDE(["a", "b"]), tpb.ProductKDE(["a", "b"]),
                tpb.CKDE("b", ["a"])):
        obj.fit(df)
        copy = pickle.loads(pickle.dumps(obj))
        np.testing.assert_array_equal(copy.logl(test), obj.logl(test))
    assert copy.type() == tpb.CKDEType()


@pytest.mark.parametrize("evidence", [[], ["a"], ["a", "c"]])
def test_ckde_cdf_matches_jax(evidence):
    df = normal_chain_data(300)
    test = with_nulls(normal_chain_data(50, seed=13), frac=0.05)
    jc = jpb.CKDE("b", evidence)
    jc.fit(df)
    got = _carry(jc).cdf(test)
    _same(got, jc.cdf(test))
    valid = got[~np.isnan(got)]
    assert np.all((valid >= 0) & (valid <= 1))


@pytest.mark.parametrize("evidence", [[], ["a"], ["a", "c"]])
def test_ckde_sample_same_seed(evidence):
    df = normal_chain_data(300)
    jc = jpb.CKDE("b", evidence)
    jc.fit(df)
    tc = _carry(jc)
    ev = normal_chain_data(120, seed=17)[evidence] if evidence else None
    want = np.asarray(jc.sample(120, ev, seed=4))
    got = np.asarray(tc.sample(120, ev, seed=4))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, **F64)


def test_batched_many_mixed_entries():
    """Mixed family widths, test-row counts and training sizes in one
    launch: each factor's rows agree with the JAX helper and with the
    port factor's own logl."""
    df1 = normal_chain_data(200, seed=1)
    df2 = normal_chain_data(350, seed=2)
    jfs = [jpb.CKDE("a"), jpb.CKDE("b", ["a"]), jpb.CKDE("d", ["a", "b", "c"])]
    for f, data in zip(jfs, (df1, df2, df2)):
        f.fit(data)
    t1 = normal_chain_data(37, seed=3)
    t2 = normal_chain_data(91, seed=4)
    mats = [t1[["a"]], t2[["b", "a"]], t1[["d", "a", "b", "c"]]]
    mats = [m.to_numpy(np.float64) for m in mats]
    want = jax_batched_many(list(zip(jfs, mats)))
    tfs = [_carry(f) for f in jfs]
    got = batched_ckde_logl_many(list(zip(tfs, mats)))
    for g, w, f, t in zip(got, want, tfs, (t1, t2, t1)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **F64)
        np.testing.assert_allclose(g, f.logl(t), **F64)
