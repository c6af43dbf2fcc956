"""The torch port's fitted KDENetwork and SemiparametricBN (logl, slogl,
sample) against the JAX package's, on the cases of
tests/models/test_batched_logl.py.

Every network is fitted in JAX and carried into the port with
``interop.network_state`` / ``interop.fitted_network``: both packages then
evaluate the same fitted model. With two or more CKDE nodes, ``model.logl``
takes the batched shared-Cholesky route and ``cpd.logl`` the per-factor
route; the two agree to 1e-9 in float64, as in the JAX suite. Tolerances
against JAX: float64 rtol 1e-9 / atol 1e-7; float32 data (the port in
float32, JAX under x64 in float64) rtol 5e-4 / atol 5e-3.
"""

import numpy as np
import pytest

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu_torch import interop

from data_gen import normal_chain_data, with_nulls

F64 = dict(rtol=1e-9, atol=1e-7)
F32 = dict(rtol=5e-4, atol=5e-3)
NODES = ["a", "b", "c", "d"]


def _kdenetwork(dtype="float64"):
    df = normal_chain_data(300, seed=3, dtype=dtype)
    df.loc[4, "a"] = np.nan
    m = jpb.KDENetwork(NODES, [("a", "b"), ("b", "c"), ("c", "d")])
    m.fit(df)
    return m


def _spbn(ckde=("a", "c"), dtype="float64"):
    df = normal_chain_data(250, seed=5, dtype=dtype)
    m = jpb.SemiparametricBN(
        NODES, [("a", "b"), ("b", "c")], [(n, jpb.CKDEType()) for n in ckde],
    )
    m.fit(df)
    return m


MODELS = {"kdenetwork": _kdenetwork, "spbn": _spbn,
          "spbn-one-ckde": lambda: _spbn(ckde=("c",))}


def _test_rows(dtype="float64"):
    test = normal_chain_data(80, seed=9, dtype=dtype)
    test.loc[2, "b"] = np.nan
    return test


@pytest.mark.parametrize("name", list(MODELS))
def test_logl_matches_jax(name):
    jm = MODELS[name]()
    tm = interop.fitted_network(**interop.network_state(jm))
    assert type(tm) is getattr(tpb, type(jm).__name__)
    test = _test_rows()
    got, want = tm.logl(test), jm.logl(test)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **F64)
    assert tm.slogl(test) == pytest.approx(jm.slogl(test), rel=1e-12)


@pytest.mark.parametrize("name", list(MODELS))
def test_batched_logl_matches_factors(name):
    """``model.logl`` (one launch for all CKDE nodes) against the sum of
    per-factor logls, and ``model.slogl`` against Σ ``cpd.slogl``."""
    tm = interop.fitted_network(**interop.network_state(MODELS[name]()))
    test = _test_rows()
    ref = sum(np.asarray(tm.cpd(n).logl(test)) for n in NODES)
    np.testing.assert_allclose(tm.logl(test), ref, rtol=1e-9, atol=1e-9)
    total = 0.0
    for n in NODES:
        total += tm.cpd(n).slogl(test)
    if name == "spbn-one-ckde":
        # no batched route: the left-to-right sum of the same per-factor
        # values, bit for bit
        assert tm.slogl(test) == total
    else:
        assert tm.slogl(test) == pytest.approx(total, rel=1e-9)


@pytest.mark.parametrize("name", ["kdenetwork", "spbn"])
def test_sample_same_seed(name):
    jm = MODELS[name]()
    tm = interop.fitted_network(**interop.network_state(jm))
    want = jm.sample(150, seed=7, ordered=True).to_pandas()
    got = tm.sample(150, seed=7, ordered=True).to_pandas()
    assert list(got.columns) == NODES
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), **F64)


def test_float32_model_matches_jax():
    jm = _spbn(ckde=("a", "b", "d"), dtype="float32")
    tm = interop.fitted_network(**interop.network_state(jm))
    test = with_nulls(normal_chain_data(90, seed=4, dtype="float32"), 0.05)
    got, want = tm.logl(test), jm.logl(test)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **F32)
    assert tm.slogl(test) == pytest.approx(jm.slogl(test), rel=5e-4)


def test_port_fit_and_state_roundtrip():
    """A network fitted in the port and carried through its own state
    gives the same values as the original."""
    df = normal_chain_data(200, seed=8)
    tm = tpb.SemiparametricBN(
        NODES, [("a", "b"), ("b", "c"), ("a", "d")],
        [("b", tpb.CKDEType()), ("d", tpb.CKDEType())],
    )
    tm.fit(df)
    copy = interop.fitted_network(**interop.network_state(tm))
    test = _test_rows()
    np.testing.assert_array_equal(copy.logl(test), tm.logl(test))
