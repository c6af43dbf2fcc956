"""The torch port's hybrid factors (``CLinearGaussianCPD``, ``HCKDE``) and
the networks that hold them (CLG, semiparametric with discrete parents,
heterogeneous) against the JAX package, on the cases of
tests/factors/test_hybrid.py and tests/models/test_other_networks.py.

The same seeded frames go through both packages. Tolerances: float64 rtol
1e-9 / atol 1e-7; float32 data in the port against float64 in the JAX
package, rtol 5e-4 / atol 5e-3; learned graphs equal.
"""

import numpy as np
import pandas as pd
import pytest

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu_torch import interop

from data_gen import mixed_data, normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

F64 = dict(rtol=1e-9, atol=1e-7)
F32 = dict(rtol=5e-4, atol=5e-3)


def _both(make):
    """``make(package)`` for the JAX package and the port."""
    return make(jpb), make(tpb)


def _three_columns(n=500, seed=0):
    """a (3 categories) -> b -> c: one categorical parent of a continuous
    node."""
    rng = np.random.default_rng(seed)
    a = pd.Categorical(rng.choice(["x", "y", "z"], n))
    b = rng.normal(np.asarray(a.codes) * 1.5, 1.0, n)
    c = 2.0 * b + rng.normal(0.0, 1.0, n)
    return pd.DataFrame({"a": a, "b": b, "c": c})


def _graph(model):
    return (sorted(model.arcs()),
            {n: model.node_type(n).ToString() for n in model.nodes()})


# ------------------------------------------------------------------ factors
def test_clg_fit_and_logl():
    df = mixed_data(3000)
    jf, tf = _both(lambda pkg: pkg.CLinearGaussianCPD("Y", ["X", "B"]))
    jf.fit(df)
    tf.fit(df)
    assert tf.fitted() and tf.type() == tpb.LinearGaussianCPDType()
    np.testing.assert_allclose(tf.logl(df), jf.logl(df), **F64)
    for cat in ("b1", "b2"):
        got = tf.conditional_factor(tpb.Assignment({"B": cat}))
        want = jf.conditional_factor(jpb.Assignment({"B": cat}))
        assert type(got) is tpb.LinearGaussianCPD
        np.testing.assert_allclose(got.beta, want.beta, **F64)
        np.testing.assert_allclose(got.variance, want.variance, **F64)


def test_clg_no_discrete_evidence_is_plain_lg():
    df = mixed_data(500)
    f = tpb.CLinearGaussianCPD("Y", ["X"])
    f.fit(df)
    lg = jpb.LinearGaussianCPD("Y", ["X"])
    lg.fit(df)
    np.testing.assert_allclose(f.logl(df), lg.logl(df), **F64)


@pytest.mark.parametrize("evidence", [["X", "A"], ["A"], ["X", "A", "B"]])
def test_hckde_fit_logl(evidence):
    df = mixed_data(600)
    test = mixed_data(150, seed=4)
    jf, tf = _both(lambda pkg: pkg.HCKDE("Y", evidence))
    jf.fit(df)
    tf.fit(df)
    assert tf.type() == tpb.CKDEType()
    got = tf.logl(test)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jf.logl(test), **F64)
    assert tf.slogl(test) == pytest.approx(jf.slogl(test), rel=1e-12)


def test_hckde_batched_route_matches_configurations():
    """``HCKDE.logl`` scores every live configuration in one batched call
    (the model's CKDE route, kernel #1 on the card); each configuration's
    own ``CKDE.logl`` (kernel #2 on the card) gives the same rows."""
    df = mixed_data(600)
    f = tpb.HCKDE("Y", ["X", "A"])
    f.fit(df)
    got = f.logl(df)
    for cat in ("a1", "a2", "a3"):
        rows = (df["A"] == cat).to_numpy()
        sub = f.conditional_factor(tpb.Assignment({"A": cat}))
        assert type(sub) is tpb.CKDE
        np.testing.assert_allclose(got[rows], sub.logl(df[rows]),
                                   rtol=1e-9, atol=1e-9)


def test_hckde_float32():
    df64, test64 = mixed_data(500), mixed_data(120, seed=6)
    df32 = mixed_data(500, dtype="float32")
    test32 = mixed_data(120, seed=6, dtype="float32")
    jf = jpb.HCKDE("Y", ["X", "A"])
    jf.fit(df64)
    tf = tpb.HCKDE("Y", ["X", "A"])
    tf.fit(df32)
    np.testing.assert_allclose(tf.logl(test32), jf.logl(test64), **F32)


def test_unfittable_config_yields_nan():
    # config with 2 rows: LG with 1 parent needs > 2 rows for finite variance
    df = pd.DataFrame({
        "B": pd.Categorical(["b1"] * 50 + ["b2"] * 2),
        "X": np.random.default_rng(0).normal(size=52),
        "Y": np.random.default_rng(1).normal(size=52),
    })
    jf, tf = _both(lambda pkg: pkg.CLinearGaussianCPD("Y", ["X", "B"]))
    jf.fit(df)
    tf.fit(df)
    got, want = tf.logl(df), jf.logl(df)
    assert np.isnan(got[-2:]).all() and np.isfinite(got[:-2]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **F64)
    assert tf.slogl(df) == pytest.approx(jf.slogl(df), rel=1e-12)
    assert tf.conditional_factor(tpb.Assignment({"B": "b2"})) is None


def test_singular_ckde_configuration_yields_nan():
    """A configuration whose rows are constant cannot fit a CKDE: the
    port's KDE raises its own SingularCovarianceData, the adaptator leaves
    the configuration unfitted and its rows evaluate to NaN."""
    rng = np.random.default_rng(2)
    df = pd.DataFrame({
        "B": pd.Categorical(["b1"] * 40 + ["b2"] * 5),
        "X": np.r_[rng.normal(size=40), np.ones(5)],
        "Y": np.r_[rng.normal(size=40), np.ones(5)],
    })
    jf, tf = _both(lambda pkg: pkg.HCKDE("Y", ["X", "B"]))
    jf.fit(df)
    tf.fit(df)
    got = tf.logl(df)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jf.logl(df)))
    assert np.isnan(got[-5:]).all() and np.isfinite(got[:-5]).all()
    np.testing.assert_allclose(got, jf.logl(df), equal_nan=True, **F64)


def test_hybrid_sampling():
    df = mixed_data(3000)
    jf, tf = _both(lambda pkg: pkg.CLinearGaussianCPD("Y", ["X", "B"]))
    jf.fit(df)
    tf.fit(df)
    ev = df[["X", "B"]].head(2000)
    got = np.asarray(tf.sample(2000, ev, seed=0))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jf.sample(2000, ev, seed=0)),
                               **F64)
    # the conditional mean tracks the per-category regression
    b1 = (ev["B"] == "b1").to_numpy()
    sub = tf.conditional_factor(tpb.Assignment({"B": "b1"}))
    pred = sub.beta[0] + sub.beta[1] * ev["X"].to_numpy()[b1]
    assert abs((got[b1] - pred).mean()) < 0.1


@pytest.mark.parametrize("kind", ["CLinearGaussianCPD", "HCKDE"])
def test_carried_state_matches_jax(kind):
    """``interop.cpd_state`` / ``fitted_cpd`` carry a fitted hybrid factor,
    an unfitted configuration included, into the port unchanged."""
    df = mixed_data(400)
    df.loc[df["A"] == "a1", "X"] = 1.0  # a1 cannot fit with X as evidence
    jf = getattr(jpb, kind)("Y", ["X", "A"])
    jf.fit(df)
    state = interop.cpd_state(jf)
    assert state["adaptator"] == kind
    tf = interop.fitted_cpd("Y", state)
    assert type(tf) is getattr(tpb, kind)
    np.testing.assert_allclose(tf.logl(df), jf.logl(df), equal_nan=True,
                               **F64)
    fitted = getattr(tpb, kind)("Y", ["X", "A"])
    fitted.fit(df)
    assert [f is None for f in fitted._factors] == [
        f is None for f in state["factors"]]


# ----------------------------------------------------------------- networks
def test_clg_network_fit_slogl_matches_jax():
    """A linear-Gaussian node with one categorical parent fits as a
    CLinearGaussianCPD (the port lacked factors/hybrid.py before)."""
    df = _three_columns()
    jm, tm = _both(lambda pkg: pkg.CLGNetwork(["a", "b", "c"],
                                               [("a", "b"), ("b", "c")]))
    jm.fit(df)
    tm.fit(df)
    assert type(tm.cpd("b")) is tpb.CLinearGaussianCPD
    assert tm.slogl(df) == pytest.approx(jm.slogl(df), rel=1e-9)
    np.testing.assert_allclose(tm.logl(df), jm.logl(df), **F64)


def test_hc_clg_validated_likelihood_matches_jax():
    df = _three_columns()
    jm, tm = _both(lambda pkg: pkg.hc(df, bn_type=pkg.CLGNetworkType(),
                                      score="validated-lik", seed=0))
    assert sorted(tm.arcs()) == sorted(jm.arcs()) == [("a", "b"), ("b", "c")]


def test_spbn_ckde_node_with_discrete_parent_is_hckde():
    df = mixed_data(600)
    test = mixed_data(100, seed=3)

    def make(pkg):
        m = pkg.SemiparametricBN(
            ["A", "B", "X", "Y"], [("A", "X"), ("X", "Y"), ("B", "Y")],
            [("A", pkg.DiscreteFactorType()), ("B", pkg.DiscreteFactorType()),
             ("X", pkg.CKDEType()), ("Y", pkg.CKDEType())])
        m.fit(df)
        return m

    jm, tm = _both(make)
    assert type(tm.cpd("X")) is tpb.HCKDE and type(tm.cpd("Y")) is tpb.HCKDE
    got = tm.logl(test)
    np.testing.assert_allclose(got, jm.logl(test), **F64)
    factors = sum(np.asarray(tm.cpd(n).logl(test)) for n in tm.nodes())
    np.testing.assert_allclose(got, factors, rtol=1e-12, atol=1e-12)
    carried = interop.fitted_network(**interop.network_state(jm))
    np.testing.assert_allclose(carried.logl(test), jm.logl(test), **F64)


def test_hybrid_spbn_hc_matches_jax():
    df = mixed_data(400)
    jm, tm = _both(lambda pkg: pkg.hc(
        df, bn_type=pkg.SemiparametricBNType(), score="validated-lik",
        seed=0, patience=2, max_iters=20))
    assert _graph(tm) == _graph(jm)


def test_type_dispatch_via_new_factor():
    df = mixed_data(800)
    jm, tm = _both(lambda pkg: pkg.CLGNetwork(
        ["A", "B", "X", "Y"], [("A", "X"), ("X", "Y"), ("B", "Y")]))
    jm.fit(df)
    tm.fit(df)
    assert type(tm.cpd("X")) is tpb.CLinearGaussianCPD
    assert type(tm.cpd("Y")) is tpb.CLinearGaussianCPD
    np.testing.assert_allclose(tm.logl(df), jm.logl(df), **F64)
    got = tm.sample(500, seed=0).to_pandas()
    want = jm.sample(500, seed=0).to_pandas()
    assert set(got.columns) == {"A", "B", "X", "Y"}
    for col in ("X", "Y"):
        np.testing.assert_allclose(got[col], want[col], **F64)
    for col in ("A", "B"):
        assert list(got[col].astype(str)) == list(want[col].astype(str))


def test_clg_network_blocks_continuous_to_discrete():
    df = mixed_data(100)
    bn = tpb.CLGNetwork(["A", "X"])
    bn.set_unknown_node_types(df)
    assert not bn.can_add_arc("X", "A")
    assert bn.can_add_arc("A", "X")


def test_kde_network_fit_logl_sample():
    df = normal_chain_data(300)
    jm, tm = _both(lambda pkg: pkg.KDENetwork(["a", "b", "c"],
                                              [("a", "b"), ("b", "c")]))
    jm.fit(df)
    tm.fit(df)
    assert type(tm.cpd("b")) is tpb.CKDE
    np.testing.assert_allclose(tm.logl(df.head(100)), jm.logl(df.head(100)),
                               **F64)
    got = tm.sample(200, seed=0).to_pandas()
    want = jm.sample(200, seed=0).to_pandas()
    np.testing.assert_allclose(got[["a", "b", "c"]], want[["a", "b", "c"]],
                               **F64)


def test_spbn_mixed_types_fit_sample():
    df = normal_chain_data(300)
    jm, tm = _both(lambda pkg: pkg.SemiparametricBN(
        ["a", "b", "c"], [("a", "b"), ("b", "c")],
        node_types=[("b", pkg.CKDEType())]))
    assert tm.node_type("a") == tpb.UnknownFactorType()
    jm.fit(df)
    tm.fit(df)
    assert tm.node_type("a") == tpb.LinearGaussianCPDType()
    assert type(tm.cpd("b")) is tpb.CKDE
    np.testing.assert_allclose(tm.logl(df), jm.logl(df), **F64)
    got = tm.sample(150, seed=1).to_pandas()
    np.testing.assert_allclose(got[["a", "b", "c"]],
                               jm.sample(150, seed=1).to_pandas()[
                                   ["a", "b", "c"]], **F64)


def test_heterogeneous_bn_with_type_map():
    df = mixed_data(800)

    def make(pkg):
        m = pkg.HeterogeneousBN(
            {"categorical": [pkg.DiscreteFactorType()],
             "float64": [pkg.LinearGaussianCPDType(), pkg.CKDEType()]},
            ["A", "B", "X", "Y"], [("A", "X"), ("X", "Y")])
        m.fit(df)
        return m

    jm, tm = _both(make)
    assert tm.node_type("A") == tpb.DiscreteFactorType()
    assert tm.node_type("X") == tpb.LinearGaussianCPDType()
    np.testing.assert_allclose(tm.logl(df.head(50)), jm.logl(df.head(50)),
                               **F64)
    carried = interop.fitted_network(**interop.network_state(jm))
    assert type(carried) is tpb.HeterogeneousBN
    assert carried.type() == tm.type()


def test_heterogeneous_bn_with_list():
    df = normal_chain_data(300)
    jm, tm = _both(lambda pkg: pkg.HeterogeneousBN([pkg.CKDEType()],
                                                   ["a", "b"], [("a", "b")]))
    jm.fit(df)
    tm.fit(df)
    assert type(tm.cpd("b")) is tpb.CKDE
    np.testing.assert_allclose(tm.logl(df), jm.logl(df), **F64)


def test_heterogeneous_pyarrow_dtype_map():
    import pyarrow as pa

    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "x": rng.normal(size=50).astype(np.float32),
        "y": rng.normal(size=50),
        "A": pd.Categorical(rng.choice(["u", "v"], 50)),
    })
    het = tpb.HeterogeneousBN(
        {pa.float32(): [tpb.CKDEType()],
         pa.float64(): [tpb.LinearGaussianCPDType()],
         pa.dictionary(pa.int8(), pa.string()): [tpb.DiscreteFactorType()]},
        ["x", "y", "A"])
    het.set_unknown_node_types(df)
    assert het.node_type("x") == tpb.CKDEType()
    assert het.node_type("y") == tpb.LinearGaussianCPDType()
    assert het.node_type("A") == tpb.DiscreteFactorType()


def test_conditional_clg_network_matches_jax():
    df = mixed_data(500)

    def make(pkg):
        m = pkg.ConditionalCLGNetwork(["B", "Y"], ["X"],
                                      [("B", "Y"), ("X", "Y")])
        m.fit(df)
        return m

    jm, tm = _both(make)
    assert type(tm.cpd("Y")) is tpb.CLinearGaussianCPD
    np.testing.assert_allclose(tm.logl(df), jm.logl(df), **F64)
    carried = interop.fitted_network(**interop.network_state(jm))
    assert type(carried) is tpb.ConditionalCLGNetwork
    assert carried.interface_nodes() == ["X"]
    np.testing.assert_allclose(carried.logl(df), jm.logl(df), **F64)


def test_model_graph_delegation():
    df = normal_chain_data(100)
    bn = tpb.SemiparametricBN(["a", "b", "c"], [("a", "b"), ("b", "c")])
    assert bn.roots() == ["a"]
    assert bn.leaves() == ["c"]
    assert bn.topological_sort() == ["a", "b", "c"]
    assert bn.has_unknown_node_types()
    bn.set_unknown_node_types(df)
    assert not bn.has_unknown_node_types()
