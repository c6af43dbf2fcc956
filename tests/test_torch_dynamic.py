"""The torch port's dynamic data frames, dynamic networks and dynamic
scores against the JAX package, on the cases of
tests/models/test_dynamic_bn.py, test_dbn_management.py and
test_dbn_logl_oracle.py.

The same seeded series go through both packages. Tolerances: float64 rtol
1e-9 / atol 1e-7; float32 data in the port against float64 in the JAX
package, rtol 5e-4 / atol 5e-3.
"""

import re

import numpy as np
import pandas as pd
import pytest
from scipy.stats import norm

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu_torch import interop

from data_gen import normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

F64 = dict(rtol=1e-9, atol=1e-7)
F32 = dict(rtol=5e-4, atol=5e-3)
VARS = ["a", "b", "c", "d"]


def ar_data(n=800, seed=0, dtype="float64"):
    rng = np.random.default_rng(seed)
    a = np.zeros(n)
    b = np.zeros(n)
    for t in range(1, n):
        a[t] = 0.7 * a[t - 1] + rng.normal(0, 0.4)
        b[t] = 0.5 * a[t - 1] + 0.3 * b[t - 1] + rng.normal(0, 0.4)
    return pd.DataFrame({"a": a.astype(dtype), "b": b.astype(dtype)})


def _both(make):
    return make(jpb), make(tpb)


# --------------------------------------------------------------- data views
def test_dynamic_dataframe_slices():
    df = normal_chain_data(100)
    jd, td = _both(lambda pkg: pkg.DynamicDataFrame(df, 2))
    assert td.markovian_order() == 2
    assert td.num_rows == jd.num_rows == 98
    for view in ("transition_df", "static_df"):
        got, want = getattr(td, view)(), getattr(jd, view)()
        assert got.column_names() == want.column_names()
        for name in want.column_names():
            np.testing.assert_array_equal(got.col(name).values,
                                          want.col(name).values)
    np.testing.assert_array_equal(
        td.transition_df().col("a_t_1").values, df["a"].to_numpy()[1:99])


def test_dynamic_dataframe_markov1_static_is_renamed_origin():
    df = normal_chain_data(50)
    static = tpb.DynamicDataFrame(df, 1).static_df()
    assert static.num_rows == 50
    np.testing.assert_array_equal(static.col("a_t_1").values,
                                  df["a"].to_numpy())


def test_dynamic_variable():
    v = tpb.DynamicVariable("x", 2)
    assert v.temporal_name() == "x_t_2"
    ddf = tpb.DynamicDataFrame(normal_chain_data(30), 1)
    assert ddf.loc([("a", 0), ("b", 1)]).column_names() == ["a_t_0", "b_t_1"]


# ----------------------------------------------------------------- networks
def _ar_network(pkg, kind="DynamicGaussianNetwork"):
    dbn = getattr(pkg, kind)(["a", "b"], 1)
    dbn.static_bn().add_arc("a_t_1", "b_t_1")
    for arc in (("a_t_1", "a_t_0"), ("a_t_1", "b_t_0"), ("b_t_1", "b_t_0")):
        dbn.transition_bn().add_arc(*arc)
    return dbn


def test_dynamic_gaussian_fit_logl_sample():
    df = ar_data(800)
    jd, td = _both(_ar_network)
    jd.fit(df)
    td.fit(df)
    assert td.fitted()
    cpd = td.transition_bn().cpd("a_t_0")
    np.testing.assert_allclose(cpd.beta, jd.transition_bn().cpd("a_t_0").beta,
                               **F64)
    assert abs(cpd.beta[1] - 0.7) < 0.1
    head = df.head(200)
    got = td.logl(head)
    np.testing.assert_allclose(got, jd.logl(head), **F64)
    assert td.slogl(head) == pytest.approx(np.nansum(got), rel=1e-12)
    sample = td.sample(100, seed=0).to_pandas()
    np.testing.assert_allclose(sample.to_numpy(),
                               jd.sample(100, seed=0).to_pandas().to_numpy(),
                               **F64)


def _spbn_dynamic(pkg):
    dbn = _ar_network(pkg, "DynamicSemiparametricBN")
    dbn.transition_bn().set_node_type("b_t_0", pkg.CKDEType())
    dbn.transition_bn().set_node_type("a_t_0", pkg.CKDEType())
    dbn.static_bn().set_node_type("b_t_1", pkg.CKDEType())
    return dbn


def test_dynamic_spbn_logl_matches_jax():
    """CKDE nodes in both the static and the transition network: the
    transition rows go through ``cpd.logl`` of each CKDE node."""
    df = ar_data(300)
    test = ar_data(60, seed=5)
    jd, td = _both(_spbn_dynamic)
    jd.fit(df)
    td.fit(df)
    assert type(td.transition_bn().cpd("b_t_0")) is tpb.CKDE
    np.testing.assert_allclose(td.logl(test), jd.logl(test), **F64)
    assert td.slogl(test) == pytest.approx(jd.slogl(test), rel=1e-12)
    carried = interop.fitted_network(**interop.network_state(jd))
    assert type(carried) is tpb.DynamicSemiparametricBN
    np.testing.assert_allclose(carried.logl(test), jd.logl(test), **F64)


def test_dynamic_spbn_float32():
    jd, td = _both(_spbn_dynamic)
    jd.fit(ar_data(300))
    td.fit(ar_data(300, dtype="float32"))
    np.testing.assert_allclose(td.logl(ar_data(60, seed=5, dtype="float32")),
                               jd.logl(ar_data(60, seed=5)), **F32)


def test_dynamic_clg_with_a_categorical_variable():
    rng = np.random.default_rng(4)
    n = 400
    regime = pd.Categorical(rng.choice(["lo", "hi"], n))
    s = np.zeros(n)
    for t in range(1, n):
        s[t] = 0.6 * s[t - 1] + (0.5 if regime[t] == "hi" else -0.5) + \
            rng.normal(0, 0.3)
    df = pd.DataFrame({"regime": regime, "s": s})

    def make(pkg):
        dbn = pkg.DynamicCLGNetwork(["regime", "s"], 1)
        dbn.transition_bn().add_arc("s_t_1", "s_t_0")
        dbn.transition_bn().add_arc("regime_t_0", "s_t_0")
        dbn.fit(df)
        return dbn

    jd, td = _both(make)
    assert type(td.transition_bn().cpd("s_t_0")) is tpb.CLinearGaussianCPD
    np.testing.assert_allclose(td.logl(df.head(80)), jd.logl(df.head(80)),
                               **F64)


def test_dynamic_pickle_roundtrip(tmp_path):
    df = ar_data(400)
    dbn = tpb.DynamicGaussianNetwork(["a", "b"], 1)
    dbn.transition_bn().add_arc("a_t_1", "a_t_0")
    dbn.fit(df)
    path = str(tmp_path / "dbn")
    dbn.save(path, include_cpd=True)
    loaded = tpb.load(path + ".pickle")
    assert loaded.fitted()
    np.testing.assert_allclose(loaded.logl(df.head(50)), dbn.logl(df.head(50)))


def test_dbn_variable_management():
    dbn = tpb.DynamicGaussianNetwork(["a", "b"], 2)
    assert dbn.markovian_order() == 2
    assert dbn.variables() == ["a", "b"]
    dbn.add_variable("c")
    assert dbn.contains_variable("c")
    assert "c_t_1" in dbn.static_bn().nodes()
    dbn.remove_variable("c")
    assert not dbn.contains_variable("c")
    assert "c_t_1" not in dbn.static_bn().nodes()


def test_dbn_save_load_include_cpd(tmp_path):
    rng = np.random.default_rng(0)
    ts = pd.DataFrame({"a": rng.normal(size=150), "b": rng.normal(size=150)})
    jd, td = _both(lambda pkg: pkg.DynamicGaussianNetwork(["a", "b"], 1))
    jd.fit(ts)
    td.fit(ts)
    path = str(tmp_path / "dbn.pkl")
    td.save(path, include_cpd=True)
    loaded = tpb.load(path)
    assert loaded.fitted()
    assert loaded.slogl(ts) == pytest.approx(jd.slogl(ts), rel=1e-9)
    path2 = str(tmp_path / "dbn_nocpd.pkl")
    td.save(path2, include_cpd=False)
    bare = tpb.load(path2)
    assert not bare.fitted()
    assert bare.variables() == td.variables()


def test_dbn_logl_routing():
    rng = np.random.default_rng(1)
    ts = pd.DataFrame({"a": rng.normal(size=120), "b": rng.normal(size=120)})
    test = pd.DataFrame({"a": rng.normal(size=30), "b": rng.normal(size=30)})
    jd, td = _both(lambda pkg: pkg.DynamicGaussianNetwork(["a", "b"], 2))
    jd.fit(ts)
    td.fit(ts)
    got = td.logl(test)
    assert len(got) == 30
    np.testing.assert_allclose(got, jd.logl(test), **F64)
    assert td.slogl(test) == pytest.approx(np.nansum(got), rel=1e-12)


# ------------------------------------------------ the row-routing oracle
def _lg_row(value, ev_values, beta, variance):
    return norm(beta[0] + np.dot(beta[1:], ev_values),
                np.sqrt(variance)).logpdf(value)


def _oracle_logl(dbn, test_df):
    """The first markovian_order rows by the static network (row i maps
    variable v to node ``v_t_{m-i}``), every later row by the transition
    network over a shifting window."""
    m = dbn.markovian_order()
    ll = np.zeros(len(test_df))
    head = test_df.head(m)
    for i in range(len(test_df)):
        for v in dbn.variables():
            if i < m:
                cpd = dbn.static_bn().cpd(f"{v}_t_{m - i}")
            else:
                cpd = dbn.transition_bn().cpd(f"{v}_t_0")
            ev_vals = []
            for e in cpd.evidence():
                g = re.search(r"(.*)_t_(\d+)", e)
                ev_vals.append(head.loc[m - int(g[2]), g[1]] if i < m
                               else test_df.loc[i - int(g[2]), g[1]])
            ll[i] += _lg_row(test_df.loc[i, v], ev_vals, cpd.beta,
                             cpd.variance)
    return ll


@pytest.fixture(scope="module")
def fitted_pair():
    def make(pkg):
        dbn = pkg.DynamicGaussianNetwork(VARS, 2)
        for s, t in [("a", "c"), ("b", "c"), ("c", "d")]:
            dbn.static_bn().add_arc(f"{s}_t_2", f"{t}_t_2")
            dbn.static_bn().add_arc(f"{s}_t_1", f"{t}_t_1")
        for v in VARS:
            dbn.transition_bn().add_arc(f"{v}_t_2", f"{v}_t_0")
            dbn.transition_bn().add_arc(f"{v}_t_1", f"{v}_t_0")
        dbn.fit(normal_chain_data(900, seed=21))
        return dbn

    with tpb.use_device("cpu"):
        return _both(make)


def test_fit_parts_lifecycle():
    df = normal_chain_data(300, seed=21)
    dbn = tpb.DynamicGaussianNetwork(VARS, 2)
    assert not dbn.fitted()
    ddf = tpb.DynamicDataFrame(df, 2)
    dbn.static_bn().fit(ddf.static_df())
    assert not dbn.fitted() and dbn.static_bn().fitted()
    dbn.transition_bn().fit(ddf.transition_df())
    assert dbn.fitted()


def test_logl_matches_row_routing_oracle(fitted_pair):
    jd, td = fitted_pair
    test = normal_chain_data(80, seed=22)
    got = td.logl(test)
    np.testing.assert_allclose(got, _oracle_logl(td, test), rtol=1e-7,
                               atol=1e-8)
    np.testing.assert_allclose(got, jd.logl(test), **F64)


def test_slogl_matches_oracle_sum(fitted_pair):
    jd, td = fitted_pair
    test = normal_chain_data(80, seed=23)
    assert td.slogl(test) == pytest.approx(_oracle_logl(td, test).sum(),
                                           rel=1e-8)
    assert td.slogl(test) == pytest.approx(jd.slogl(test), rel=1e-12)


# -------------------------------------------------------------- scores
def _discrete_series(n=300, seed=3):
    rng = np.random.default_rng(seed)
    x = np.empty(n, dtype=object)
    x[0] = "u"
    for t in range(1, n):
        keep = rng.random() < 0.8
        x[t] = x[t - 1] if keep else ("u" if x[t - 1] == "v" else "v")
    y = np.where(rng.random(n) < 0.5, "p", "q")
    return pd.DataFrame({"a": pd.Categorical(x.astype(str)),
                         "b": pd.Categorical(y)})


DYNAMIC_SCORES = {
    "bic": lambda pkg, ddf: pkg.DynamicBIC(ddf),
    "bge": lambda pkg, ddf: pkg.DynamicBGe(ddf),
    "bde": lambda pkg, ddf: pkg.DynamicBDe(ddf),
    "cv": lambda pkg, ddf: pkg.DynamicCVLikelihood(ddf, k=3, seed=0),
    "holdout": lambda pkg, ddf: pkg.DynamicHoldoutLikelihood(ddf, 0.3,
                                                             seed=0),
    "validated": lambda pkg, ddf: pkg.DynamicValidatedLikelihood(
        ddf, 0.3, 3, seed=0),
}
KDE_SCORES = ("cv", "holdout", "validated")


@pytest.mark.parametrize("name", list(DYNAMIC_SCORES))
def test_dynamic_scores_match_jax(name):
    """Each Dynamic* score's static and transition scores of the same
    families: linear-Gaussian nodes, CKDE nodes for the likelihoods,
    discrete nodes for BDe."""
    df = _discrete_series() if name == "bde" else ar_data(240, seed=3)
    scores = {}
    for pkg in (jpb, tpb):
        ddf = pkg.DynamicDataFrame(df, 1)
        score = DYNAMIC_SCORES[name](pkg, ddf)
        kind = {"bde": "DynamicDiscreteBN"}.get(
            name, "DynamicSemiparametricBN" if name in KDE_SCORES
            else "DynamicGaussianNetwork")
        dbn = getattr(pkg, kind)(["a", "b"], 1)
        static, trans = dbn.static_bn(), dbn.transition_bn()
        if name in KDE_SCORES:
            trans.set_node_type("b_t_0", pkg.CKDEType())
        st, tr = score.static_score(), score.transition_score()
        scores[pkg.__name__] = [
            st.local_score(static, "b_t_1", ["a_t_1"]),
            st.local_score(static, "a_t_1", []),
            tr.local_score(trans, "b_t_0", ["a_t_1", "b_t_1"]),
            tr.local_score(trans, "a_t_0", ["a_t_1"]),
        ]
        assert score.ToString() == f"Dynamic{type(st).__name__}"
    np.testing.assert_allclose(scores["pybnesian_tpu_torch"],
                               scores["pybnesian_tpu"], **F64)


def test_dynamic_score_adaptator_imports():
    """``DynamicScoreAdaptator`` reaches ``data.dynamic``, which the port
    lacked before."""
    from pybnesian_tpu_torch.learning.scores import DynamicScoreAdaptator

    ddf = tpb.DynamicDataFrame(ar_data(100), 1)
    score = DynamicScoreAdaptator(tpb.BIC, ddf)
    assert isinstance(score.static_score(), tpb.BIC)
    assert score.has_variables(["a_t_0"])
    with pytest.raises(TypeError):
        DynamicScoreAdaptator(tpb.BIC, ar_data(100))
