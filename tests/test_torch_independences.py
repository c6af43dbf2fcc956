"""The torch port's host independence tests (``LinearCorrelation``,
``ChiSquare``, ``MutualInformation`` and their ``Dynamic*`` forms) against
the JAX package, on the cases of tests/learning/test_independence_nulls.py,
test_dynamic_independence.py, test_pvalue_batch.py and
test_pvalue_batch_discrete.py.

The same seeded frames go through both packages: continuous, discrete and
mixed, with nulls. Every p-value and statistic agrees to 1e-9, and each
test's ``pvalue_batch`` agrees with its ``pvalue``.
"""

import numpy as np
import pandas as pd
import pytest

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu_torch.learning.scores import discrete_native

from data_gen import (discrete_data, mixed_data, normal_chain_data,
                      normal_indep_data, with_nulls)
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

P = dict(rtol=1e-9, atol=1e-12)


def _disc_df(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, n)
    b = np.where(rng.random(n) < 0.4, rng.integers(0, 3, n), a)
    c = rng.integers(0, 4, n)
    d = np.where(rng.random(n) < 0.5, rng.integers(0, 3, n), b)
    df = pd.DataFrame({k: pd.Categorical(v.astype(str))
                       for k, v in dict(a=a, b=b, c=c, d=d).items()})
    df.loc[::31, "b"] = None
    return df


def _mixed_disc_df():
    df = _disc_df()
    rng = np.random.default_rng(3)
    df["x"] = rng.normal(0, 1, len(df)) + 0.4 * df["a"].cat.codes.to_numpy()
    df["y"] = 0.7 * df["x"] + rng.normal(0, 1, len(df))
    return df


CONT_TRIPLES = [("a", "b", ()), ("a", "d", ()), ("a", "d", ("c",)),
                ("a", "c", ("b",)), ("a", "d", ("b", "c")),
                ("b", "d", ("c",))]
DISC_TRIPLES = [("a", "b", ()), ("a", "c", ()), ("b", "d", ("a",)),
                ("a", "d", ("b", "c")), ("c", "d", ("a", "b"))]
MIXED_TRIPLES = DISC_TRIPLES + [("a", "x", ()), ("x", "b", ("a",)),
                                ("x", "y", ()), ("x", "y", ("a",)),
                                ("y", "c", ("x", "b"))]


def _frame(name):
    return {
        "continuous": lambda: normal_chain_data(1500),
        "continuous-nulls": lambda: with_nulls(normal_chain_data(1500), 0.1),
        "discrete": _disc_df,
        "mixed": _mixed_disc_df,
        "mixed-nulls": lambda: with_nulls(mixed_data(1500), 0.1),
    }[name]()


CASES = [
    ("LinearCorrelation", "continuous", CONT_TRIPLES),
    ("LinearCorrelation", "continuous-nulls", CONT_TRIPLES),
    ("ChiSquare", "discrete", DISC_TRIPLES),
    ("MutualInformation", "continuous", CONT_TRIPLES),
    ("MutualInformation", "discrete", DISC_TRIPLES),
    ("MutualInformation", "mixed", MIXED_TRIPLES),
    ("MutualInformation", "mixed-nulls",
     [("A", "X", ()), ("X", "Y", ("B",)), ("A", "B", ("X",)),
      ("X", "Y", ())]),
]


@pytest.mark.parametrize("cls,frame,triples", CASES,
                         ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_pvalues_match_jax_and_batch(cls, frame, triples):
    df = _frame(frame)
    jt, tt = getattr(jpb, cls)(df), getattr(tpb, cls)(df)
    got = np.array([tt.pvalue(x, y, *z) for x, y, z in triples])
    want = np.array([jt.pvalue(x, y, *z) for x, y, z in triples])
    assert np.all((got >= 0) & (got <= 1))
    np.testing.assert_allclose(got, want, **P)
    np.testing.assert_allclose(tt.pvalue_batch(triples), got, **P)
    np.testing.assert_allclose(tt.pvalue_batch(triples),
                               jt.pvalue_batch(triples), **P)


def test_independence_tests_subclass_the_port_base():
    for cls in (tpb.LinearCorrelation, tpb.ChiSquare, tpb.MutualInformation):
        assert issubclass(cls, tpb.IndependenceTest)
    df = normal_chain_data(100)
    lc = tpb.LinearCorrelation(df)
    assert lc.variable_names() == ["a", "b", "c", "d"]
    assert lc.num_variables() == 4 and lc.name(0) == "a"
    assert lc.has_variables(["a", "d"]) and not lc.has_variables(["e"])


def test_default_pvalue_batch_is_serial_loop():
    class Scripted(tpb.IndependenceTest):
        def pvalue(self, x, y, *z):
            return 0.1 * len(z) + (0.5 if x == "a" else 0.2)

    got = Scripted().pvalue_batch([("a", "b", ()), ("c", "b", ("a",))])
    np.testing.assert_allclose(got, [0.5, 0.3])


def test_linearcorrelation_with_nulls_matches_clean_subset():
    df = with_nulls(normal_chain_data(2000), frac=0.1)
    test = tpb.LinearCorrelation(df)
    clean = tpb.LinearCorrelation(df[["a", "b"]].dropna())
    np.testing.assert_allclose(test.pvalue("a", "b"), clean.pvalue("a", "b"),
                               rtol=1e-9)
    clean3 = tpb.LinearCorrelation(df[["a", "d", "c"]].dropna())
    np.testing.assert_allclose(test.pvalue("a", "d", "c"),
                               clean3.pvalue("a", "d", "c"), rtol=1e-9)
    assert not test._cached


def test_linearcorrelation_matches_scipy_pearson():
    from scipy.stats import pearsonr

    df = normal_chain_data(500)
    _, p = pearsonr(df["a"], df["b"])
    np.testing.assert_allclose(tpb.LinearCorrelation(df).pvalue("a", "b"), p,
                               rtol=1e-6)


def test_linearcorrelation_detects_chain():
    test = tpb.LinearCorrelation(normal_chain_data(3000))
    assert test.pvalue("a", "b") < 1e-10
    assert test.pvalue("a", "d") < 1e-6
    assert test.pvalue("a", "d", "c") > 0.01
    assert tpb.LinearCorrelation(normal_indep_data(2000)).pvalue("a", "b") > 0.01


def test_chisquare_with_nulls_matches_clean_subset_and_jax():
    df = discrete_data(3000)
    mask = np.random.default_rng(3).random(len(df)) < 0.1
    col = df["A"].astype(object)
    col[mask] = None
    df["A"] = pd.Categorical(col)
    test = tpb.ChiSquare(df)
    clean = tpb.ChiSquare(df.dropna())
    np.testing.assert_allclose(test.pvalue("A", "B"), clean.pvalue("A", "B"),
                               rtol=1e-9)
    np.testing.assert_allclose(test.pvalue("A", "D", "C"),
                               jpb.ChiSquare(df).pvalue("A", "D", "C"), **P)


def test_chisquare_matches_scipy():
    from scipy.stats import chi2_contingency

    df = discrete_data(2000)
    _, p, _, _ = chi2_contingency(pd.crosstab(df["A"], df["B"]),
                                  correction=False)
    np.testing.assert_allclose(tpb.ChiSquare(df).pvalue("A", "B"), p,
                               rtol=1e-8)


def test_hybrid_mutualinformation_with_nulls():
    df = with_nulls(mixed_data(2000), frac=0.1)
    test, ref = tpb.MutualInformation(df), jpb.MutualInformation(df)
    clean = tpb.MutualInformation(df[["X", "Y"]].dropna())
    np.testing.assert_allclose(test.mi("X", "Y"), clean.mi("X", "Y"),
                               rtol=1e-9)
    for args in (("X", "Y"), ("A", "X"), ("X", "Y", "B"), ("A", "Y", "X")):
        np.testing.assert_allclose(test.mi(*args), ref.mi(*args), **P)


@pytest.mark.parametrize("asymptotic_df", [True, False])
def test_mutualinformation_options_match_jax(asymptotic_df):
    df = mixed_data(800)
    kw = dict(asymptotic_df=asymptotic_df)
    tt, jt = tpb.MutualInformation(df, **kw), jpb.MutualInformation(df, **kw)
    for args in (("A", "X"), ("X", "Y", "A"), ("A", "B", "X")):
        np.testing.assert_allclose(tt.pvalue(*args), jt.pvalue(*args), **P)


def test_chisquare_native_batch_matches_serial():
    assert discrete_native.available(), discrete_native.load_error()
    t = tpb.ChiSquare(_disc_df())
    serial = np.array([t.pvalue(x, y, *zs) for x, y, zs in DISC_TRIPLES])
    np.testing.assert_allclose(t.pvalue_batch(DISC_TRIPLES), serial,
                               rtol=1e-10, atol=1e-300)


# ------------------------------------------------------------------ dynamic
def continuous_series(n=600, seed=13):
    rng = np.random.default_rng(seed)
    a = np.zeros(n)
    b = np.zeros(n)
    for t in range(1, n):
        a[t] = 0.7 * a[t - 1] + rng.normal(0, 0.5)
        b[t] = 0.5 * a[t - 1] + rng.normal(0, 0.5)
    return pd.DataFrame({"a": a, "b": b})


def discrete_series(n=800, seed=3):
    rng = np.random.default_rng(seed)
    x = np.empty(n, dtype=object)
    x[0] = "u"
    for t in range(1, n):
        keep = rng.random() < 0.8
        x[t] = x[t - 1] if keep else ("u" if x[t - 1] == "v" else "v")
    y = np.where(rng.random(n) < 0.5, "p", "q")
    return pd.DataFrame({"x": pd.Categorical(x.astype(str)),
                         "y": pd.Categorical(y)})


DYNAMIC = [
    ("DynamicLinearCorrelation", continuous_series,
     [("a_t_1", "b_t_1", ())], [("b_t_0", "a_t_1", ()),
                                ("a_t_0", "b_t_0", ("a_t_1",))]),
    ("DynamicMutualInformation", continuous_series,
     [("a_t_1", "b_t_1", ())], [("b_t_0", "a_t_1", ()),
                                ("a_t_0", "b_t_0", ("a_t_1",))]),
    ("DynamicChiSquare", discrete_series,
     [("x_t_1", "y_t_1", ())], [("x_t_0", "x_t_1", ()),
                                ("y_t_0", "x_t_1", ())]),
]


@pytest.mark.parametrize("cls,series,static,transition", DYNAMIC,
                         ids=[c for c, *_ in DYNAMIC])
def test_dynamic_tests_match_jax(cls, series, static, transition):
    df = series()
    tt = getattr(tpb, cls)(tpb.DynamicDataFrame(df, 1))
    jt = getattr(jpb, cls)(jpb.DynamicDataFrame(df, 1))
    assert tt.markovian_order() == 1
    assert isinstance(tt, tpb.DynamicIndependenceTest)
    for part, triples in (("static_tests", static),
                          ("transition_tests", transition)):
        got = np.array([getattr(tt, part)().pvalue(x, y, *z)
                        for x, y, z in triples])
        want = np.array([getattr(jt, part)().pvalue(x, y, *z)
                         for x, y, z in triples])
        np.testing.assert_allclose(got, want, **P)
    # the series' strongest lag is found in the transition slice
    assert tt.transition_tests().pvalue(*transition[0][:2]) < 1e-6


# ------------------------------------------------------------------- KDTree
@pytest.mark.parametrize("p", [1.0, 2.0, np.inf])
def test_kdtree_matches_jax(p):
    df = with_nulls(normal_chain_data(300), 0.05)
    test = normal_chain_data(40, seed=2)
    got = tpb.KDTree(df[["a", "b", "c"]]).query(test[["a", "b", "c"]], k=3,
                                                p=p)
    want = jpb.KDTree(df[["a", "b", "c"]]).query(test[["a", "b", "c"]], k=3,
                                                 p=p)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)


def test_kdtree_ball_counts_match_jax():
    df = normal_chain_data(200)
    eps = np.random.default_rng(1).uniform(0.2, 1.0, 200)
    args = (df[["c"]], df["a"].to_numpy(), df["b"].to_numpy(), eps)
    got = tpb.KDTree(df[["c"]]).count_ball_subspaces(*args)
    want = jpb.KDTree(df[["c"]]).count_ball_subspaces(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
