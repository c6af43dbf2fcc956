"""Pickle round trips of the torch port, after
tests/serialization/test_serialization.py: every fitted factor and network
type of the port goes through ``save``/``load`` (networks with
``include_cpd=True``) and evaluates as before, and as the JAX package's
object fitted on the same frame does (float64 rtol 1e-9 / atol 1e-7)."""

import pickle

import numpy as np
import pytest

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb

from data_gen import discrete_data, mixed_data, normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

F64 = dict(rtol=1e-9, atol=1e-7)


def roundtrip(obj):
    return pickle.loads(pickle.dumps(obj))


FACTORS = {
    "LinearGaussianCPD": (lambda pkg: pkg.LinearGaussianCPD("b", ["a"]),
                          normal_chain_data),
    "CKDE": (lambda pkg: pkg.CKDE("b", ["a"]), normal_chain_data),
    "CKDE-ucv": (lambda pkg: pkg.CKDE("b", ["a"], pkg.UCV()),
                 normal_chain_data),
    "DiscreteFactor": (lambda pkg: pkg.DiscreteFactor("B", ["A"]),
                       discrete_data),
    "CLinearGaussianCPD": (lambda pkg: pkg.CLinearGaussianCPD(
        "Y", ["X", "B"]), mixed_data),
    "HCKDE": (lambda pkg: pkg.HCKDE("Y", ["X", "A"]), mixed_data),
    "HCKDE-discrete-only": (lambda pkg: pkg.HCKDE("Y", ["A"]), mixed_data),
}


@pytest.mark.parametrize("name", list(FACTORS))
def test_fitted_factor_roundtrip(name):
    make, data = FACTORS[name]
    df = data(300)
    jf, tf = make(jpb), make(tpb)
    jf.fit(df)
    tf.fit(df)
    copy = roundtrip(tf)
    assert type(copy) is type(tf) and copy.fitted()
    got = np.asarray(copy.logl(df))
    np.testing.assert_allclose(got, np.asarray(tf.logl(df)), equal_nan=True,
                               rtol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jf.logl(df)), equal_nan=True,
                               **F64)


@pytest.mark.parametrize("cls", ["KDE", "ProductKDE"])
def test_kde_models_roundtrip(cls):
    df, test = normal_chain_data(200), normal_chain_data(40, seed=9)
    model = getattr(tpb, cls)(["a", "b"])
    model.fit(df)
    np.testing.assert_allclose(roundtrip(model).logl(test), model.logl(test),
                               rtol=1e-12)


def _het(pkg, nodes, arcs):
    return pkg.HeterogeneousBN(
        {"categorical": [pkg.DiscreteFactorType()],
         "float64": [pkg.LinearGaussianCPDType(), pkg.CKDEType()]},
        nodes, arcs)


CHAIN = (["a", "b", "c", "d"], [("a", "b"), ("b", "c")])
MIXED = (["A", "B", "X", "Y"], [("A", "X"), ("X", "Y"), ("B", "Y")])
NETWORKS = {
    "GaussianNetwork": (lambda pkg: pkg.GaussianNetwork(*CHAIN),
                        normal_chain_data),
    "KDENetwork": (lambda pkg: pkg.KDENetwork(*CHAIN), normal_chain_data),
    "SemiparametricBN": (lambda pkg: pkg.SemiparametricBN(
        *CHAIN, [("b", pkg.CKDEType())]), normal_chain_data),
    "SemiparametricBN-hybrid": (lambda pkg: pkg.SemiparametricBN(
        *MIXED, [("A", pkg.DiscreteFactorType()),
                 ("B", pkg.DiscreteFactorType()), ("X", pkg.CKDEType()),
                 ("Y", pkg.CKDEType())]), mixed_data),
    "DiscreteBN": (lambda pkg: pkg.DiscreteBN(["A", "B", "C"], [("A", "B")]),
                   discrete_data),
    "CLGNetwork": (lambda pkg: pkg.CLGNetwork(*MIXED), mixed_data),
    "HomogeneousBN": (lambda pkg: pkg.HomogeneousBN(
        pkg.LinearGaussianCPDType(), *CHAIN), normal_chain_data),
    "HeterogeneousBN": (lambda pkg: _het(pkg, *MIXED), mixed_data),
    "ConditionalGaussianNetwork": (lambda pkg: pkg.ConditionalGaussianNetwork(
        ["c", "d"], ["a", "b"], [("a", "c"), ("b", "c"), ("c", "d")]),
        normal_chain_data),
    "ConditionalKDENetwork": (lambda pkg: pkg.ConditionalKDENetwork(
        ["c", "d"], ["a"], [("a", "c"), ("c", "d")]), normal_chain_data),
    "ConditionalSemiparametricBN": (
        lambda pkg: pkg.ConditionalSemiparametricBN(
            ["c", "d"], ["a"], [("a", "c"), ("c", "d")],
            node_types=[("c", pkg.CKDEType())]), normal_chain_data),
    "ConditionalCLGNetwork": (lambda pkg: pkg.ConditionalCLGNetwork(
        ["B", "Y"], ["X"], [("B", "Y"), ("X", "Y")]), mixed_data),
    "ConditionalDiscreteBN": (lambda pkg: pkg.ConditionalDiscreteBN(
        ["B", "C"], ["A"], [("A", "B"), ("B", "C")]), discrete_data),
    "ConditionalHomogeneousBN": (lambda pkg: pkg.ConditionalHomogeneousBN(
        pkg.CKDEType(), ["c"], ["a", "b"], [("a", "c")]), normal_chain_data),
    "ConditionalHeterogeneousBN": (
        lambda pkg: pkg.ConditionalHeterogeneousBN(
            [pkg.CKDEType()], ["c"], ["a"], [("a", "c")]), normal_chain_data),
}


@pytest.mark.parametrize("name", list(NETWORKS))
def test_fitted_network_save_load(name, tmp_path):
    make, data = NETWORKS[name]
    df = data(300)
    jm, tm = make(jpb), make(tpb)
    jm.fit(df)
    tm.fit(df)
    path = str(tmp_path / "net")
    tm.save(path, include_cpd=True)
    loaded = tpb.load(path + ".pickle")
    assert type(loaded) is type(tm) and loaded.fitted()
    assert loaded.type() == tm.type()
    assert set(loaded.arcs()) == set(tm.arcs())
    got = loaded.logl(df)
    np.testing.assert_allclose(got, tm.logl(df), equal_nan=True, rtol=1e-12)
    np.testing.assert_allclose(got, jm.logl(df), equal_nan=True, **F64)
    tm.save(str(tmp_path / "bare"), include_cpd=False)
    assert not tpb.load(str(tmp_path / "bare.pickle")).fitted()


def _dynamic(kind, variables):
    def make(pkg):
        if kind == "DynamicHomogeneousBN":
            dbn = pkg.DynamicHomogeneousBN(pkg.LinearGaussianCPDType(),
                                           variables, 1)
        elif kind == "DynamicHeterogeneousBN":
            dbn = pkg.DynamicHeterogeneousBN([pkg.CKDEType()], variables, 1)
        else:
            dbn = getattr(pkg, kind)(variables, 1)
        a, b = variables[0], variables[-1]
        dbn.transition_bn().add_arc(f"{a}_t_1", f"{a}_t_0")
        dbn.transition_bn().add_arc(f"{a}_t_0", f"{b}_t_0")
        return dbn
    return make


DYNAMIC = {
    "DynamicGaussianNetwork": (["a", "b"], normal_chain_data),
    "DynamicKDENetwork": (["a", "b"], normal_chain_data),
    "DynamicSemiparametricBN": (["a", "b"], normal_chain_data),
    "DynamicDiscreteBN": (["A", "B"], discrete_data),
    "DynamicCLGNetwork": (["A", "X"], mixed_data),
    "DynamicHomogeneousBN": (["a", "b"], normal_chain_data),
    "DynamicHeterogeneousBN": (["a", "b"], normal_chain_data),
}


@pytest.mark.parametrize("kind", list(DYNAMIC))
def test_fitted_dynamic_network_save_load(kind, tmp_path):
    variables, data = DYNAMIC[kind]
    df = data(200)[variables]
    make = _dynamic(kind, variables)
    jd, td = make(jpb), make(tpb)
    jd.fit(df)
    td.fit(df)
    path = str(tmp_path / "dbn")
    td.save(path, include_cpd=True)
    loaded = tpb.load(path + ".pickle")
    assert type(loaded) is type(td) and loaded.fitted()
    got = loaded.logl(df.head(60))
    np.testing.assert_allclose(got, td.logl(df.head(60)), rtol=1e-12)
    np.testing.assert_allclose(got, jd.logl(df.head(60)), **F64)


def test_selectors_scores_graphs_and_kdtree_pickle():
    for sel in (tpb.NormalReferenceRule(), tpb.ScottsBandwidth(), tpb.UCV()):
        assert type(roundtrip(sel)) is type(sel)
    df = normal_chain_data(100)
    s = tpb.BIC(df)
    m = tpb.GaussianNetwork(["a", "b", "c", "d"])
    assert roundtrip(s).local_score(m, "b", ["a"]) == pytest.approx(
        s.local_score(m, "b", ["a"]), rel=1e-12)
    assert roundtrip(tpb.Dag(["a", "b"], [("a", "b")])).has_arc("a", "b")
    assert roundtrip(tpb.UndirectedGraph.Complete(["x", "y", "z"])
                     ).num_edges() == 3
    tree = tpb.KDTree(df)
    dist, idx = roundtrip(tree).query(df.head(5), k=2)
    want_dist, want_idx = tree.query(df.head(5), k=2)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(dist, want_dist)
