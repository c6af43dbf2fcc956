"""Discrete BIC, BDe and BGe of the torch port against the JAX package's.

Float64 on the CPU, data from a numpy seed: categorical columns of ragged
cardinalities (2, 3, 4, 5), with and without nulls, families of 0–3
parents. The batched tensor functions (``ops/discrete.py``) are held to
the JAX ones, and the scores to the JAX scores, rtol 1e-9; the port's two
tiers — the native counting core on the host and the batched count on the
device — are held to each other. The native core is built through the
port's loader: a machine that cannot build it fails these tests.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import pybnesian_tpu as pj
import pybnesian_tpu_torch as pt
from pybnesian_tpu.ops import discrete as jdisc
from pybnesian_tpu_torch.learning.scores import discrete_native
from pybnesian_tpu_torch.ops import discrete as tdisc

from data_gen import normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

RTOL = 1e-9
CARDS = {"A": 2, "B": 3, "C": 4, "D": 5, "E": 3}
FAMILIES = [("A", []), ("B", ["A"]), ("C", ["A", "B"]), ("D", ["C"]),
            ("E", ["A", "B", "C"]), ("A", ["D", "E"]), ("D", []),
            ("B", ["E", "D", "A"])]


def _frame(n=600, seed=0, nulls=False):
    rng = np.random.default_rng(seed)
    codes = {}
    prev = rng.integers(0, 2, n)
    for name, k in CARDS.items():
        cur = np.where(rng.random(n) < 0.4, rng.integers(0, k, n), prev % k)
        codes[name] = cur
        prev = cur
    if nulls:
        for i, name in enumerate(codes):
            codes[name] = np.where(rng.random(n) < 0.03 * (i + 1), -1,
                                   codes[name])
    return pd.DataFrame({
        name: pd.Categorical.from_codes(c, [f"{name}{j}"
                                            for j in range(CARDS[name])])
        for name, c in codes.items()
    })


def _index_arrays(fams, names):
    pos = {c: i for i, c in enumerate(names)}
    P = max(len(ps) for _, ps in fams)
    var_idx = np.array([pos[v] for v, _ in fams])
    parent_idx = np.zeros((len(fams), P), np.int64)
    parent_mask = np.zeros((len(fams), P))
    for f, (_, ps) in enumerate(fams):
        for j, p in enumerate(ps):
            parent_idx[f, j] = pos[p]
            parent_mask[f, j] = 1.0
    return var_idx, parent_idx, parent_mask


def test_native_core_builds():
    assert discrete_native.available(), discrete_native.load_error()
    assert discrete_native.load_error() is None


@pytest.mark.parametrize("nulls", [False, True], ids=["full", "nulls"])
@pytest.mark.parametrize("block", [1 << 25, 1500], ids=["one-block", "blocks"])
def test_batched_functions_match_jax(nulls, block, monkeypatch):
    monkeypatch.setattr(tdisc, "_COUNT_BLOCK", block)
    df = _frame(nulls=nulls)
    names = list(df.columns)
    codes = np.column_stack([df[c].cat.codes.to_numpy() for c in names])
    cards = np.array([CARDS[c] for c in names])
    var_idx, parent_idx, parent_mask = _index_arrays(FAMILIES, names)
    j_args = (jnp.asarray(codes, jnp.int32), jnp.asarray(cards, jnp.int32),
              jnp.asarray(var_idx, jnp.int32),
              jnp.asarray(parent_idx, jnp.int32), jnp.asarray(parent_mask))
    t_args = (torch.as_tensor(codes, dtype=torch.int32),
              torch.as_tensor(cards), torch.as_tensor(var_idx),
              torch.as_tensor(parent_idx), torch.as_tensor(parent_mask))
    # the JAX functions want power-of-two bounds, the port's exact ones
    want = jdisc.batched_bic_discrete(*j_args, max_cells=128,
                                      max_pconfigs=64)
    got = tdisc.batched_bic_discrete(*t_args, max_cells=90, max_pconfigs=30)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    for iss in (1.0, 7.5):
        want = jdisc.batched_bde(*j_args, iss, max_cells=128,
                                 max_pconfigs=64)
        got = tdisc.batched_bde(*t_args, iss, max_cells=90, max_pconfigs=30)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_counts_are_exact_and_nulls_go_to_the_overflow_bin():
    df = _frame(n=300, nulls=True)
    names = list(df.columns)
    codes = np.column_stack([df[c].cat.codes.to_numpy() for c in names])
    var_idx, parent_idx, parent_mask = _index_arrays([("C", ["A", "B"])],
                                                     names)
    counts, pcounts, ncells, npconf, vcard = tdisc._family_counts(
        torch.as_tensor(codes), torch.as_tensor([CARDS[c] for c in names]),
        torch.as_tensor(var_idx), torch.as_tensor(parent_idx),
        torch.as_tensor(parent_mask), 24, 6)
    assert counts.dtype == torch.int64
    ok = (codes[:, :3] >= 0).all(axis=1)
    a, b, c = codes[ok, 0], codes[ok, 1], codes[ok, 2]
    want = np.bincount(c + 4 * (a + 2 * b), minlength=24)
    np.testing.assert_array_equal(counts[0].numpy(), want)
    np.testing.assert_array_equal(pcounts[0].numpy(),
                                  want.reshape(6, 4).sum(axis=1))
    assert (int(ncells), int(npconf), int(vcard)) == (24, 6, 4)
    assert int(counts.sum()) == int(ok.sum()) < 300


def _models(names):
    return pj.DiscreteBN(names), pt.DiscreteBN(names)


@pytest.mark.parametrize("route", ["native", "device"])
@pytest.mark.parametrize("nulls", [False, True], ids=["full", "nulls"])
def test_bic_discrete_matches_jax(nulls, route):
    df = _frame(nulls=nulls)
    jmodel, tmodel = _models(list(df.columns))
    want = pj.BIC(df).local_score_batch(jmodel, FAMILIES)
    score = pt.BIC(df, native=route == "native")
    got = score.local_score_batch(tmodel, FAMILIES)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    singles = [score.local_score(tmodel, v, ps) for v, ps in FAMILIES]
    np.testing.assert_allclose(singles, want, rtol=RTOL)
    assert (score._disc_cache is None) == (route == "native")


@pytest.mark.parametrize("route", ["native", "device"])
@pytest.mark.parametrize("iss", [1.0, 10.0])
@pytest.mark.parametrize("nulls", [False, True], ids=["full", "nulls"])
def test_bde_matches_jax(nulls, iss, route):
    df = _frame(nulls=nulls)
    jmodel, tmodel = _models(list(df.columns))
    want = pj.BDe(df, iss=iss).local_score_batch(jmodel, FAMILIES)
    score = pt.BDe(df, iss=iss, native=route == "native")
    got = score.local_score_batch(tmodel, FAMILIES)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    singles = [score.local_score(tmodel, v, ps) for v, ps in FAMILIES]
    np.testing.assert_allclose(singles, want, rtol=RTOL)
    assert (score._codes_cache is None) == (route == "native")


def test_large_frames_go_to_the_device_by_the_rule(monkeypatch):
    limit = discrete_native.NATIVE_BELOW_ROW_ITEMS
    assert not discrete_native.takes_frame(limit // 100, 10)
    assert discrete_native.takes_frame(limit // 100 - 1, 10)
    # a score decides once, from its frame, and keeps its tier
    df = _frame(n=100)
    tmodel = pt.DiscreteBN(list(df.columns))
    for make in (pt.BIC, pt.BDe):
        small, large = make(df), make(df)
        monkeypatch.setattr(discrete_native, "NATIVE_BELOW_ROW_ITEMS",
                            100 * 5 * 5)
        assert not large.native_tier()
        monkeypatch.setattr(discrete_native, "NATIVE_BELOW_ROW_ITEMS",
                            100 * 5 * 5 + 1)
        assert small.native_tier() and not large.native_tier()
        np.testing.assert_allclose(
            small.local_score_batch(tmodel, FAMILIES),
            large.local_score_batch(tmodel, FAMILIES), rtol=RTOL)
        monkeypatch.setattr(discrete_native, "NATIVE_BELOW_ROW_ITEMS", 0)
        assert small.native_tier()


def test_families_the_core_declines_go_to_the_device(monkeypatch):
    """A configuration space past the core's limit comes back NaN from it
    and is scored on the device, in the batch's positions."""
    monkeypatch.setattr(discrete_native, "MAX_CONFIGS", 20)
    df = _frame()
    jmodel, tmodel = _models(list(df.columns))
    for jscore, tscore in ((pj.BIC(df), pt.BIC(df)),
                           (pj.BDe(df), pt.BDe(df))):
        got = tscore.local_score_batch(tmodel, FAMILIES)
        np.testing.assert_allclose(
            got, jscore.local_score_batch(jmodel, FAMILIES), rtol=RTOL)


def test_continuous_parent_is_minus_inf_and_wrong_types_raise():
    rng = np.random.default_rng(0)
    df = _frame(n=200)
    df["x"] = rng.normal(size=200)
    tmodel = pt.DiscreteBN(list(CARDS))
    dt = pt.DiscreteFactorType()
    for score in (pt.BIC(df), pt.BDe(df)):
        assert score.local_score_node_type(tmodel, dt, "A", ["x"]) == -np.inf
        assert score.local_score_node_type(tmodel, dt, "A", ["B", "x"]) \
            == -np.inf
    with pytest.raises(ValueError, match="not valid for score BDe"):
        pt.BDe(df).local_score_node_type(
            tmodel, pt.LinearGaussianCPDType(), "x", [])


def test_interop_carries_scores_and_a_discrete_start_model():
    from pybnesian_tpu_torch import interop

    df = _frame(n=300)
    names = list(df.columns)
    arcs = [("A", "B"), ("B", "C")]
    jmodel = pj.DiscreteBN(names, arcs)
    tmodel = interop.network("DiscreteBN", names, jmodel.arcs())
    assert isinstance(tmodel, pt.DiscreteBN) and tmodel.arcs() == arcs
    jscore = pj.BDe(df, iss=3.5)
    state = interop.score_state(jscore)
    assert state == {"kind": "BDe", "iss": 3.5}
    tscore = interop.score(df, **state)
    np.testing.assert_allclose(tscore.score(tmodel), jscore.score(jmodel),
                               rtol=RTOL)
    cont = normal_chain_data(120)
    jbge = pj.BGe(cont, iss_mu=2.0, iss_w=9.0, nu=[0.0, 0.5, 1.0, 1.5])
    tbge = interop.score(cont, **interop.score_state(jbge))
    assert isinstance(tbge, pt.BGe) and tbge.iss_w == 9.0
    jg, tg = pj.GaussianNetwork(list(cont)), pt.GaussianNetwork(list(cont))
    np.testing.assert_allclose(tbge.score(tg), jbge.score(jg), rtol=RTOL)
    assert interop.score_state(pj.BIC(df)) == {"kind": "BIC"}


def test_string_scores_build_the_new_classes():
    from pybnesian_tpu_torch.learning.algorithms.options import (
        check_valid_score)

    df = _frame(n=50)
    assert isinstance(check_valid_score(df, pt.DiscreteBNType(), "bde"),
                      pt.BDe)
    assert isinstance(check_valid_score(df, pt.DiscreteBNType(), "bic"),
                      pt.BIC)
    cont = normal_chain_data(50)
    assert isinstance(check_valid_score(cont, pt.GaussianNetworkType(),
                                        "bge"), pt.BGe)
    assert pt.BDe(df).ToString() == "BDe" and pt.BGe(cont).ToString() == "BGe"


BGE_FAMILIES = [("a", []), ("b", ["a"]), ("c", ["a", "b"]),
                ("d", ["a", "b", "c"]), ("a", ["d"])]


@pytest.mark.parametrize("nulls", [False, True], ids=["full", "nulls"])
@pytest.mark.parametrize("prior", ["default", "given"])
def test_bge_matches_jax(nulls, prior):
    df = normal_chain_data(300)
    if nulls:
        df.loc[np.arange(0, 300, 9), "b"] = np.nan
        df.loc[np.arange(2, 300, 13), "d"] = np.nan
    kw = {} if prior == "default" else dict(
        iss_mu=2.5, iss_w=7.0, nu=[0.1, -0.2, 0.3, 0.0])
    names = list(df.columns)
    jmodel, tmodel = pj.GaussianNetwork(names), pt.GaussianNetwork(names)
    want = pj.BGe(df, **kw).local_score_batch(jmodel, BGE_FAMILIES)
    got = pt.BGe(df, **kw).local_score_batch(tmodel, BGE_FAMILIES)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.all(np.isfinite(got))


def test_bge_checks_its_prior():
    df = normal_chain_data(40)
    with pytest.raises(ValueError, match="Wishart"):
        pt.BGe(df, iss_w=2.0)
    with pytest.raises(ValueError, match="nu"):
        pt.BGe(df, nu=[0.0, 1.0])
    with pytest.raises(ValueError, match="not valid for score BGe"):
        pt.BGe(df).local_score_node_type(
            pt.GaussianNetwork(list(df.columns)), pt.CKDEType(), "a", [])
