"""The torch port's k-NN estimates (``ops/knn.py``) and KMutualInformation
against the JAX package, on the CPU.

The same seeded ranks go through every function of both ``ops/knn.py``
modules in float64, to 1e-12. KMutualInformation's ``mi``, ``pvalue`` and
``pvalue_batch`` get the same frame (N = 240) in both packages: the
estimates agree to 1e-12 and the p-values are equal, since both packages
draw the same shuffles (numpy's per-test ``default_rng(seed)``, and the
native ``lgf_local_shuffle``, whose presence on both sides is asserted).
One JAX run per case is shared by the module's tests.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu.models.base import _lgfast_mod as jax_lgfast
from pybnesian_tpu.ops import knn as jknn
from pybnesian_tpu_torch.models.base import _lgfast_mod as torch_lgfast
from pybnesian_tpu_torch.ops import knn as tknn

from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

EST = dict(rtol=1e-12, atol=1e-12)
K = 5
N = 120


def _ranks(a):
    out = np.empty(len(a))
    out[np.argsort(a, kind="stable")] = np.arange(len(a))
    return out


@pytest.fixture(scope="module")
def ranks():
    rng = np.random.default_rng(11)
    x = rng.normal(size=N)
    y = x + rng.normal(size=N)
    z = np.column_stack([y + rng.normal(size=N), rng.normal(size=N)])
    xr, yr = _ranks(x), _ranks(y)
    zr = np.column_stack([_ranks(c) for c in z.T])
    dz = np.max(np.abs(zr[:, None, :] - zr[None, :, :]), axis=2)
    xs = np.stack([rng.permutation(xr) for _ in range(9)])
    return xr, yr, dz, xs


def _both(name, *arrays):
    want = np.asarray(getattr(jknn, name)(*map(jnp.asarray, arrays), K))
    got = getattr(tknn, name)(*map(torch.from_numpy, arrays), K).numpy()
    return got, want


@pytest.mark.parametrize("name, args", [
    ("cmi_knn_pair", lambda r: (r[0], r[1])),
    ("cmi_knn_conditional", lambda r: (r[0], r[1], r[2])),
    ("cmi_knn_pair_batch", lambda r: (r[3], r[1])),
    ("cmi_knn_conditional_batch", lambda r: (r[3], r[1], r[2])),
    ("cmi_knn_pair_tests", lambda r: (np.stack([r[3], r[3][::-1]]),
                                      np.stack([r[1], r[0]]))),
    ("cmi_knn_conditional_tests", lambda r: (
        np.stack([r[3], r[3][::-1]]), np.stack([r[1], r[0]]),
        np.stack([r[2], r[2].T]))),
])
def test_knn_functions_match_the_reference(ranks, name, args):
    got, want = _both(name, *args(ranks))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **EST)


def test_knn_rows_do_not_depend_on_their_chunk(ranks, monkeypatch):
    xr, yr, dz, xs = ranks
    whole = tknn.cmi_knn_conditional_batch(
        torch.from_numpy(xs), torch.from_numpy(yr), torch.from_numpy(dz), K)
    monkeypatch.setattr(tknn, "ELEM_BUDGET", 2 * N * N)  # 2 rows a chunk
    chunked = tknn.cmi_knn_conditional_batch(
        torch.from_numpy(xs), torch.from_numpy(yr), torch.from_numpy(dz), K)
    single = torch.stack([tknn.cmi_knn_conditional(
        torch.from_numpy(x), torch.from_numpy(yr), torch.from_numpy(dz), K)
        for x in xs])
    assert torch.equal(whole, chunked) and torch.equal(whole, single)


def test_knn_float32_ranks_give_the_float64_estimates(ranks):
    xr, yr, dz, xs = ranks
    f64 = tknn.cmi_knn_conditional_batch(
        torch.from_numpy(xs), torch.from_numpy(yr), torch.from_numpy(dz), K)
    f32 = tknn.cmi_knn_conditional_batch(
        *(torch.from_numpy(a.astype(np.float32)) for a in (xs, yr, dz)), K)
    assert torch.equal(f64, f32)


def _frame(n=240, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = a + 0.7 * rng.normal(size=n)
    c = np.sin(b) + 0.5 * rng.normal(size=n)
    d = rng.normal(size=n)
    return pd.DataFrame(dict(a=a, b=b, c=c, d=d))


TRIPLES = [("a", "b", ()), ("a", "d", ()), ("a", "c", ("b",)),
           ("c", "d", ("a",)), ("a", "c", ("b", "d")), ("b", "d", ("a", "c"))]
KW = dict(k=K, seed=3, samples=60)


def test_both_packages_shuffle_natively():
    assert jax_lgfast() is not None and torch_lgfast() is not None


@pytest.fixture(scope="module")
def reference():
    """The JAX package's estimates and p-values on the module's cases."""
    df = _frame()
    test = jpb.KMutualInformation(df, **KW)
    return {
        "mi": [test.mi(x, y, *z) for x, y, z in TRIPLES],
        "pvalue": [test.pvalue(x, y, *z) for x, y, z in TRIPLES],
        "batch": test.pvalue_batch(TRIPLES),
    }


@pytest.fixture
def port():
    return tpb.KMutualInformation(_frame(), **KW)


def test_mi_matches_the_reference(reference, port):
    got = [port.mi(x, y, *z) for x, y, z in TRIPLES]
    np.testing.assert_allclose(got, reference["mi"], **EST)


@pytest.mark.parametrize("i", range(len(TRIPLES)))
def test_pvalue_equals_the_reference(reference, port, i):
    x, y, z = TRIPLES[i]
    assert port.pvalue(x, y, *z) == reference["pvalue"][i]


def test_pvalue_batch_equals_the_reference_and_the_serial_route(reference,
                                                                port):
    got = port.pvalue_batch(TRIPLES)
    np.testing.assert_array_equal(got, reference["batch"])
    np.testing.assert_array_equal(
        got, [port.pvalue(x, y, *z) for x, y, z in TRIPLES])


def test_pvalue_batch_order_and_grouping_do_not_matter(port):
    whole = port.pvalue_batch(TRIPLES)
    reversed_ = port.pvalue_batch(TRIPLES[::-1])[::-1]
    pairs = np.concatenate([port.pvalue_batch(TRIPLES[i:i + 2])
                            for i in range(0, len(TRIPLES), 2)])
    np.testing.assert_array_equal(whole, reversed_)
    np.testing.assert_array_equal(whole, pairs)


def test_rank_data_matches_the_reference():
    from pybnesian_tpu.learning.independences.kmutual_info import (
        rank_data as jrank)
    from pybnesian_tpu_torch.learning.independences.kmutual_info import (
        rank_data as trank)

    mat = np.random.default_rng(0).integers(0, 5, (50, 3)).astype(float)
    np.testing.assert_array_equal(trank(mat), jrank(mat))


def test_too_few_complete_rows_raise_as_in_the_reference():
    df = _frame(8)
    df.loc[::2, "a"] = np.nan
    with pytest.raises(ValueError, match="more complete rows"):
        jpb.KMutualInformation(df, k=5)
    with pytest.raises(ValueError, match="more complete rows"):
        tpb.KMutualInformation(df, k=5)


def test_dynamic_kmutual_information_matches_the_reference():
    rng = np.random.default_rng(5)
    n = 160
    u = np.cumsum(rng.normal(size=n)) * 0.1
    v = np.roll(u, 1) + 0.5 * rng.normal(size=n)
    df = pd.DataFrame(dict(u=u, v=v))
    jt = jpb.DynamicKMutualInformation(jpb.DynamicDataFrame(df, 1), k=4,
                                       seed=1, samples=40)
    tt = tpb.DynamicKMutualInformation(tpb.DynamicDataFrame(df, 1), k=4,
                                       seed=1, samples=40)
    assert tt.variable_names() == jt.variable_names()
    assert tt.markovian_order() == jt.markovian_order()
    for side in ("static_tests", "transition_tests"):
        j, t = getattr(jt, side)(), getattr(tt, side)()
        names = j.variable_names()
        assert t.variable_names() == names
        x, y = names[0], names[-1]
        assert t.pvalue(x, y) == j.pvalue(x, y)
        np.testing.assert_allclose(t.mi(x, y), j.mi(x, y), **EST)
