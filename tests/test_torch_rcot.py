"""The torch port's RCoT against the JAX package, on the CPU.

Both packages draw the same random Fourier features for a seed (numpy's
``default_rng``, the same draw shapes, the batched path's power-of-two lane
padding included), so:

- the serial ``pvalue`` (float64 in both) agrees to 1e-9, with and without
  z, with nulls, and in the ``Dynamic*`` form;
- ``pvalue_batch`` agrees on the p-values (atol 5e-3), on a frame where
  ``b_chunk`` pads each chunk far beyond its real tests; its batched
  functions, float32 feature maps and float64 algebra in the port, agree at
  float32 tolerances (rtol 5e-4, atol 5e-3) with the reference's run in
  float64 on the same draws, and to 1e-9 given float64 data;
- a constant column gives the reference's p-values; a conditioning matrix
  that is not positive definite gives NaN, as the reference's Cholesky
  does;
- PC over RCoT learns the reference's PDAG.

One JAX run per case is shared by the module's tests.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu.learning.independences import rcot as jrcot
from pybnesian_tpu_torch.learning.independences import rcot as trcot

from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

SERIAL = dict(rtol=1e-9, atol=1e-12)
STATS = dict(rtol=5e-4, atol=5e-3)


@pytest.fixture
def small_chunks(monkeypatch):
    """A smaller element budget in both packages, so that a chunk pads to
    tens of lanes and not thousands: the reference computes every padded
    lane, which on the CPU costs seconds a call. The rule, and so the draw
    shapes, stay the same in both."""
    for cls in (jpb.RCoT, tpb.RCoT):
        monkeypatch.setattr(cls, "_ELEM_BUDGET", 10_000_000)


def _frame(n=300, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = a + rng.normal(size=n)
    c = np.sin(b) + rng.normal(size=n)
    d = rng.normal(size=n)
    e = 0.5 * c + d + rng.normal(size=n)
    f = 0.8 * a - 0.6 * e + rng.normal(size=n)
    return pd.DataFrame(dict(a=a, b=b, c=c, d=d, e=e, f=f))


SERIAL_CASES = [("a", "b", ()), ("a", "d", ()), ("a", "c", ("b",)),
                ("c", "d", ("e",)), ("a", "e", ("b", "c", "d")),
                ("b", "f", ("a", "c", "d", "e"))]


@pytest.mark.parametrize("x, y, z", SERIAL_CASES)
def test_serial_pvalue_matches_the_reference(x, y, z):
    df = _frame()
    want = jpb.RCoT(df, seed=3).pvalue(x, y, *z)
    got = tpb.RCoT(df, seed=3).pvalue(x, y, *z)
    np.testing.assert_allclose(got, want, **SERIAL)


def test_serial_pvalues_in_sequence_follow_the_reference_stream():
    df = _frame(seed=1)
    jt, tt = jpb.RCoT(df, seed=7), tpb.RCoT(df, seed=7)
    for x, y, z in SERIAL_CASES:
        np.testing.assert_allclose(tt.pvalue(x, y, *z), jt.pvalue(x, y, *z),
                                   **SERIAL)


def test_serial_pvalue_with_nulls_and_the_batch_fallback():
    df = _frame(seed=2)
    df.loc[::7, "b"] = np.nan
    df.loc[3::11, "c"] = np.nan
    cases = [("a", "b", ()), ("a", "c", ("b",)), ("b", "e", ("c", "d"))]
    want = jpb.RCoT(df, seed=5).pvalue_batch(cases)
    got = tpb.RCoT(df, seed=5).pvalue_batch(cases)
    np.testing.assert_allclose(got, want, **SERIAL)


def _batch_inputs(n, size, lanes=6, seed=0):
    """Data and draws of a batch of ``lanes`` tests on ``size`` z columns,
    rounded to float32 as the batched path rounds them, as float64."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, 6))
    data[:, 1] += data[:, 0]
    data[:, 3] += np.sin(data[:, 1])
    xc = np.arange(lanes) % 6
    args = dict(data=data, xc=xc, Wx=rng.normal(size=(lanes, 5)),
                bx=rng.uniform(0, 6, (lanes, 5)), yc=(xc + 1) % 6,
                Wy=rng.normal(size=(lanes, 5)),
                by=rng.uniform(0, 6, (lanes, 5)))
    if size:
        args.update(zc=np.stack([(xc + 2 + i) % 6 for i in range(size)], 1),
                    Wz=rng.normal(size=(lanes, size, 100)) / 2,
                    bz=rng.uniform(0, 6, (lanes, 100)))
    return {k: v if k.endswith("c") else v.astype(np.float32).astype(float)
            for k, v in args.items()}


@pytest.mark.parametrize("n, size", [(300, 0), (300, 1), (300, 3),
                                     (2000, 2)])
def test_batched_algebra_matches_the_reference_in_float64(n, size):
    """The batched functions on the same draws: the port's float32 feature
    maps with float64 algebra within float32 tolerances of the reference's
    functions run in float64 (its own float32 algebra is 2e-3 away at
    these sizes, the conditioning solve amplifying its rounding), and the
    port's functions given float64 data equal them to 1e-9."""
    a = _batch_inputs(n, size)
    jfused, jpair = jrcot._get_batched()
    order = ["xc", "Wx", "bx", "yc", "Wy", "by"]
    if size:
        want = jfused(jnp.asarray(a["data"]), *(a[k] for k in order),
                      a["zc"], np.ones(a["zc"].shape), a["Wz"], a["bz"])
        order += ["zc", "Wz", "bz"]
        fn = trcot.fused_z
    else:
        want = jpair(jnp.asarray(a["data"]), *(a[k] for k in order))
        fn = trcot.pair_stats
    wsta, weigs = (np.asarray(w) for w in want)
    for dtype, tol in ((np.float32, STATS), (np.float64, SERIAL)):
        got = fn(torch.from_numpy(a["data"].astype(dtype)),
                 *(torch.from_numpy(a[k]) if k.endswith("c")
                   else torch.from_numpy(a[k].astype(dtype)) for k in order))
        np.testing.assert_allclose(got[0].numpy(), wsta, **tol)
        np.testing.assert_allclose(got[1].numpy(), weigs, **tol)


BATCH = [("a", "b", ()), ("a", "d", ()), ("c", "f", ()), ("a", "c", ("b",)),
         ("c", "d", ("e",)), ("b", "d", ("a",)), ("a", "e", ("b", "c", "d")),
         ("b", "f", ("a", "c", "e"))]


def test_batch_pvalues_match_the_reference():
    """On a frame where every group pads (b_chunk lanes far beyond its real
    tests), the reference's draws for the padded lanes included: the same
    p-values within float32 tolerance."""
    test = tpb.RCoT(_frame(), seed=11)
    assert all(test._lanes(size)[1] > 8 for size in (0, 1, 3))
    np.testing.assert_allclose(test.pvalue_batch(BATCH),
                               jpb.RCoT(_frame(), seed=11).pvalue_batch(BATCH),
                               rtol=0, atol=5e-3)


def test_batch_draws_follow_the_reference_stream(small_chunks):
    """After a padded batch, the generator stands where the reference's
    does: the next serial p-value matches to 1e-9."""
    jt, tt = jpb.RCoT(_frame(), seed=11), tpb.RCoT(_frame(), seed=11)
    jt.pvalue_batch(BATCH)
    tt.pvalue_batch(BATCH)
    np.testing.assert_allclose(tt.pvalue("a", "c", "b"),
                               jt.pvalue("a", "c", "b"), **SERIAL)


def test_a_constant_column_gives_the_reference_pvalues(small_chunks):
    df = _frame(120)
    df["k"] = 2.5
    cases = [("a", "k", ()), ("a", "b", ("k",)), ("a", "c", ("b", "k"))]
    jt, tt = jpb.RCoT(df, seed=1), tpb.RCoT(df, seed=1)
    serial = [tt.pvalue(x, y, *z) for x, y, z in cases]
    np.testing.assert_allclose(
        serial, [jt.pvalue(x, y, *z) for x, y, z in cases], **SERIAL)
    assert serial[0] == 1.0
    np.testing.assert_allclose(
        tpb.RCoT(df, seed=2).pvalue_batch(cases),
        jpb.RCoT(df, seed=2).pvalue_batch(cases), rtol=0, atol=5e-3)


def test_fused_z_gives_nan_where_the_conditioning_matrix_is_not_positive_definite():
    """An infinite z value makes the z features NaN, so czz is not positive
    definite: the reference's Cholesky gives NaN, and so does the port's
    (where ``torch.linalg.cholesky`` would raise)."""
    rng = np.random.default_rng(0)
    n, B, f, fz = 64, 2, 5, 20
    data = rng.normal(size=(n, 4)).astype(np.float32)
    data[5, 3] = np.inf  # column 3 is lane 1's z
    xc = np.array([0, 0], np.int32)
    yc = np.array([1, 1], np.int32)
    zc = np.array([[2], [3]], np.int32)
    W = [rng.normal(size=(B, f)).astype(np.float32) for _ in range(2)]
    b = [rng.uniform(0, 6, (B, f)).astype(np.float32) for _ in range(2)]
    Wz = rng.normal(size=(B, 1, fz)).astype(np.float32)
    bz = rng.uniform(0, 6, (B, fz)).astype(np.float32)
    jfused, _ = jrcot._get_batched()
    jsta, jeigs = (np.asarray(a) for a in jfused(
        jnp.asarray(data), xc, W[0], b[0], yc, W[1], b[1], zc,
        np.ones((B, 1), np.float32), Wz, bz))
    t = torch.from_numpy
    tsta, teigs = (a.numpy() for a in trcot.fused_z(
        t(data), t(xc).long(), t(W[0]), t(b[0]), t(yc).long(), t(W[1]),
        t(b[1]), t(zc).long(), t(Wz), t(bz)))
    assert np.isnan(jsta[1]) and np.isnan(tsta[1])
    assert np.isnan(teigs[1]).all() and np.isnan(jeigs[1]).any()
    np.testing.assert_allclose(tsta[0], jsta[0], **STATS)
    np.testing.assert_allclose(teigs[0], jeigs[0], **STATS)


def _pdag(p):
    return sorted(p.arcs()), sorted(tuple(sorted(e)) for e in p.edges())


def test_pc_over_rcot_learns_the_reference_pdag(small_chunks):
    df = _frame(400, seed=6)
    want = jpb.PC().estimate(jpb.RCoT(df, seed=0), alpha=0.05)
    got = tpb.PC().estimate(tpb.RCoT(df, seed=0), alpha=0.05)
    assert _pdag(got) == _pdag(want)


def test_dynamic_rcot_matches_the_reference():
    rng = np.random.default_rng(8)
    n = 200
    u = np.cumsum(rng.normal(size=n)) * 0.1
    v = np.roll(u, 1) + 0.5 * rng.normal(size=n)
    w = rng.normal(size=n)
    df = pd.DataFrame(dict(u=u, v=v, w=w))
    jt = jpb.DynamicRCoT(jpb.DynamicDataFrame(df, 1), seed=4)
    tt = tpb.DynamicRCoT(tpb.DynamicDataFrame(df, 1), seed=4)
    assert tt.variable_names() == jt.variable_names()
    for side in ("static_tests", "transition_tests"):
        j, t = getattr(jt, side)(), getattr(tt, side)()
        names = j.variable_names()
        assert t.variable_names() == names
        for z in ((), (names[1],)):
            np.testing.assert_allclose(t.pvalue(names[0], names[-1], *z),
                                       j.pvalue(names[0], names[-1], *z),
                                       **SERIAL)


def test_rcot_rejects_discrete_columns_as_the_reference():
    df = _frame(50)
    df["g"] = pd.Categorical(np.where(df["a"] > 0, "hi", "lo"))
    with pytest.raises(ValueError, match="not continuous"):
        jpb.RCoT(df)
    with pytest.raises(ValueError, match="not continuous"):
        tpb.RCoT(df)
