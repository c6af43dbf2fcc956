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

import contextlib
import pickle

import numpy as np
import pytest
import torch

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu.factors.ckde import (
    batched_ckde_logl_many as jax_batched_many,
)
from pybnesian_tpu_torch import interop
from pybnesian_tpu_torch.factors.ckde import batched_ckde_logl_many

from data_gen import mixed_data, normal_chain_data, with_nulls
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


# ------------------------------------------- kept training sides (plans)
NODES = ["a", "b", "c", "d"]
SPBN_CKDE = ("a", "c", "d")  # widths 1 (no evidence), 2, 2


def _spbn(dtype="float64"):
    """A JAX-fitted semiparametric chain carried into the port, so that
    both packages evaluate the same fitted model."""
    df = normal_chain_data(300, seed=21, dtype=dtype)
    jm = jpb.SemiparametricBN(
        NODES, [("a", "b"), ("b", "c"), ("c", "d")],
        [(n, jpb.CKDEType()) for n in SPBN_CKDE],
    )
    jm.fit(df)
    return jm, interop.fitted_network(**interop.network_state(jm))


def _frames(dtype="float64"):
    return [with_nulls(normal_chain_data(n, seed=s, dtype=dtype), 0.05)
            for n, s in ((60, 31), (95, 32), (40, 33))]


def _fresh(obj):
    """A copy of ``obj`` through pickle, with its CPDs: no plan kept."""
    obj.include_cpd = True
    try:
        return pickle.loads(pickle.dumps(obj))
    finally:
        del obj.include_cpd


@contextlib.contextmanager
def _no_kept_stacks():
    """The batched path with none of the stacked training sides kept so
    far (and none of those it builds inside kept after)."""
    from pybnesian_tpu_torch.factors import ckde

    kept = ckde._LAST
    ckde._LAST = None
    try:
        yield
    finally:
        ckde._LAST = kept


def _values(model, frame):
    return model.logl(frame), model.slogl(frame)


def _fresh_values(model, frame):
    """``_values`` of a fresh copy of ``model``, which builds every plan
    it uses."""
    with _no_kept_stacks():
        return _values(_fresh(model), frame)


def _assert_same_bits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_model_kept_plan_bit_equal_to_fresh_copy(dtype):
    """``slogl`` and ``logl`` of a model whose CKDE nodes keep their
    training side equal, bit for bit, those of a freshly unpickled copy
    (which builds its plans on its first call), frame after frame, and
    still match the JAX package."""
    jm, tm = _spbn(dtype)
    tol = F64 if dtype == "float64" else F32
    for frame in _frames(dtype) * 2:
        got = _values(tm, frame)
        _assert_same_bits(got, _fresh_values(tm, frame))
        _same(got[0], jm.logl(frame), tol)
        assert got[1] == pytest.approx(jm.slogl(frame), rel=tol["rtol"])


def _whitening_every_call(entries):
    """The batched path as it was before it kept training sides: every
    call whitens all training and test rows on the host and uploads them
    with the mask, through ``batched_ckde_logl``'s own form."""
    from scipy.linalg import solve_triangular

    from pybnesian_tpu_torch.ops.kde import batched_ckde_logl
    from pybnesian_tpu_torch.runtime.device import host_to_device

    F = len(entries)
    ntr = max(e[0].num_instances() for e in entries)
    m = max(len(e[1]) for e in entries)
    djmax = max(1 + len(e[0].evidence()) for e in entries)
    dtype = np.result_type(*(e[0].kde_joint()._dtype for e in entries))
    jtr, jte = np.zeros((F, ntr, djmax)), np.zeros((F, m, djmax))
    trm, lndiff = np.zeros((F, ntr)), np.zeros(F)
    for f, (cpd, mat) in enumerate(entries):
        joint = cpd.kde_joint()
        dj = 1 + len(cpd.evidence())
        perm = list(range(1, dj)) + [0]
        Lp = np.linalg.cholesky(joint.bandwidth[np.ix_(perm, perm)])
        n = joint.num_instances()
        jtr[f, :n, :dj] = solve_triangular(
            Lp, joint._training[:, perm].T, lower=True).T
        trm[f, :n] = 1.0
        lndiff[f] = -np.log(Lp[dj - 1, dj - 1]) - 0.5 * np.log(2 * np.pi)
        jte[f, :len(mat), :dj] = solve_triangular(
            Lp, mat[:, perm].T, lower=True).T
    var_col = np.array([len(e[0].evidence()) for e in entries])
    rows = np.arange(F)
    no_ev = (var_col == 0).astype(np.float64)
    args = [jtr, jte, jtr[rows, :, var_col], jte[rows, :, var_col], trm,
            lndiff]
    out = batched_ckde_logl(*(host_to_device(a, dtype) for a in args),
                            no_ev=host_to_device(no_ev, dtype))
    out = out.numpy().astype(np.float64)
    return [out[f, :len(entries[f][1])] for f in range(F)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kept_plan_gives_the_pair_sums_the_same_inputs(dtype, monkeypatch):
    """The pair sums receive the same tensors, bit for bit, from the kept
    training side as from whitening every row on every call, and return
    the same values; the second call reuses what the first built."""
    from pybnesian_tpu_torch.ops import kde as tkde

    seen = []
    dense = tkde._dense_pairs

    def recording(*args):
        seen.append([a.clone() for a in args])
        return dense(*args)

    monkeypatch.setattr(tkde, "_dense_pairs", recording)
    _, tm = _spbn(dtype)
    cpds = [tm.cpd(n) for n in SPBN_CKDE]
    for frame in _frames(dtype)[:2] * 2:
        mats = [np.nan_to_num(frame[[c.variable(), *c.evidence()]]
                              .to_numpy(np.float64)) for c in cpds]
        got = batched_ckde_logl_many(list(zip(cpds, mats)))
        want = _whitening_every_call(list(zip(cpds, mats)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        planned, whitened = seen[-2:]
        for a, b in zip(planned, whitened):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("change", ["refit", "add_cpds"])
def test_refitted_node_rebuilds_the_plan(change):
    """After one CKDE node is refitted on other data, or replaced through
    ``add_cpds``, the next call equals a fresh model's bit for bit."""
    _, tm = _spbn()
    frames = _frames()
    tm.slogl(frames[0])
    other = normal_chain_data(200, seed=44)
    if change == "refit":
        tm.cpd("c").fit(other)
    else:
        cpd = tpb.CKDE("c", ["b"])
        cpd.fit(other)
        tm.add_cpds([cpd])
    for frame in frames:
        _assert_same_bits(_values(tm, frame), _fresh_values(tm, frame))


def _counted(calls):
    """The plan counters over ``calls()`` under a recording profiler."""
    from pybnesian_tpu_torch.runtime import tracing

    tracing.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        calls()
    c = tracing.counters()
    tracing.reset_counters()
    return (c.get("slogl.ckde.plan_builds", 0),
            c.get("slogl.ckde.plan_reuses", 0))


@pytest.mark.parametrize("refit", [False, True], ids=["steady", "refit"])
def test_plan_counters(refit):
    """n calls build one stacked plan and reuse it n - 1 times; a refit
    between them builds a second."""
    _, tm = _spbn()
    frames = _frames()
    n = 7

    def calls():
        for i in range(n):
            if refit and i == 3:
                tm.cpd("d").fit(normal_chain_data(150, seed=45))
            tm.slogl(frames[i % len(frames)])

    assert _counted(calls) == ((2, n - 2) if refit else (1, n - 1))


def test_pickle_carries_no_device_tensor():
    """A model that kept its plans pickles without a tensor; the copy keeps
    none and gives the same values."""
    import io

    _, tm = _spbn()
    frame = _frames()[0]
    want = _values(tm, frame)

    class NoTensors(pickle.Pickler):
        def persistent_id(self, obj):
            assert not isinstance(obj, torch.Tensor), "tensor pickled"
            return None

    tm.include_cpd = True
    buf = io.BytesIO()
    NoTensors(buf).dump(tm)
    del tm.include_cpd
    copy = pickle.loads(buf.getvalue())
    assert all(copy.cpd(n)._plan is None for n in SPBN_CKDE)
    _assert_same_bits(_values(copy, frame), want)


def test_train_plan_follows_dtype_device_and_bandwidth():
    """A factor's plan is kept for one (dtype, device) and one joint
    bandwidth: another dtype or device, or a new bandwidth, builds anew."""
    cpd = tpb.CKDE("b", ["a"])
    cpd.fit(normal_chain_data(120, seed=46))
    cpu, meta = torch.device("cpu"), torch.device("meta")
    first = cpd._train_plan(np.float64, cpu)
    assert cpd._train_plan(np.float64, cpu) is first
    on_meta = cpd._train_plan(np.float64, meta)
    assert on_meta is not first and on_meta.jtr.device == meta
    narrow = cpd._train_plan(np.float32, cpu)
    assert narrow.jtr.dtype == torch.float32
    again = cpd._train_plan(np.float32, cpu)
    assert again is narrow
    cpd.kde_joint().bandwidth = cpd.kde_joint().bandwidth * 1.5
    assert cpd._train_plan(np.float32, cpu) is not narrow


def test_hckde_configurations_bit_equal_to_fresh_factor():
    """An HCKDE over two discrete parents whose test frames hit different
    sets of configurations: each call equals a fresh factor's bit for bit,
    and the set of the call before is served by its stacked plan."""
    df = mixed_data(600)
    test = mixed_data(300, seed=4)
    frames = [test[test["A"].isin(["a1", "a2"])], test[test["B"] == "b2"],
              test[test["B"] == "b2"].iloc[::-1], test]
    tf = tpb.HCKDE("Y", ["X", "A", "B"])
    tf.fit(df)
    with _no_kept_stacks():
        want = [pickle.loads(pickle.dumps(tf)).logl(f) for f in frames]
    got = []
    assert _counted(lambda: got.extend(tf.logl(f) for f in frames)) == (3, 1)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, w)
