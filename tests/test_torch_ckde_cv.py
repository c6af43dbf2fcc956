"""The torch port's CV-CKDE path (pybnesian_tpu_torch/ops/kde.py) against
the JAX package's, on the cases of tests/factors/test_pallas_cv.py.

Every case has an evidence-free family, 5% nulls and ragged folds. Float64:
rtol 1e-9 / atol 1e-7 (the same math in another summation order). Float32:
rtol 5e-4 / atol 5e-3, the tolerance the reference's own flash test uses.
The JAX flash path runs its Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu.ops import kde as jkde
from pybnesian_tpu_torch.ops import kde as tkde
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


F64 = dict(rtol=1e-9, atol=1e-7)
F32 = dict(rtol=5e-4, atol=5e-3)


def _setup(F=4, n=512, D=4, K=3, djmax=2, seed=0, degenerate=False):
    """numpy arrays of test_pallas_cv.py's ``_setup``. With ``degenerate``,
    column 3 is null except on 10 rows of fold 0's test part: fold 0 of
    every family that uses it has no train row and must give NaN."""
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 1.5, (n, D))
    for j in range(1, D):
        data[:, j] += 0.7 * data[:, j - 1]
    null = np.zeros((n, D))
    null[rng.random((n, D)) < 0.05] = 1.0
    idx = rng.permutation(n)
    folds = np.array_split(idx, K)
    if degenerate:
        null[:, 3] = 1.0
        null[folds[0][:10], 3] = 0.0
    data = np.where(null > 0, 0.0, data)

    col_idx = np.zeros((F, djmax), np.int64)
    col_mask = np.zeros((F, djmax))
    # families: evidence first, variable last
    col_idx[0, 0] = 0
    col_mask[0, 0] = 1.0  # univariate
    for f in range(1, F):
        col_idx[f, 0] = (f + 1) % D
        col_idx[f, 1] = f % D
        col_mask[f, :2] = 1.0

    ntr = 256 * ((n - min(len(f) for f in folds)) // 256 + 1)
    nte = 256 * ((max(len(f) for f in folds) + 255) // 256)
    tr_idx = np.zeros((K, ntr), np.int64)
    tr_mask = np.zeros((K, ntr))
    te_idx = np.zeros((K, nte), np.int64)
    te_mask = np.zeros((K, nte))
    for k in range(K):
        te = folds[k]
        tr = np.concatenate([folds[j] for j in range(K) if j != k])
        tr_idx[k, : len(tr)] = tr
        tr_mask[k, : len(tr)] = 1.0
        te_idx[k, : len(te)] = te
        te_mask[k, : len(te)] = 1.0
    return [data, null, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask]


CASES = {
    "nr": (dict(), "nr"),
    "scott": (dict(), "scott"),
    "wide": (dict(F=2, djmax=4, seed=1), "nr"),
    "degenerate": (dict(degenerate=True), "nr"),
}


def _args(case, dtype):
    kw, rule = CASES[case]
    arrays = _setup(**kw)
    floats = (0, 1, 3, 5, 7)
    jax_args = [
        jnp.asarray(a.astype(dtype) if i in floats else a.astype(np.int32))
        for i, a in enumerate(arrays)
    ]
    torch_args = [
        torch.as_tensor(a.astype(dtype) if i in floats else a)
        for i, a in enumerate(arrays)
    ]
    return jax_args, torch_args, rule


@pytest.mark.parametrize("case", ["nr", "scott", "degenerate"])
def test_whitened_parts_f64(case):
    jargs, targs, rule = _args(case, np.float64)
    want = jkde.ckde_cv_whitened_parts(*jargs, rule=rule)
    got = tkde.ckde_cv_whitened_parts(*targs, rule=rule)
    names = ["jtr", "neg", "zv_tr", "jte", "zv_te", "wte", "lndiff", "ok"]
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_alldevice_f64(case):
    jargs, targs, rule = _args(case, np.float64)
    want = np.asarray(jkde.ckde_cv_alldevice(*jargs, chunk=256, rule=rule))
    got = tkde.ckde_cv_alldevice(*targs, rule=rule).numpy()
    np.testing.assert_allclose(got, want, **F64)
    if case == "degenerate":
        # families 2 and 3 use column 3; their fold 0 has no train row
        assert np.all(np.isnan(got[2:])) and np.all(np.isfinite(got[:2]))
    else:
        assert np.all(np.isfinite(got))


@pytest.mark.parametrize("case", ["nr", "wide", "degenerate"])
def test_alldevice_f32(case):
    jargs, targs, rule = _args(case, np.float32)
    want = np.asarray(jkde.ckde_cv_alldevice(*jargs, chunk=256, rule=rule))
    got = tkde.ckde_cv_alldevice(*targs, rule=rule)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_f32(case):
    jargs, targs, rule = _args(case, np.float32)
    want = np.asarray(jkde.ckde_cv_alldevice_flash(
        *jargs, rule=rule, block_m=128, block_n=256, interpret=True))
    got = tkde.ckde_cv_alldevice_flash(*targs, rule=rule).numpy()
    np.testing.assert_allclose(got, want, **F32)
    # the port's two routes agree with each other too
    dense = tkde.ckde_cv_alldevice(*targs, rule=rule).numpy()
    np.testing.assert_allclose(got, dense, **F32)


def test_selfcheck_cpu():
    ok, diff = tkde.flash_cv_selfcheck(device="cpu")
    assert ok, f"selfcheck diff {diff}"
    assert diff < 5e-2


def test_cholesky_or_nan_matches_jax():
    """A bandwidth that is not positive definite gives a factor with a NaN
    lower triangle in both packages (torch.linalg.cholesky would raise)."""
    from pybnesian_tpu_torch.ops.linalg import cholesky_or_nan

    H = np.array([
        [[2.0, 0.5, 0.1], [0.5, 1.0, 0.2], [0.1, 0.2, 0.5]],   # SPD
        [[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]],   # indefinite
        [[1.0, 0.0, 0.0], [0.0, -1e-12, 0.0], [0.0, 0.0, 1.0]],
    ])
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(H)))
    got = cholesky_or_nan(torch.as_tensor(H)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    rows, cols = np.tril_indices(3)
    assert np.all(np.isnan(got[1:, rows, cols]))
    assert np.all(np.isfinite(got[0]))
    np.testing.assert_allclose(got[0], want[0], **F64)


def test_flash_reduce_matches_jax():
    """Per-fold sums: test rows with weight 0 drop out even where their
    value is not finite, and a fold with ``ok`` 0 makes its family NaN."""
    rng = np.random.default_rng(3)
    F, K, nte = 3, 2, 16
    out = rng.normal(-2.0, 0.5, (F, K, nte))
    wte = (rng.random((F, K, nte)) < 0.8).astype(np.float64)
    out[wte == 0] = -np.inf
    lndiff = rng.normal(-1.0, 0.1, (F, K))
    ok = np.ones((F, K))
    ok[1, 0] = 0.0
    args = (out, wte, lndiff, ok)
    want = np.asarray(jkde._flash_reduce(*(jnp.asarray(a) for a in args)))
    got = tkde._flash_reduce(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, **F64)
    assert np.isnan(got[1]) and np.all(np.isfinite(got[[0, 2]]))
