"""The torch port's batched linear-Gaussian CV log-likelihood
(pybnesian_tpu_torch/ops/gaussian.py) against the JAX package's.

Families with 0, 1 and 2 parents, nulls, and two degenerate families: their
column 3 has two valid rows, so some fold is underdetermined (−inf). Then
the plain version of the LG kernel (``lg_fold_stats``, the CPU route of
``batched_lg_cv_loglik`` and ``family_grams``: float64 statistics of
float32 data, rounded once) on families of 0–3 parents padded to the
batch's widest, null rows and a fold of two training rows, against the
JAX package's ``batched_lg_cv_loglik`` and ``family_grams``.
Float64: rtol 1e-9 / atol 1e-7 (the same math in another summation order);
float32: rtol 5e-4 / atol 5e-3.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu.ops.gaussian import batched_lg_cv_loglik as jax_lg_cv
from pybnesian_tpu_torch.ops.gaussian import batched_lg_cv_loglik
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


TOL = {np.float64: dict(rtol=1e-9, atol=1e-7),
       np.float32: dict(rtol=5e-4, atol=5e-3)}


def _setup(n=300, D=4, K=3, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.normal(0, 1.0, (n, D))
    for j in range(1, D):
        values[:, j] += 0.8 * values[:, j - 1]
    valid = np.ones((n, D))
    valid[rng.random((n, D)) < 0.05] = 0.0
    valid[2:, 3] = 0.0  # column 3: two valid rows in all
    values = np.where(valid > 0, values, 0.0)
    folds = np.array_split(rng.permutation(n), K)
    train = np.zeros((K, n))
    test = np.zeros((K, n))
    for k in range(K):
        test[k, folds[k]] = 1.0
        train[k, np.concatenate([folds[j] for j in range(K) if j != k])] = 1.0
    # (variable, parents); the last two families use the mostly-null column 3
    fams = [(0, []), (1, [0]), (2, [1, 0]), (3, []), (2, [3])]
    P = max(len(ps) for _, ps in fams)
    var_idx = np.array([v for v, _ in fams], np.int64)
    parent_idx = np.zeros((len(fams), P), np.int64)
    parent_mask = np.zeros((len(fams), P))
    for f, (_, ps) in enumerate(fams):
        parent_idx[f, : len(ps)] = ps
        parent_mask[f, : len(ps)] = 1.0
    return values, valid, train, test, var_idx, parent_idx, parent_mask


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_lg_cv_loglik_matches_jax(dtype):
    values, valid, train, test, var_idx, parent_idx, parent_mask = _setup()
    floats = [a.astype(dtype) for a in (values, valid, train, test)]
    want = np.asarray(jax_lg_cv(
        *(jnp.asarray(a) for a in floats), jnp.asarray(var_idx, jnp.int32),
        jnp.asarray(parent_idx, jnp.int32),
        jnp.asarray(parent_mask.astype(dtype)),
    ))
    got = batched_lg_cv_loglik(
        *(torch.as_tensor(a) for a in floats), torch.as_tensor(var_idx),
        torch.as_tensor(parent_idx),
        torch.as_tensor(parent_mask.astype(dtype)),
    )
    assert got.dtype == (torch.float32 if dtype == np.float32
                         else torch.float64)
    got = got.numpy()
    np.testing.assert_allclose(got, want, **TOL[dtype])
    assert np.all(np.isfinite(got[:3]))
    assert np.all(got[3:] == -math.inf)


def test_lg_params_from_singular_gram_matches_jax():
    """A Gram whose regression block is not positive definite gives NaN
    parameters in both packages; the CV score then maps it to −inf."""
    from pybnesian_tpu.ops.gaussian import lg_params_from_gram as jax_params
    from pybnesian_tpu_torch.ops.gaussian import lg_params_from_gram

    grams = np.array([
        [[10.0, 2.0, 3.0], [2.0, 5.0, 1.0], [3.0, 1.0, 4.0]],
        [[1.0, 2.0, 1.0], [2.0, 1.0, 1.0], [1.0, 1.0, 4.0]],
    ])
    mask = np.ones((2, 1))
    n_eff = np.array([10.0, 10.0])
    want = [jax_params(jnp.asarray(g), jnp.asarray(m), jnp.asarray(n))
            for g, m, n in zip(grams, mask, n_eff)]
    got = lg_params_from_gram(torch.as_tensor(grams), torch.as_tensor(mask),
                              torch.as_tensor(n_eff))
    for i, name in enumerate(["beta", "variance", "rss"]):
        g = got[i].numpy()
        w = np.stack([np.asarray(want[f][i]) for f in range(2)])
        np.testing.assert_allclose(g, w, **TOL[np.float64], err_msg=name)
        assert np.all(np.isnan(g[1])) and np.all(np.isfinite(g[0])), name


def _wide_setup(n=400, D=6, K=4, seed=1):
    """Families of 0–3 parents (each padded to 3 in the batch), 4% null
    cells and a column of nulls on a third of the rows; fold 0 keeps two
    training rows, so every family with a parent is −inf there."""
    rng = np.random.default_rng(seed)
    values = rng.normal(0, 1.0, (n, D))
    for j in range(1, D):
        values[:, j] += 0.6 * values[:, j - 1]
    valid = (rng.random((n, D)) >= 0.04).astype(np.float64)
    valid[: n // 3, 5] = 0.0
    values = np.where(valid > 0, values, 0.0)
    folds = np.array_split(rng.permutation(n), K)
    train, test = np.zeros((K, n)), np.zeros((K, n))
    for k, te in enumerate(folds):
        test[k, te] = 1.0
        train[k] = 1.0 - test[k]
    keep = np.flatnonzero(train[0] * valid.prod(axis=1))[:2]
    train[0] = 0.0
    train[0, keep] = 1.0
    fams = [(0, []), (1, [0]), (2, [1, 0]), (3, [2, 1, 0]), (5, [4]),
            (4, [5, 3]), (1, [])]
    P = 3
    var_idx = np.array([v for v, _ in fams], np.int64)
    parent_idx = np.zeros((len(fams), P), np.int64)
    parent_mask = np.zeros((len(fams), P))
    for f, (_, ps) in enumerate(fams):
        parent_idx[f, : len(ps)] = ps
        parent_mask[f, : len(ps)] = 1.0
    return values, valid, train, test, var_idx, parent_idx, parent_mask


def _jax_and_torch(dtype, args):
    values, valid, train, test, var_idx, parent_idx, parent_mask = args
    floats = [a.astype(dtype) for a in (values, valid, train, test)]
    jax_args = ([jnp.asarray(a) for a in floats]
                + [jnp.asarray(var_idx, jnp.int32),
                   jnp.asarray(parent_idx, jnp.int32),
                   jnp.asarray(parent_mask.astype(dtype))])
    torch_args = ([torch.as_tensor(a) for a in floats]
                  + [torch.as_tensor(var_idx), torch.as_tensor(parent_idx),
                     torch.as_tensor(parent_mask.astype(dtype))])
    return jax_args, torch_args


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_plain_kernel_version_matches_jax_cv(dtype):
    """``lg_fold_stats``' scores, the CPU route of ``batched_lg_cv_loglik``:
    families of 0–3 parents padded to 3, nulls, fold 0 of two training
    rows (−inf for every family with a parent, finite for one without)."""
    from pybnesian_tpu_torch.ops.gaussian import lg_fold_stats

    jax_args, (values, valid, train, test, vi, pi, pm) = _jax_and_torch(
        dtype, _wide_setup())
    want = np.asarray(jax_lg_cv(*jax_args))
    stats = lg_fold_stats(values, valid, train, vi, pi, pm, values, valid,
                          test)
    assert stats.gram.dtype == torch.float64
    assert stats.scores.dtype == torch.float32 if dtype == np.float32 \
        else stats.scores.dtype == torch.float64
    got = stats.scores.numpy()
    np.testing.assert_allclose(got, want, **TOL[dtype])
    has_parent = pm.numpy().sum(1) > 0
    assert np.all(got[has_parent] == -math.inf)
    assert np.all(np.isfinite(got[~has_parent]))
    np.testing.assert_allclose(
        got, batched_lg_cv_loglik(values, valid, train, test, vi, pi,
                                  pm).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_plain_kernel_version_matches_jax_grams(dtype):
    """``family_grams`` (the Gram stage over every row, float64 sums of
    float32 data rounded once) and each fold's Gram of ``lg_fold_stats``
    against the JAX package's ``family_grams`` on the fold's rows; the
    padded parents' rows and columns exactly zero."""
    from pybnesian_tpu.ops.gaussian import family_grams as jax_grams
    from pybnesian_tpu_torch.ops.gaussian import family_grams, lg_fold_stats

    args = _wide_setup()
    jax_args, (values, valid, train, test, vi, pi, pm) = _jax_and_torch(
        dtype, args)
    want, want_n = (np.asarray(a) for a in jax_grams(
        jax_args[0], jax_args[1], *jax_args[4:]))
    got, got_n = family_grams(values, valid, vi, pi, pm)
    assert got.dtype == values.dtype
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    np.testing.assert_allclose(got_n.numpy(), want_n, **TOL[dtype])
    k = pm.numpy().sum(1).astype(int)
    for f, kf in enumerate(k):
        assert np.all(got.numpy()[f, kf + 1: -1] == 0.0)
    # fold 2's Gram: the JAX Grams of the fold's training rows alone
    stats = lg_fold_stats(values, valid, train, vi, pi, pm)
    rows = args[2][2] > 0
    fold, fold_n = (np.asarray(a) for a in jax_grams(
        jnp.asarray(args[0][rows].astype(dtype)),
        jnp.asarray(args[1][rows].astype(dtype)), *jax_args[4:]))
    np.testing.assert_allclose(stats.gram[:, 2].numpy(), fold,
                               **TOL[dtype])
    np.testing.assert_allclose(stats.n_eff[:, 2].numpy(), fold_n,
                               **TOL[dtype])
