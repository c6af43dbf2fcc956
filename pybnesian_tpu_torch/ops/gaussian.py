"""Linear-Gaussian family scores on torch tensors.

Port of ``pybnesian_tpu/ops/gaussian.py`` as far as the scores need it:
:func:`batched_lg_cv_loglik` (CV likelihood),
:func:`lg_logl` (one fitted family's per-row log-likelihood),
:func:`batched_lg_holdout_loglik` (holdout likelihood), :func:`batched_bic`
(BIC) and their helpers. Candidate families are the unit of batching, as in
the JAX package:

- each family (variable, parent-set) is a variable index + padded
  parent-index vector + 0/1 parent mask (ragged parent sets → one shape);
- null handling is a per-row validity weight (product of the family columns'
  validity), reproducing the reference's pairwise-deletion semantics
  (dataset/dataset.hpp:238-335);
- sufficient statistics are one masked Gram matrix per (family, fold),
  followed by a tiny masked Cholesky solve.

JAX's ``vmap`` over families and folds is written out as leading (F, K)
batch axes. XLA fused these functions (no Pallas kernel behind them). Here
the CV, holdout, Gram and BIC functions share one computation,
:func:`lg_fold_stats`: a float32 batch on a GPU runs it as the hand-written
kernel of ``csrc/lg_cv.cu`` (:mod:`.lg_cv_kernel`), whose float64 sums run
in an order fixed by the rows and folds, so a family's float32 score is the
same bits alone and in any batch, however wide; every other batch runs the
plain torch version, which takes the same float64 statistics for float32
data and rounds each result once. The JAX callers padded F and P to powers
of two to bound the number of XLA compiles; here a batch has its own shape.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..runtime.device import host_to_device
from .kde import kernel_route
from .lg_cv_kernel import lg_cv_stats
from .linalg import cholesky_or_nan

__all__ = [
    "family_tensors",
    "family_grams",
    "lg_params_from_gram",
    "bic_from_gram",
    "batched_bic",
    "batched_lg_cv_loglik",
    "batched_lg_holdout_loglik",
    "lg_fold_stats",
    "LgStats",
    "lg_logl",
]

LOG_2PI = math.log(2.0 * math.pi)
_MACHINE_TOL = 2.220446049250313e-16 * 4


def _family_design(values, valid, var_idx, parent_idx, parent_mask):
    """Design matrices [1, parents(masked), y] (F, n, P+2) and row weights
    (F, n) of F families. values/valid: (n, D); var_idx: (F,) long;
    parent_idx: (F, P) long; parent_mask: (F, P) 0/1."""
    n = values.shape[0]
    F = var_idx.shape[0]
    y = values[:, var_idx].T                                   # (F, n)
    X = values[:, parent_idx].permute(1, 0, 2) * parent_mask[:, None, :]
    pvalid = torch.where(
        parent_mask[:, None, :] > 0,
        valid[:, parent_idx].permute(1, 0, 2),
        torch.ones((), dtype=values.dtype, device=values.device),
    )
    w = valid[:, var_idx].T * torch.prod(pvalid, dim=2)        # (F, n)
    ones = torch.ones((F, n, 1), dtype=values.dtype, device=values.device)
    design = torch.cat([ones, X, y[:, :, None]], dim=2)
    return design, w


def family_tensors(families, dtype, device):
    """(var_idx, parent_idx, parent_mask) of ``families``, a list of
    (variable position, [parent positions]), on ``device``: (F,) and
    (F, P) long, (F, P) 0/1 of numpy float ``dtype``; P is the most
    parents of any family."""
    F = len(families)
    P = max((len(ps) for _, ps in families), default=0)
    var_idx = np.zeros(F, np.int64)
    parent_idx = np.zeros((F, P), np.int64)
    parent_mask = np.zeros((F, P))
    for f, (vi, ps) in enumerate(families):
        var_idx[f] = vi
        parent_idx[f, : len(ps)] = ps
        parent_mask[f, : len(ps)] = 1.0
    return (host_to_device(var_idx, np.int64, device),
            host_to_device(parent_idx, np.int64, device),
            host_to_device(parent_mask, dtype, device))


def family_grams(values, valid, var_idx, parent_idx, parent_mask):
    """Masked Gram matrices of F families: (F, P+2, P+2) over the columns
    [1, parents, y], and the (F,) valid row counts n_eff, in the values'
    dtype (float32 values: float64 sums, rounded once)."""
    stats = _lg_stats(values, valid, None, var_idx, parent_idx, parent_mask)
    return (stats.gram[:, 0].to(values.dtype),
            stats.n_eff[:, 0].to(values.dtype))


def lg_params_from_gram(gram, parent_mask, n_eff):
    """(beta, variance, rss) from family Grams, batched over the leading
    axes (reference mle_LinearGaussianCPD.hpp closed forms, generalized).

    gram: (..., P+2, P+2) over [1, parents, y]; parent_mask: (..., P);
    n_eff: (...). beta is padded to P+1 entries [intercept, slopes];
    masked-out parents get slope 0. variance = RSS / (n - k - 1), +inf when
    underdetermined (mle_LinearGaussianCPD.hpp:203-230, :173-186). A Gram
    that is not positive definite gives NaN (:func:`cholesky_or_nan`)."""
    P = parent_mask.shape[-1]
    one = torch.ones(parent_mask.shape[:-1] + (1,), dtype=gram.dtype,
                     device=gram.device)
    m = torch.cat([one, parent_mask], dim=-1)                  # (..., P+1)
    A = gram[..., : P + 1, : P + 1] * m[..., :, None] * m[..., None, :]
    A = A + torch.diag_embed(1.0 - m)
    b = gram[..., : P + 1, P + 1] * m
    yy = gram[..., P + 1, P + 1]
    chol = cholesky_or_nan(A)
    beta = torch.cholesky_solve(b[..., None], chol)[..., 0]
    rss = yy - torch.sum(beta * b, dim=-1)
    rss = torch.maximum(rss, torch.zeros_like(rss))
    k = torch.sum(parent_mask, dim=-1)
    dof = n_eff - k - 1.0
    variance = torch.where(
        dof > 0, rss / torch.clamp(dof, min=1.0), math.inf
    )
    return beta, variance, rss


def bic_from_gram(gram, parent_mask, n_eff):
    """Gaussian BIC local scores from family Grams, batched over the leading
    axes (formula: reference learning/scores/bic.cpp:12-27); −inf where the
    family is degenerate."""
    _, variance, _ = lg_params_from_gram(gram, parent_mask, n_eff)
    return _bic(variance, torch.sum(parent_mask, dim=-1), n_eff)


def _bic(variance, k, n):
    """The BIC of a fitted family of ``k`` parents over ``n`` rows; −inf
    where the variance or the score is degenerate."""
    loglik = (
        0.5 * (1.0 + k - n) - 0.5 * n * LOG_2PI - 0.5 * n * torch.log(variance)
    )
    score = loglik - 0.5 * torch.log(n) * (k + 2.0)
    bad = (
        (variance < _MACHINE_TOL)
        | ~torch.isfinite(variance)
        | ~torch.isfinite(score)
    )
    return torch.where(bad, -math.inf, score)


def batched_bic(values, valid, var_idx, parent_idx, parent_mask):
    """(F,) BIC local scores of F candidate families in one batched call,
    in the values' dtype (float32 values: float64 statistics, rounded
    once)."""
    stats = _lg_stats(values, valid, None, var_idx, parent_idx, parent_mask)
    return stats.bic[:, 0].to(values.dtype)


def lg_logl(y, X, beta, variance):
    """Per-row log N(y | beta0 + X·beta[1:], variance)
    (reference LinearGaussianCPD.cpp:93-119)."""
    return _gaussian_ll(y, beta[0] + X @ beta[1:], variance)


def _gaussian_ll(y, mean, variance):
    """Per-row log N(y | mean, variance)."""
    return (
        -0.5 * torch.square(y - mean) / variance
        - 0.5 * torch.log(variance)
        - 0.5 * LOG_2PI
    )


class LgStats(NamedTuple):
    """Per-(family, fold) statistics of F linear-Gaussian families over K
    folds, float64: ``gram`` (F, K, P+2, P+2), ``n_eff`` and ``bic`` (F,
    K); ``scores`` (F,) in the data's dtype, the test log-likelihood summed
    over the folds (−inf where a fold's variance is degenerate), or None
    without test rows."""

    gram: torch.Tensor
    n_eff: torch.Tensor
    bic: torch.Tensor
    scores: torch.Tensor | None


def lg_fold_stats(tr_values, tr_valid, train_mask, var_idx, parent_idx,
                  parent_mask, te_values=None, te_valid=None,
                  test_mask=None):
    """Plain torch version of the LG kernel (``csrc/lg_cv.cu``), on any
    device: fit F families on K folds of the training rows, then score each
    fold's test rows. Every statistic is taken in float64; float32 scores
    are one rounding of their float64 value.

    tr_values/tr_valid: (n, D) values (nulls zeroed) and 0/1 validity;
    train_mask: (K, n) 0/1 fold rows, or None for one fold of every row;
    var_idx (F,), parent_idx/parent_mask (F, P); te_values/te_valid: (m, D)
    test rows (the training frame itself for CV), or None for no test
    stage; test_mask: (K, m), or None for every row. Returns
    :class:`LgStats`."""
    dtype = tr_values.dtype
    f64 = torch.float64
    parent_mask = parent_mask.to(f64)
    design, w = _family_design(tr_values.to(f64), tr_valid.to(f64), var_idx,
                               parent_idx, parent_mask)
    wtr = w[:, None, :]
    if train_mask is not None:
        wtr = wtr * train_mask.to(f64)[None, :, :]            # (F, K, n)
    gram = torch.einsum("fkn,fni,fnj->fkij", wtr, design, design)
    n_eff = wtr.sum(dim=2)
    K = wtr.shape[1]
    pm = parent_mask[:, None, :].expand(-1, K, -1)
    beta, variance, _ = lg_params_from_gram(gram, pm, n_eff)
    bic = _bic(variance, torch.sum(pm, dim=-1), n_eff)
    scores = None
    if te_values is not None:
        design, w = _family_design(te_values.to(f64), te_valid.to(f64),
                                   var_idx, parent_idx, parent_mask)
        wte = w[:, None, :]
        if test_mask is not None:
            wte = wte * test_mask.to(f64)[None, :, :]
        mean = torch.einsum("fni,fki->fkn", design[:, :, :-1], beta)
        ll = _gaussian_ll(design[:, None, :, -1], mean, variance[:, :, None])
        fold_ll = torch.sum(ll * wte, dim=2)                  # (F, K)
        bad = (variance < _MACHINE_TOL) | ~torch.isfinite(variance)
        fold_ll = torch.where(bad, -math.inf, fold_ll)
        scores = torch.sum(fold_ll, dim=1).to(dtype)
    return LgStats(gram, n_eff, bic, scores)


def _lg_stats(tr_values, tr_valid, train_mask, var_idx, parent_idx,
              parent_mask, te_values=None, te_valid=None, test_mask=None):
    """:func:`lg_fold_stats` by the port's route: float32 on a GPU through
    the kernel (:func:`~.lg_cv_kernel.lg_cv_stats`), everything else
    through the plain version."""
    if kernel_route(tr_values):
        def c(t, dtype=torch.float32):
            return None if t is None else t.to(dtype).contiguous()

        return lg_cv_stats(
            c(tr_values), c(tr_valid), c(train_mask), c(var_idx, torch.int64),
            c(parent_idx, torch.int64), c(parent_mask), c(te_values),
            c(te_valid), c(test_mask))
    return lg_fold_stats(tr_values, tr_valid, train_mask, var_idx,
                         parent_idx, parent_mask, te_values, te_valid,
                         test_mask)


def batched_lg_cv_loglik(values, valid, train_mask, test_mask, var_idx,
                         parent_idx, parent_mask):
    """k-fold CV log-likelihood of F linear-Gaussian families in one batched
    call — the replacement for the reference's per-(family, fold) serial
    fit+slogl loop (learning/scores/cv_likelihood.cpp:11-25).

    values/valid: (n, D); train_mask/test_mask: (K, n) 0/1 row masks per
    fold (rows excluded from the CV — e.g. null rows — are 0 in both);
    var_idx: (F,) long; parent_idx/parent_mask: (F, P). Returns (F,) summed
    test log-likelihood across folds; -inf when any fold is degenerate."""
    return _lg_stats(values, valid, train_mask, var_idx, parent_idx,
                     parent_mask, values, valid, test_mask).scores


def batched_lg_holdout_loglik(train_values, train_valid, test_values,
                              test_valid, var_idx, parent_idx, parent_mask):
    """Fit on the training split, slogl on the test split, batched over F
    families (reference learning/scores/holdout_likelihood.cpp). Returns
    (F,); −inf where the fitted variance is degenerate."""
    return _lg_stats(train_values, train_valid, None, var_idx, parent_idx,
                     parent_mask, test_values, test_valid).scores
