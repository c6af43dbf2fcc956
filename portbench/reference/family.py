"""Family scores of the reference: PyBNesian's k-fold CV likelihood and
hold-out likelihood of linear-Gaussian and CKDE families, over the row
splits that a seed defines."""

from __future__ import annotations

import math

import numpy as np
import torch

from .kde import ckde_logl, normal_reference, positive_definite
from .lg import lg_fit, lg_logl

LG = "LinearGaussianFactor"
CKDE = "CKDEFactor"


def holdout_split(n, ratio, seed):
    """(train, test) row indices: the rows shuffled once by the seed, the
    last round(n * ratio) held out."""
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    test = int(round(n * ratio))
    return idx[: n - test], idx[n - test:]


def cv_folds(n, k, seed):
    """[(train, test)] row indices of k folds: the rows shuffled once by
    the seed, fold i the i-th of k consecutive runs of n // k rows, the
    first n % k runs one row longer."""
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    bounds = np.cumsum([0, *sizes])
    return [(np.concatenate([idx[: bounds[i]], idx[bounds[i + 1]:]]),
             idx[bounds[i]: bounds[i + 1]]) for i in range(k)]


def factor_logl(kind, train, test, dtype=torch.float64, H=None):
    """Summed log-likelihood of ``test`` under a factor of ``kind`` fitted
    on ``train``; both (N, 1 + parents) tensors, variable first. A CKDE
    takes the normal-reference bandwidth unless ``H`` is given. -inf where
    the fit is degenerate."""
    if kind == LG:
        beta, variance = lg_fit(train[:, 0], train[:, 1:], dtype)
        if not (variance > 0 and math.isfinite(variance)):
            return -math.inf
        return float(lg_logl(test[:, 0], test[:, 1:], beta, variance,
                             dtype).sum())
    if H is None:
        H = normal_reference(train)
    if not positive_definite(H):
        return -math.inf
    value = float(ckde_logl(train, test, H, dtype).sum())
    return value if math.isfinite(value) else -math.inf


class FamilyScores:
    """The CV and hold-out scores of families of one frame, cached by
    (variable, parent set, kind).

    ``columns``: {name: float64 tensor}; ``folds``: the CV folds over the
    rows of ``columns``; ``holdout``: (train rows, test rows) for the
    validation channel, or None."""

    def __init__(self, columns, folds, holdout=None, dtype=torch.float64):
        self.columns = columns
        self.folds = [(torch.as_tensor(tr, device=self._device()),
                       torch.as_tensor(te, device=self._device()))
                      for tr, te in folds]
        self.holdout = None if holdout is None else tuple(
            torch.as_tensor(r, device=self._device()) for r in holdout)
        self.dtype = dtype
        self._cv: dict = {}
        self._ho: dict = {}

    def _device(self):
        return next(iter(self.columns.values())).device

    def matrix(self, variable, parents):
        return torch.stack([self.columns[c] for c in (variable, *parents)],
                           dim=1)

    def cv(self, variable, parents, kind, bandwidths=None):
        """The CV score: a factor fitted on each fold's train rows, scored
        on its test rows, summed. ``bandwidths``: one (d, d) matrix per
        fold over [variable, *parents] in the order given, in place of the
        normal reference (not cached)."""
        key = (variable, frozenset(parents), kind)
        if bandwidths is None and key in self._cv:
            return self._cv[key]
        X = self.matrix(variable, parents if bandwidths is not None
                        else sorted(parents))
        total = 0.0
        for k, (tr, te) in enumerate(self.folds):
            H = None if bandwidths is None else bandwidths[k]
            total += factor_logl(kind, X[tr], X[te], self.dtype, H)
        if bandwidths is None:
            self._cv[key] = total
        return total

    def scored(self):
        """(channel, variable, parents, kind, value) of every score
        worked out so far."""
        return ([("cv", v, tuple(ps), kind, val)
                 for (v, ps, kind), val in self._cv.items()]
                + [("validation", v, tuple(ps), kind, val)
                   for (v, ps, kind), val in self._ho.items()])

    def validation(self, variable, parents, kind):
        """The hold-out score: fitted on the hold-out train rows, scored on
        its test rows."""
        key = (variable, frozenset(parents), kind)
        if key not in self._ho:
            X = self.matrix(variable, sorted(parents))
            tr, te = self.holdout
            self._ho[key] = factor_logl(kind, X[tr], X[te], self.dtype)
        return self._ho[key]
