"""Partial-correlation t-test
(reference learning/independences/continuous/linearcorrelation.{hpp,cpp}).

The covariance matrix over all continuous columns is cached once when the
data has no nulls (linearcorrelation.hpp:71-93); each test is then O(k³)
host algebra. Partial correlations use the eigendecomposition pseudo-inverse
with the reference's tolerance (cor_svd, linearcorrelation.hpp:27-45).

Copied from ``pybnesian_tpu/learning/independences/linearcorrelation.py``.
"""

from __future__ import annotations

import numpy as np
from scipy.special import stdtr

from ...data import DataFrame
from ...utils import MACHINE_TOL
from .base import DynamicIndependenceTest, IndependenceTest

__all__ = ["LinearCorrelation", "DynamicLinearCorrelation"]


def cor_pvalue(cor: float, df: int) -> float:
    denom = max(1.0 - cor * cor, 1e-300)
    statistic = cor * np.sqrt(df) / np.sqrt(denom)
    # 2·P(T_df > |t|) via the direct Student-t CDF ufunc — identical to
    # scipy.stats.t.sf but without the per-call distribution-framework
    # overhead that dominates PC runs (60% of wall-clock at 50 nodes)
    return float(2.0 * stdtr(df, -abs(statistic)))


def cor_0cond(cov: np.ndarray, i: int, j: int) -> float:
    if cov[i, i] < MACHINE_TOL or cov[j, j] < MACHINE_TOL:
        return 0.0
    return float(np.clip(cov[i, j] / np.sqrt(cov[i, i] * cov[j, j]), -1.0, 1.0))


def cor_general(cov: np.ndarray) -> float:
    """Partial correlation of variables 0, 1 given the rest via the
    pseudo-inverse (reference cor_svd)."""
    d, u = np.linalg.eigh(cov)
    tol = len(d) * d[-1] * np.finfo(np.float64).eps
    keep = d > tol
    if not keep.any():
        return 0.0
    inv_d = 1.0 / d[keep]
    u0 = u[0, keep]
    u1 = u[1, keep]
    p11 = float(np.sum(u0 * u0 * inv_d))
    p12 = float(np.sum(u0 * u1 * inv_d))
    p22 = float(np.sum(u1 * u1 * inv_d))
    if p11 < MACHINE_TOL or p22 < MACHINE_TOL:
        return 0.0
    return float(np.clip(-p12 / np.sqrt(p11 * p22), -1.0, 1.0))


class LinearCorrelation(IndependenceTest):
    def __init__(self, df):
        self.df = DataFrame.wrap(df)
        cont = self.df.continuous_columns()
        if len(cont) < 2:
            raise ValueError(
                "DataFrame does not contain enough continuous columns."
            )
        self._cached = self.df.null_count(*cont) == 0
        if self._cached:
            self._pos = {c: i for i, c in enumerate(cont)}
            self._cov = self.df.cov(cont)

    def variable_names(self) -> list[str]:
        return self.df.column_names()

    def pvalue(self, x: str, y: str, *z: str) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        if self._cached:
            n = self.df.num_rows
            if not z:
                cor = cor_0cond(self._cov, self._pos[x], self._pos[y])
            else:
                idx = [self._pos[x], self._pos[y]] + [self._pos[e] for e in z]
                cor = cor_general(self._cov[np.ix_(idx, idx)])
            return cor_pvalue(cor, n - 2 - len(z))
        cols = [x, y, *z]
        n = self.df.valid_rows(*cols)
        cov = self.df.cov(cols)
        if not z:
            cor = cor_0cond(cov, 0, 1)
        else:
            cor = cor_general(cov)
        return cor_pvalue(cor, n - 2 - len(z))

    # ------------------------------------------------------- batched paths
    def pvalue_batch(self, triples) -> np.ndarray:
        """Vectorized p-values for ``(x, y, zs)`` triples (mixed sizes).

        With the cached full-data covariance this groups tests by
        conditioning-set size and runs one stacked ``eigh`` per group —
        the whole PC order sweep becomes a few LAPACK batch calls instead
        of per-test Python. Null-bearing data falls back to the serial
        path (each test has its own row mask)."""
        triples = list(triples)
        if not self._cached:
            return super().pvalue_batch(triples)
        n = self.df.num_rows
        out = np.empty(len(triples))
        by_size: dict[int, list[int]] = {}
        for i, (_, _, zs) in enumerate(triples):
            by_size.setdefault(len(zs), []).append(i)
        for size, idxs in by_size.items():
            dof = n - 2 - size
            if size == 0:
                cors = np.array([
                    cor_0cond(self._cov, self._pos[triples[i][0]],
                              self._pos[triples[i][1]])
                    for i in idxs
                ])
            else:
                pos = np.array([
                    [self._pos[triples[i][0]], self._pos[triples[i][1]]]
                    + [self._pos[e] for e in triples[i][2]]
                    for i in idxs
                ])
                subs = self._cov[pos[:, :, None], pos[:, None, :]]
                cors = _cor_general_batch(subs)
            denom = np.maximum(1.0 - cors * cors, 1e-300)
            stat = cors * np.sqrt(dof) / np.sqrt(denom)
            out[idxs] = 2.0 * stdtr(dof, -np.abs(stat))
        return out


def _cor_general_batch(covs: np.ndarray) -> np.ndarray:
    """Stacked ``cor_general``: partial correlation of variables 0, 1 given
    the rest via the eigendecomposition pseudo-inverse, vectorized over the
    leading batch axis. Matches the scalar path bit-for-bit on each slice."""
    d, u = np.linalg.eigh(covs)  # d: (B, k) ascending, u: (B, k, k)
    k = covs.shape[-1]
    tol = k * d[:, -1] * np.finfo(np.float64).eps
    keep = d > tol[:, None]
    inv_d = np.where(keep, 1.0 / np.where(keep, d, 1.0), 0.0)
    u0 = u[:, 0, :]
    u1 = u[:, 1, :]
    p11 = np.sum(u0 * u0 * inv_d, axis=1)
    p12 = np.sum(u0 * u1 * inv_d, axis=1)
    p22 = np.sum(u1 * u1 * inv_d, axis=1)
    good = keep.any(axis=1) & (p11 >= MACHINE_TOL) & (p22 >= MACHINE_TOL)
    denom = np.sqrt(np.where(good, p11 * p22, 1.0))
    return np.where(good, np.clip(-p12 / denom, -1.0, 1.0), 0.0)


class DynamicLinearCorrelation(DynamicIndependenceTest):
    test_cls = LinearCorrelation
