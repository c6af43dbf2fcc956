"""Conditional Pearson χ² test on contingency tables
(reference learning/independences/discrete/chi_square.{hpp,cpp}).

Copied from ``pybnesian_tpu/learning/independences/chi_square.py``.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaincc

from ...data import DataFrame
from ...factors.discrete import create_cardinality_strides, joint_counts
from .base import DynamicIndependenceTest, IndependenceTest

__all__ = ["ChiSquare", "DynamicChiSquare"]


class ChiSquare(IndependenceTest):
    def __init__(self, df):
        self.df = DataFrame.wrap(df)
        for c in self.df.column_names():
            if not self.df.is_discrete(c):
                raise ValueError(
                    f"Column '{c}' is not categorical; ChiSquare requires "
                    "categorical data."
                )
        self._native_cache = None

    def variable_names(self) -> list[str]:
        return self.df.column_names()

    def _native_codes(self):
        if self._native_cache is None:
            cols = self.df.column_names()
            block = np.ascontiguousarray(
                np.stack([self.df.codes(c).astype(np.int32) for c in cols])
            )
            cards = np.array([self.df.cardinality(c) for c in cols], np.int64)
            self._native_cache = (
                {c: i for i, c in enumerate(cols)}, block, cards
            )
        return self._native_cache

    def pvalue_batch(self, triples) -> np.ndarray:
        """All tests of a sweep in one native counting pass
        (discretecore dc_chi2_batch; reference applies its serial C++ loop
        uniformly, pc.cpp:222-263). Falls back per-test on config-space
        overflow and wholesale without the native core."""
        from ..scores import discrete_native

        triples = list(triples)
        if not discrete_native.available() or not triples:
            return super().pvalue_batch(triples)
        pos, block, cards = self._native_codes()
        F = len(triples)
        maxz = max((len(zs) for _, _, zs in triples), default=0)
        maxz = max(maxz, 1)
        tx = np.empty(F, np.int32)
        ty = np.empty(F, np.int32)
        tz = np.full((F, maxz), -1, np.int32)
        dof = np.empty(F)
        try:
            for i, (x, y, zs) in enumerate(triples):
                tx[i] = xi = pos[x]
                ty[i] = yi = pos[y]
                zc = 1
                for j, zv in enumerate(zs):
                    tz[i, j] = zj = pos[zv]
                    zc *= cards[zj]
                dof[i] = (cards[xi] - 1) * (cards[yi] - 1) * zc
        except KeyError:
            return super().pvalue_batch(triples)
        if (dof <= 0).any():
            raise ValueError(
                "Chi-squared distribution requires dof > 0 "
                "(a tested column has a single category)."
            )
        stats = discrete_native.chi2_batch(block, cards, tx, ty, tz)
        bad = np.isnan(stats)
        out = gammaincc(0.5 * dof, 0.5 * np.where(bad, 0.0, stats))
        if bad.any():
            for i in np.nonzero(bad)[0]:
                x, y, zs = triples[i]
                out[i] = self.pvalue(x, y, *zs)
        return out

    def pvalue(self, x: str, y: str, *z: str) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        card, strides = create_cardinality_strides(self.df, x, [y, *z])
        counts = joint_counts(self.df, x, [y, *z], card, strides)
        c1, c2 = int(card[0]), int(card[1])
        z_configs = int(np.prod(card[2:])) if len(card) > 2 else 1
        tables = counts.reshape(z_configs, c2, c1)  # [z, y, x] (x fastest)
        statistic = 0.0
        for k in range(z_configs):
            tab = tables[k].astype(np.float64)
            total = tab.sum()
            if total == 0:
                continue
            mx = tab.sum(axis=0)  # marginal over x
            my = tab.sum(axis=1)  # marginal over y
            expected = np.outer(my, mx) / total
            nz = expected > 0
            statistic += float(((tab[nz] - expected[nz]) ** 2 / expected[nz]).sum())
        dof = (c1 - 1) * (c2 - 1) * z_configs
        if dof <= 0:
            # cardinality-1 column: boost::math::chi_squared_distribution
            # rejects df == 0 (reference chi_square.cpp:34)
            raise ValueError(
                "Chi-squared distribution requires dof > 0 "
                f"(got {dof}; a tested column has a single category)."
            )
        return float(gammaincc(0.5 * dof, 0.5 * statistic))  # chi2.sf via direct ufunc


class DynamicChiSquare(DynamicIndependenceTest):
    test_cls = ChiSquare
