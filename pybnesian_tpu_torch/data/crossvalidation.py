"""Cross-validation and hold-out row splitters.

Rebuild of reference dataset/crossvalidation_adaptator.hpp:15-69 and
dataset/holdout_adaptator.hpp:17-70. Indices are shuffled once at
construction with a fixed seed; fold sizes follow the reference rule
(crossvalidation_adaptator.hpp:42-58): base size ``n // k`` with the
remainder spread over the first ``n % k`` folds.
"""

from __future__ import annotations

import numpy as np

from .dataframe import DataFrame

__all__ = ["CrossValidation", "HoldOut"]


class CrossValidation:
    def __init__(self, df, k: int = 10, seed: int | None = None, include_null: bool = False):
        self.df = DataFrame.wrap(df)
        if k < 2:
            raise ValueError("Number of folds must be at least 2")
        self.k = k
        self.seed = seed if seed is not None else 0
        self.include_null = include_null

        if include_null:
            indices = np.arange(self.df.num_rows)
        else:
            indices = np.nonzero(self.df.combined_mask())[0]
        if len(indices) < k:
            raise ValueError(
                f"Cannot split {len(indices)} usable rows into {k} folds"
            )
        rng = np.random.default_rng(self.seed)
        rng.shuffle(indices)
        self._indices = indices

        n = len(indices)
        fold_size = n // k
        extra = n % k
        limits = [0]
        cur = 0
        for i in range(k):
            cur += fold_size + (1 if i < extra else 0)
            limits.append(cur)
        self.limits = limits

    def __iter__(self):
        for i in range(self.k):
            yield self.fold(i)

    def fold(self, i: int):
        """(train_df, test_df) for fold i."""
        train_idx, test_idx = self.fold_indices(i)
        return self.df.take(train_idx), self.df.take(test_idx)

    def fold_indices(self, i: int):
        lo, hi = self.limits[i], self.limits[i + 1]
        test = self._indices[lo:hi]
        train = np.concatenate([self._indices[: lo], self._indices[hi:]])
        return train, test

    def indices(self):
        """Iterator over (train_indices, test_indices) per fold
        (reference pybindings_dataset.cpp:67)."""
        return self.indices_iter()

    def indices_iter(self):
        for i in range(self.k):
            yield self.fold_indices(i)

    def loc(self, cols):
        """CV over a column subset (reference crossvalidation_adaptator loc)."""
        cv = CrossValidation.__new__(CrossValidation)
        cv.df = self.df.loc(cols)
        cv.k = self.k
        cv.seed = self.seed
        cv.include_null = self.include_null
        cv._indices = self._indices
        cv.limits = self.limits
        return cv


class HoldOut:
    def __init__(self, df, test_ratio: float = 0.2, seed: int | None = None, include_null: bool = False):
        self.df = DataFrame.wrap(df)
        if not (0.0 < test_ratio < 1.0):
            raise ValueError(
                "test_ratio must be a number between 0 and 1."
            )
        self.seed = seed if seed is not None else 0
        self.test_ratio = test_ratio

        if include_null:
            indices = np.arange(self.df.num_rows)
        else:
            indices = np.nonzero(self.df.combined_mask())[0]
        rng = np.random.default_rng(self.seed)
        rng.shuffle(indices)
        test_rows = int(round(len(indices) * test_ratio))
        self._train_idx = indices[: len(indices) - test_rows]
        self._test_idx = indices[len(indices) - test_rows:]

    def training_data(self) -> DataFrame:
        return self.df.take(self._train_idx)

    def test_data(self) -> DataFrame:
        return self.df.take(self._test_idx)
