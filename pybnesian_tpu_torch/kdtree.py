"""KDTree: k-NN queries and subspace ball counts.

API rebuild of reference kdtree/kdtree.{hpp,cpp} (748 LoC median-split tree),
copied from ``pybnesian_tpu/kdtree.py``. Queries run on the host through
scipy.spatial.cKDTree.
"""

from __future__ import annotations

import numpy as np

from .data import DataFrame

__all__ = ["KDTree"]


class KDTree:
    def __init__(self, df=None, leafsize: int = 16):
        self.leafsize = leafsize
        self._tree = None
        self._data = None
        self._columns = None
        if df is not None:
            self.fit(df)

    def fit(self, df) -> None:
        df = DataFrame.wrap(df)
        self._columns = df.column_names()
        self._data = df.to_numpy(self._columns, drop_null=True,
                                 dtype=np.float64)
        from scipy.spatial import cKDTree

        self._tree = cKDTree(self._data, leafsize=self.leafsize)

    def num_instances(self) -> int:
        return 0 if self._data is None else len(self._data)

    def data(self) -> np.ndarray:
        return self._data

    def query(self, test_df, k: int = 1, p: float = np.inf):
        """(distances (n, k), indices (n, k)) of the k nearest training
        neighbours in Minkowski-p metric (reference kdtree.hpp:340-346)."""
        test = DataFrame.wrap(test_df).to_numpy(
            self._columns, drop_null=True, dtype=np.float64
        )
        dist, idx = self._tree.query(test, k=k, p=p)
        if k == 1:
            dist = dist[:, None]
            idx = idx[:, None]
        return dist, idx

    def count_ball_subspaces(self, test_df, x_data, y_data, eps):
        """Counts within Chebyshev balls of per-point radius eps in the
        (x, z), (y, z) and (z) subspaces (reference kdtree.hpp:348-355).
        Distances are strict (<) and include the point itself."""
        test = DataFrame.wrap(test_df).to_numpy(
            self._columns, drop_null=True, dtype=np.float64
        )
        x = np.asarray(x_data, dtype=np.float64).ravel()
        y = np.asarray(y_data, dtype=np.float64).ravel()
        eps = np.asarray(eps, dtype=np.float64).ravel()
        n = len(test)
        n_xz = np.empty(n, dtype=np.int64)
        n_yz = np.empty(n, dtype=np.int64)
        n_z = np.empty(n, dtype=np.int64)
        train = self._data
        # chunked brute force (z dims are usually tiny)
        chunk = max(1, int(4e6 // max(len(train), 1)))
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            dz = np.max(
                np.abs(test[start:stop, None, :] - train[None, :, :]), axis=2
            )
            within_z = dz < eps[start:stop, None]
            n_z[start:stop] = within_z.sum(axis=1)
            dx = np.abs(x[start:stop, None] - x[None, :])
            dy = np.abs(y[start:stop, None] - y[None, :])
            n_xz[start:stop] = (within_z & (dx < eps[start:stop, None])).sum(axis=1)
            n_yz[start:stop] = (within_z & (dy < eps[start:stop, None])).sum(axis=1)
        return n_xz, n_yz, n_z
