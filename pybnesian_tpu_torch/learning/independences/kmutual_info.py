"""CMIknn: k-NN (conditional) mutual information test with local permutation
p-values (Runge 2018).

Rebuild of reference learning/independences/continuous/mutual_information.
{hpp,cpp}: rank-transform data once, Kraskov-style CMI estimator, p-value =
fraction of (locally) shuffled estimates ≥ the observed one. All
``samples`` permutations of a test, and the observed estimate with them,
evaluate on the device in chunks of one call
(:mod:`pybnesian_tpu_torch.ops.knn`) instead of the reference's
per-permutation kd-tree rebuilds.

Copied from ``pybnesian_tpu/learning/independences/kmutual_info.py``: the
ranks, the host shuffles (numpy's per-test ``default_rng(seed)`` and the
native ``lgf_local_shuffle``) are the same, so a seed draws what it draws
there; the estimates run on tensors on :func:`default_device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ...data import DataFrame
from ...ops.knn import cmi_knn_conditional_tests, cmi_knn_pair_tests
from ...runtime.device import default_device
from .base import DynamicIndependenceTest, IndependenceTest

__all__ = ["KMutualInformation", "DynamicKMutualInformation", "rank_data"]

# tests per device call: each holds its (S + 1, N) draws and, given z, its
# (N, N) z-distances
_TESTS_PER_CALL = 8


def rank_data(mat: np.ndarray) -> np.ndarray:
    """Per-column 0-based ordinal ranks (reference
    mutual_information.hpp:16-54)."""
    out = np.empty_like(mat, dtype=np.float64)
    for j in range(mat.shape[1]):
        order = np.argsort(mat[:, j], kind="stable")
        out[order, j] = np.arange(len(mat))
    return out


class KMutualInformation(IndependenceTest):
    def __init__(self, df, k: int, seed: int | None = None,
                 shuffle_neighbors: int = 5, samples: int = 1000):
        self.df = DataFrame.wrap(df)
        self.k = int(k)
        self.seed = seed if seed is not None else 0
        self.shuffle_neighbors = int(shuffle_neighbors)
        self.samples = int(samples)
        self.device = default_device()
        cols = self.df.column_names()
        mat = self.df.to_numpy(cols, drop_null=False, dtype=np.float64)
        # the reference ranks raw_values with no null handling
        # (mutual_information.hpp:29-38) — undefined on null data. Here null
        # rows are DROPPED before ranking (listwise): np.argsort would
        # otherwise rank NaNs as extreme values and silently bias the CMI
        # estimate.
        complete = ~np.isnan(mat).any(axis=1)
        if not complete.all():
            mat = mat[complete]
        # the conditional-pvalue local shuffle draws shuffle_neighbors
        # OTHER rows per row, so it needs strictly more rows than either
        # bound
        min_rows = max(self.k, self.shuffle_neighbors)
        if len(mat) <= min_rows:
            raise ValueError(
                "KMutualInformation requires more complete rows than "
                f"max(k, shuffle_neighbors) (have {len(mat)}, k={self.k}, "
                f"shuffle_neighbors={self.shuffle_neighbors})."
            )
        self._ranked = rank_data(mat)
        self._pos = {c: i for i, c in enumerate(cols)}

    def variable_names(self) -> list[str]:
        return self.df.column_names()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """Ranks or rank distances on the device as float32, which holds
        these integers exactly."""
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    def _estimates(self, xs_t, ys_t, dz_t=None) -> np.ndarray:
        """(T, S) estimates of T tests' draws xs_t (T, S, N) against ys_t
        (T, N), given z where ``dz_t`` (T, N, N) is passed."""
        xs, ys = self._tensor(xs_t), self._tensor(ys_t)
        if dz_t is None:
            vals = cmi_knn_pair_tests(xs, ys, self.k)
        else:
            vals = cmi_knn_conditional_tests(xs, ys, self._tensor(dz_t),
                                             self.k)
        return vals.cpu().numpy()

    # ------------------------------------------------------------------- mi
    def mi(self, x: str, y: str, *z: str) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        xr = self._ranked[:, self._pos[x]]
        yr = self._ranked[:, self._pos[y]]
        dz = self._z_distances(z)[None] if z else None
        return float(self._estimates(xr[None, None], yr[None], dz)[0, 0])

    def _z_distances(self, z) -> np.ndarray:
        zr = self._ranked[:, [self._pos[e] for e in z]]
        return np.max(np.abs(zr[:, None, :] - zr[None, :, :]), axis=2)

    # ------------------------------------------------------------- shuffles
    def _marginal_perms(self, xr: np.ndarray, rng) -> np.ndarray:
        return np.stack([rng.permutation(xr) for _ in range(self.samples)])

    def _cond_neighbors(self, dz: np.ndarray) -> np.ndarray:
        """Per-row ``shuffle_neighbors`` nearest z-neighbours (self
        excluded). An O(n²) argpartition narrows each row to a small
        candidate set before ordering it — the previous full stable
        argsort was O(n² log n) and dominated conditional p-values. Rank
        ties make the k-smallest SET implementation-defined either way;
        candidates are ordered (distance, index) so the draw stays
        deterministic."""
        n = len(dz)
        m = self.shuffle_neighbors
        kk = min(m + 1, n - 1)  # +1: self is always among the smallest
        part = np.argpartition(dz, kk, axis=1)[:, : kk + 1]
        pdist = np.take_along_axis(dz, part, axis=1)
        # stable order within candidates by (distance, index)
        sub = np.lexsort((part, pdist), axis=1)
        ordered = np.take_along_axis(part, sub, axis=1)
        neighbors = np.empty((n, m), dtype=np.int64)
        for i in range(n):
            row = ordered[i]
            row = row[row != i][:m]
            neighbors[i] = row
        return neighbors

    def _local_shuffle_all(self, xr: np.ndarray, neighbors: np.ndarray,
                           rng) -> np.ndarray:
        """All ``samples`` locally-shuffled draws. Native batch when the
        compiled core is available (~50x the Python loop; deterministic
        per-seed stream shared by serial and batched p-values), Python
        loop otherwise."""
        from ...models.base import _lgfast_mod

        mod = _lgfast_mod()
        if mod is not None and neighbors.shape[1] > 0:
            out = np.empty((self.samples, len(xr)))
            mod.lgf_local_shuffle(
                np.ascontiguousarray(xr),
                np.ascontiguousarray(neighbors, np.int32),
                self.samples,
                int(self.seed),
                out,
            )
            return out
        return np.stack(
            [
                self._local_shuffle(xr, neighbors, rng)
                for _ in range(self.samples)
            ]
        )

    def _local_shuffle(self, x_rank: np.ndarray, neighbors: np.ndarray,
                       rng) -> np.ndarray:
        """Permute x within z-neighbourhoods, then re-rank
        (reference shuffle_dataframe, mutual_information.hpp:119-160)."""
        n = len(x_rank)
        shuffled = np.empty(n)
        used = np.zeros(n, dtype=bool)
        order = rng.permutation(n)
        m = neighbors.shape[1]
        for idx in order:
            cand = neighbors[idx][rng.permutation(m)]
            pick = cand[-1]
            for c in cand:
                if not used[c]:
                    pick = c
                    break
            if used[pick]:
                shuffled[idx] = x_rank[pick] + rng.uniform(-0.4, 0.4)
            else:
                shuffled[idx] = x_rank[pick]
            used[pick] = True
        # re-rank to integers
        out = np.empty(n)
        order2 = np.argsort(shuffled, kind="stable")
        out[order2] = np.arange(n)
        return out

    # -------------------------------------------------------------- pvalue
    def _draws(self, x: str, zs) -> tuple[np.ndarray, np.ndarray | None]:
        """(S + 1, N) draws of one test — row 0 the observed x, then the
        ``samples`` (locally) shuffled ones from a ``default_rng(seed)`` of
        its own — and its z-distances (None without z)."""
        rng = np.random.default_rng(self.seed)
        xr = self._ranked[:, self._pos[x]]
        if not zs:
            return np.vstack([xr[None], self._marginal_perms(xr, rng)]), None
        dz = self._z_distances(list(zs))
        shuffled = self._local_shuffle_all(xr, self._cond_neighbors(dz), rng)
        return np.vstack([xr[None], shuffled]), dz

    def pvalue(self, x: str, y: str, *z: str) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        return float(self.pvalue_batch([(x, y, tuple(z))])[0])

    # -------------------------------------------------------- batched sweep
    def pvalue_batch(self, triples) -> np.ndarray:
        """Every test evaluates its own ``samples`` permutations with its
        observed estimate beside them (row 0); up to
        :data:`_TESTS_PER_CALL` marginal or conditional tests of a sweep
        share a device call. Per-test streams are the
        serial path's (the same per-test rng seeding), and a row's estimate
        does not depend on its batch, so one test alone and in a sweep
        gets the same p-value."""
        triples = [(x, y, tuple(zs)) for (x, y, zs) in triples]
        out = np.empty(len(triples))
        marg = [i for i, t in enumerate(triples) if not t[2]]
        cond = [i for i, t in enumerate(triples) if t[2]]

        def run_chunk(idxs):
            draws = [self._draws(triples[i][0], triples[i][2]) for i in idxs]
            xs_t = np.stack([d[0] for d in draws])
            ys_t = np.stack([self._ranked[:, self._pos[triples[i][1]]]
                             for i in idxs])
            dz_t = (np.stack([d[1] for d in draws])
                    if triples[idxs[0]][2] else None)
            vals = self._estimates(xs_t, ys_t, dz_t)
            for j, i in enumerate(idxs):
                out[i] = float(np.mean(vals[j, 1:] >= vals[j, 0]))

        for idxs in (marg, cond):
            for c0 in range(0, len(idxs), _TESTS_PER_CALL):
                run_chunk(idxs[c0:c0 + _TESTS_PER_CALL])
        return out


class DynamicKMutualInformation(DynamicIndependenceTest):
    test_cls = KMutualInformation
