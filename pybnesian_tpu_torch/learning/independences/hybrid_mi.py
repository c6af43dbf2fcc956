"""Hybrid mutual-information test for mixed discrete/continuous data.

Rebuild of reference learning/independences/hybrid/mutual_information.
{hpp,cpp} (1,849 LoC — the largest learning file): a likelihood-ratio G-test
where entropies have closed forms — discrete plug-in entropies, Gaussian
entropies from per-configuration covariance determinants
(entropy_mvn, mutual_information.cpp:921-924) — and 2N·MI follows a χ²
asymptotic with exact or simulation-calibrated degrees of freedom
(``asymptotic_df`` flag; df formulas mutual_information.cpp:1093-1731).

Copied from ``pybnesian_tpu/learning/independences/hybrid_mi.py``.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import gammaincc

from ...data import DataFrame
from .base import DynamicIndependenceTest, IndependenceTest

__all__ = ["MutualInformation", "DynamicMutualInformation"]

_LOG_2PI = math.log(2 * math.pi)


def entropy_mvn(d: int, cov_det: float) -> float:
    """(reference mutual_information.cpp:921-924)."""
    if cov_det <= 0 or math.isnan(cov_det):
        return -math.inf
    return 0.5 * d + 0.5 * d * _LOG_2PI + 0.5 * math.log(cov_det)


def _entropy_mvn_vec(d: int, cov_dets: np.ndarray) -> np.ndarray:
    """Vectorized :func:`entropy_mvn`: −inf where the determinant is
    non-positive or NaN."""
    with np.errstate(invalid="ignore", divide="ignore"):
        out = 0.5 * d * (1.0 + _LOG_2PI) + 0.5 * np.log(cov_dets)
    return np.where(cov_dets > 0, out, -np.inf)


class MutualInformation(IndependenceTest):
    def __init__(self, df, asymptotic_df: bool = True):
        self.df = DataFrame.wrap(df)
        self.asymptotic_df = asymptotic_df
        for c in self.df.column_names():
            if not (self.df.is_discrete(c) or self.df.is_continuous(c)):
                raise ValueError(f"Wrong data type for column {c}.")
        self._native_cache = None

    def variable_names(self) -> list[str]:
        return self.df.column_names()

    def _native_codes(self):
        if self._native_cache is None:
            cols = self.df.discrete_columns()
            block = (
                np.ascontiguousarray(
                    np.stack(
                        [self.df.codes(c).astype(np.int32) for c in cols]
                    )
                )
                if cols
                else np.zeros((0, self.df.num_rows), np.int32)
            )
            cards = np.array(
                [self.df.cardinality(c) for c in cols], np.int64
            )
            self._native_cache = (
                {c: i for i, c in enumerate(cols)}, block, cards,
                frozenset(cols),
            )
        return self._native_cache

    def pvalue_batch(self, triples) -> np.ndarray:
        """Batched sweep: all-discrete tests (x, y and every z discrete —
        the G-test case, reference cmi_discrete_discrete) run as ONE native
        counting pass (discretecore dc_gtest_batch); tests touching
        continuous variables keep the serial grouped-moment path."""
        from ..scores import discrete_native

        triples = list(triples)
        if not triples or not discrete_native.available():
            return super().pvalue_batch(triples)
        pos, block, cards, disc = self._native_codes()
        nat = [
            i
            for i, (x, y, zs) in enumerate(triples)
            if x in disc and y in disc and all(zv in disc for zv in zs)
        ]
        out = np.empty(len(triples))
        nat_set = set(nat)
        rest = [i for i in range(len(triples)) if i not in nat_set]
        for i in rest:
            x, y, zs = triples[i]
            out[i] = self.pvalue(x, y, *zs)
        if not nat:
            return out
        F = len(nat)
        maxz = max((len(triples[i][2]) for i in nat), default=0)
        maxz = max(maxz, 1)
        tx = np.empty(F, np.int32)
        ty = np.empty(F, np.int32)
        tz = np.full((F, maxz), -1, np.int32)
        dof = np.empty(F)
        for f, i in enumerate(nat):
            x, y, zs = triples[i]
            tx[f] = pos[x]
            ty[f] = pos[y]
            for j, zv in enumerate(zs):
                tz[f, j] = pos[zv]
            dof[f] = self._calculate_df(x, y, list(zs), [])
        if (dof <= 0).any():
            raise ValueError(
                "Chi-squared distribution requires dof > 0 "
                "(a tested column has a single category)."
            )
        stats, _ns = discrete_native.gtest_batch(block, cards, tx, ty, tz)
        bad = np.isnan(stats)
        vals = gammaincc(
            0.5 * dof, np.maximum(np.where(bad, 0.0, stats), 0.0)
        )
        for f, i in enumerate(nat):
            if bad[f]:
                x, y, zs = triples[i]
                out[i] = self.pvalue(x, y, *zs)
            else:
                out[i] = vals[f]
        return out

    # ------------------------------------------------------------ helpers
    def _card(self, v: str) -> int:
        return self.df.cardinality(v)

    def _split_z(self, z):
        dz = [e for e in z if self.df.is_discrete(e)]
        cz = [e for e in z if not self.df.is_discrete(e)]
        return dz, cz

    def _config_index(self, disc_vars, valid_mask):
        """Flat config index over discrete vars (first var fastest) for valid
        rows; returns (idx array over all rows, num_configs, cards)."""
        if not disc_vars:
            return np.zeros(self.df.num_rows, np.int64), 1, []
        cards = [self._card(v) for v in disc_vars]
        idx = np.zeros(self.df.num_rows, np.int64)
        stride = 1
        for v, card in zip(disc_vars, cards):
            idx += self.df.codes(v).astype(np.int64) * stride
            stride *= card
        return idx, stride, cards

    def _grouped_cov_dets(self, cont_vars, config_idx, n_configs, valid):
        """Per-config determinant of the ddof-1 covariance of cont_vars.

        TWO grouped passes over the rows via weighted ``bincount`` (the
        reference does the equivalent grouped loop in C++,
        mutual_information.cpp:958-1033): the first accumulates per-config
        counts and sums (→ group means), the second accumulates products of
        group-CENTRED values. Per-group centring keeps full precision even
        when configuration means are far apart relative to the
        within-config spread (raw-moment assembly ``sq − n·μμᵀ`` cancels
        catastrophically there). Cost stays O(n·d²) independent of the
        number of configurations."""
        d = len(cont_vars)
        dets = np.full(n_configs, np.nan)
        if d == 0:
            return dets
        mat = self.df.to_numpy(cont_vars, drop_null=False, dtype=np.float64)
        from ..scores import discrete_native

        if (
            discrete_native.available()
            and d <= 16
            and n_configs * d * d <= 8_000_000
        ):
            cnt, _sums, sq = discrete_native.grouped_moments(
                mat, config_idx, valid, n_configs
            )
        else:
            sub = mat[valid]
            idx = config_idx[valid]
            cnt = np.bincount(idx, minlength=n_configs)
            sums = np.empty((n_configs, d))
            for j in range(d):
                sums[:, j] = np.bincount(idx, weights=sub[:, j],
                                         minlength=n_configs)
            gmean = sums / np.maximum(cnt, 1)[:, None]
            sub = sub - gmean[idx]
            sq = np.empty((n_configs, d, d))
            for j in range(d):
                for l in range(j, d):
                    s = np.bincount(idx, weights=sub[:, j] * sub[:, l],
                                    minlength=n_configs)
                    sq[:, j, l] = s
                    sq[:, l, j] = s
        ok = cnt > d
        if not ok.any():
            return dets
        nk = cnt[ok].astype(np.float64)
        cov = sq[ok] / (nk - 1.0)[:, None, None]
        dets[ok] = np.linalg.det(cov)
        return dets

    # ------------------------------------------------------------ marginal
    def _mi_discrete(self, x, y) -> float:
        valid = self.df.combined_mask(x, y)
        cx = self.df.codes(x)[valid].astype(np.int64)
        cy = self.df.codes(y)[valid].astype(np.int64)
        kx, ky = self._card(x), self._card(y)
        counts = np.bincount(cx + kx * cy, minlength=kx * ky).reshape(ky, kx)
        n = counts.sum()
        px = counts.sum(axis=0) / n
        py = counts.sum(axis=1) / n
        pij = counts / n
        nz = pij > 0
        outer = np.outer(py, px)
        return float(np.sum(pij[nz] * np.log(pij[nz] / outer[nz])))

    def _mi_mixed(self, discrete, continuous) -> float:
        """(reference mi_mixed_impl, mutual_information.cpp:958-1033)."""
        valid = self.df.combined_mask(discrete, continuous)
        codes = self.df.codes(discrete)[valid].astype(np.int64)
        vals = self.df.to_numpy([continuous], drop_null=False,
                                dtype=np.float64)[valid, 0]
        k = self._card(discrete)
        n = len(vals)
        total_var = vals.var(ddof=1)
        mi = 0.5 + 0.5 * math.log(2 * math.pi * total_var)
        for j in range(k):
            sel = codes == j
            cnt = int(sel.sum())
            if cnt > 0:
                pj = cnt / n
                var_j = vals[sel].var(ddof=1) if cnt > 1 else 0.0
                h = 0.5 + 0.5 * math.log(2 * math.pi * var_j) if var_j > 0 else -math.inf
                if math.isinf(h):
                    continue
                mi -= pj * h
        return max(mi, 0.0)

    def _mi_continuous(self, x, y) -> float:
        cov = self.df.cov([x, y])
        cor = cov[0, 1] / math.sqrt(cov[0, 0] * cov[1, 1])
        cor = min(max(cor, -1 + 1e-15), 1 - 1e-15)
        return -0.5 * math.log(1 - cor * cor)

    # ----------------------------------------------------------------- mi
    def mi(self, x: str, y: str, *z) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        if not z:
            if self.df.is_discrete(x):
                if self.df.is_discrete(y):
                    return self._mi_discrete(x, y)
                return self._mi_mixed(x, y)
            if self.df.is_discrete(y):
                return self._mi_mixed(y, x)
            return self._mi_continuous(x, y)
        dz, cz = self._split_z(z)
        if self.df.is_discrete(x) and self.df.is_discrete(y):
            if not cz:
                return self._cmi_discrete_discrete(x, y, dz)
            return self._cmi_both_discrete(x, y, dz, cz)
        if self.df.is_discrete(x):
            return self._cmi_mixed(x, y, dz, cz)
        if self.df.is_discrete(y):
            return self._cmi_mixed(y, x, dz, cz)
        return self._cmi_both_continuous(x, y, dz, cz)

    # ---------------------------------------------------- conditional cases
    def _cmi_discrete_discrete(self, x, y, dz) -> float:
        """(reference cmi_discrete_discrete)."""
        valid = self.df.combined_mask(x, y, *dz)
        zidx, zc, _ = self._config_index(dz, valid)
        cx = self.df.codes(x).astype(np.int64)
        cy = self.df.codes(y).astype(np.int64)
        kx, ky = self._card(x), self._card(y)
        flat = cx + kx * cy + kx * ky * zidx
        counts = np.bincount(flat[valid], minlength=kx * ky * zc).reshape(
            zc, ky, kx
        )
        n = counts.sum()
        pz = counts.sum(axis=(1, 2), keepdims=True) / n       # (zc,1,1)
        pxz = counts.sum(axis=1, keepdims=True) / n           # (zc,1,kx)
        pyz = counts.sum(axis=2, keepdims=True) / n           # (zc,ky,1)
        pxyz = counts / n
        pos = pxyz > 0
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = np.log(pz * pxyz / (pyz * pxz))
        return float(np.sum(pxyz[pos] * ratio[pos]))

    def _cmi_both_continuous(self, x, y, dz, cz) -> float:
        """x, y continuous (reference cmi_general_both_continuous)."""
        valid = self.df.combined_mask(x, y, *dz, *cz)
        zidx, zc, _ = self._config_index(dz, valid)
        n = int(valid.sum())
        counts = np.bincount(zidx[valid], minlength=zc)
        det_xyz = self._grouped_cov_dets([x, y, *cz], zidx, zc, valid)
        det_xz = self._grouped_cov_dets([x, *cz], zidx, zc, valid)
        det_yz = self._grouped_cov_dets([y, *cz], zidx, zc, valid)
        term = (
            _entropy_mvn_vec(len(cz) + 1, det_xz)
            + _entropy_mvn_vec(len(cz) + 1, det_yz)
            - _entropy_mvn_vec(len(cz) + 2, det_xyz)
        )
        if cz:
            term = term - _entropy_mvn_vec(
                len(cz), self._grouped_cov_dets(cz, zidx, zc, valid)
            )
        use = (counts > 0) & np.isfinite(term)
        mi = float(np.sum((counts[use] / n) * term[use]))
        return max(mi, 0.0)

    def _cmi_mixed(self, xd, yc, dz, cz) -> float:
        """x discrete, y continuous (reference cmi_general_mixed)."""
        valid = self.df.combined_mask(xd, yc, *dz, *cz)
        zidx, zc_n, _ = self._config_index(dz, valid)
        kx = self._card(xd)
        cx = self.df.codes(xd).astype(np.int64)
        xz_idx = cx + kx * zidx
        n = int(valid.sum())
        counts_xz = np.bincount(xz_idx[valid], minlength=kx * zc_n)
        counts_z = np.bincount(zidx[valid], minlength=zc_n)
        det_y_cz_given_xz = self._grouped_cov_dets([yc, *cz], xz_idx, kx * zc_n, valid)
        det_y_cz_given_z = self._grouped_cov_dets([yc, *cz], zidx, zc_n, valid)

        def _add(weights, counts_sel, h):
            use = (counts_sel > 0) & np.isfinite(h)
            return float(np.sum(weights[use] * h[use]))

        pxz = counts_xz / n
        pz = counts_z / n
        mi = -_add(pxz, counts_xz,
                   _entropy_mvn_vec(len(cz) + 1, det_y_cz_given_xz))
        mi += _add(pz, counts_z,
                   _entropy_mvn_vec(len(cz) + 1, det_y_cz_given_z))
        if cz:
            mi += _add(
                pxz, counts_xz,
                _entropy_mvn_vec(
                    len(cz),
                    self._grouped_cov_dets(cz, xz_idx, kx * zc_n, valid),
                ),
            )
            mi -= _add(
                pz, counts_z,
                _entropy_mvn_vec(
                    len(cz), self._grouped_cov_dets(cz, zidx, zc_n, valid)
                ),
            )
        return max(mi, 0.0)

    def _cmi_both_discrete(self, x, y, dz, cz) -> float:
        """x, y discrete with continuous z
        (reference cmi_general_both_discrete)."""
        valid = self.df.combined_mask(x, y, *dz, *cz)
        zidx, zc_n, _ = self._config_index(dz, valid)
        kx, ky = self._card(x), self._card(y)
        cx = self.df.codes(x).astype(np.int64)
        cy = self.df.codes(y).astype(np.int64)
        xyz_idx = cx + kx * cy + kx * ky * zidx
        xz_idx = cx + kx * zidx
        yz_idx = cy + ky * zidx
        n = int(valid.sum())
        counts_xyz = np.bincount(xyz_idx[valid], minlength=kx * ky * zc_n)
        counts_xz = np.bincount(xz_idx[valid], minlength=kx * zc_n)
        counts_yz = np.bincount(yz_idx[valid], minlength=ky * zc_n)
        counts_z = np.bincount(zidx[valid], minlength=zc_n)
        dcz = len(cz)
        h_xyz = _entropy_mvn_vec(
            dcz, self._grouped_cov_dets(cz, xyz_idx, kx * ky * zc_n, valid)
        ).reshape(zc_n, ky, kx)
        h_xz = _entropy_mvn_vec(
            dcz, self._grouped_cov_dets(cz, xz_idx, kx * zc_n, valid)
        ).reshape(zc_n, kx)
        h_yz = _entropy_mvn_vec(
            dcz, self._grouped_cov_dets(cz, yz_idx, ky * zc_n, valid)
        ).reshape(zc_n, ky)
        h_z = _entropy_mvn_vec(
            dcz, self._grouped_cov_dets(cz, zidx, zc_n, valid)
        )

        # layouts: xyz_idx = i + kx·j + kx·ky·k → (zc, ky, kx)
        cxyz = counts_xyz.reshape(zc_n, ky, kx)
        cxz3 = counts_xz.reshape(zc_n, kx)
        cyz3 = counts_yz.reshape(zc_n, ky)
        pxyz = cxyz / n
        with np.errstate(invalid="ignore", divide="ignore"):
            term = np.log(
                (counts_z / n)[:, None, None] * pxyz
                / ((cxz3 / n)[:, None, :] * (cyz3 / n)[:, :, None])
            )
        term = term - np.where(np.isfinite(h_xyz), h_xyz, 0.0)
        pos = cxyz > 0
        mi = float(np.sum(pxyz[pos] * term[pos]))

        use = (cxz3 > 0) & np.isfinite(h_xz)
        mi += float(np.sum((cxz3[use] / n) * h_xz[use]))
        use = (cyz3 > 0) & np.isfinite(h_yz)
        mi += float(np.sum((cyz3[use] / n) * h_yz[use]))
        use = (counts_z > 0) & np.isfinite(h_z)
        mi -= float(np.sum((counts_z[use] / n) * h_z[use]))
        return max(mi, 0.0)

    # --------------------------------------------------- degrees of freedom
    def _calculate_df(self, x, y, dz, cz) -> float:
        """(reference mutual_information.cpp df functions)."""
        llz = 1
        for v in dz:
            llz *= self._card(v)
        zc = len(cz)
        xd = self.df.is_discrete(x)
        yd = self.df.is_discrete(y)
        if xd and yd:
            llx, lly = self._card(x), self._card(y)
            if not dz and not cz:
                return (llx - 1) * (lly - 1)
            if self.asymptotic_df:
                return (llx - 1) * (lly - 1) * llz * (1 + 0.5 * zc * (zc + 3))
            return (llx - 1) * (lly - 1) * llz * (1 + 0.5 * zc * (zc + 1))
        if xd or yd:
            lld = self._card(x if xd else y)
            if not dz and not cz:
                return (lld - 1) * 2 if self.asymptotic_df else (lld - 1)
            if self.asymptotic_df:
                return (lld - 1) * llz * (zc + 2)
            return (lld - 1) * llz * (zc + 1)
        if not dz and not cz:
            return 1
        return llz

    # --------------------------------------------------------------- pvalue
    def pvalue(self, x: str, y: str, *z) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        mi_value = self.mi(x, y, *z)
        n = self.df.valid_rows(x, y, *z)
        dz, cz = self._split_z(z)
        dof = self._calculate_df(x, y, dz, cz)
        if dof <= 0:
            # boost::math::chi_squared_distribution rejects df == 0
            # (reference mutual_information.cpp:1131)
            raise ValueError(
                "Chi-squared distribution requires dof > 0 "
                f"(got {dof} for MutualInformation({x}, {y} | {z}))."
            )
        # clamp: MI estimates round to tiny negatives for exactly-independent
        # tables; chi2.sf treated them as p=1, gammaincc would return nan
        return float(gammaincc(0.5 * dof, max(n * mi_value, 0.0)))


class DynamicMutualInformation(DynamicIndependenceTest):
    test_cls = MutualInformation
