"""Bandwidth selectors (reference kde/BandwidthSelector.hpp:10,
kde/NormalReferenceRule.hpp, kde/ScottsBandwidth.hpp). UCV lives in ucv.py.

Host-side: bandwidth estimation is O(n·d²) covariance work on tiny d — the
device path starts at KDE evaluation.
"""

from __future__ import annotations

import numpy as np

from ..data import DataFrame
from ..utils.exceptions import SingularCovarianceData

__all__ = ["BandwidthSelector", "NormalReferenceRule", "ScottsBandwidth"]


def _is_psd(m: np.ndarray) -> bool:
    try:
        np.linalg.cholesky(m)
        return True
    except np.linalg.LinAlgError:
        return False


def _check_rows(df: DataFrame, variables, need: int, kind: str):
    valid = df.valid_rows(*variables)
    if valid <= need:
        raise SingularCovarianceData(
            f"{kind} bandwidth matrix of {len(variables)} variables "
            f"{list(variables)} cannot be estimated with {valid} instances"
        )


def _checked_cov(df: DataFrame, variables) -> np.ndarray:
    cov = df.cov(variables)
    if not _is_psd(cov):
        raise SingularCovarianceData(
            f"Covariance matrix for variables {list(variables)} is not "
            "positive-definite."
        )
    return cov


class BandwidthSelector:
    """Python-subclassable (the reference's keep_python_alive extension
    contract, pybindings_kde.cpp:19)."""

    def bandwidth(self, df, variables) -> np.ndarray:
        raise NotImplementedError(
            'Tried to call pure virtual function "BandwidthSelector::bandwidth"'
        )

    def diag_bandwidth(self, df, variables) -> np.ndarray:
        raise NotImplementedError(
            'Tried to call pure virtual function '
            '"BandwidthSelector::diag_bandwidth"'
        )

    def ToString(self) -> str:
        return type(self).__name__

    def __str__(self) -> str:
        return self.ToString()


class NormalReferenceRule(BandwidthSelector):
    """H = (4 / (N(d+2)))^{2/(d+4)} Σ (reference NormalReferenceRule.hpp:109);
    diagonal variant per Chacón & Duong (2018) eq. 3.4 (:73-106)."""

    def bandwidth(self, df, variables) -> np.ndarray:
        variables = list(variables)
        if not variables:
            return np.zeros((0, 0))
        df = DataFrame.wrap(df)
        _check_rows(df, variables, len(variables), "Bandwidth")
        cov = _checked_cov(df, variables)
        n = df.valid_rows(*variables)
        d = len(variables)
        k = (4.0 / (n * (d + 2.0))) ** (2.0 / (d + 4.0))
        return k * cov

    def diag_bandwidth(self, df, variables) -> np.ndarray:
        variables = list(variables)
        if not variables:
            return np.zeros(0)
        df = DataFrame.wrap(df)
        _check_rows(df, variables, len(variables), "Diagonal")
        cov = _checked_cov(df, variables)
        diag = np.diag(cov).copy()
        delta = cov / diag[:, None]
        delta_inv = np.linalg.inv(delta)
        n = df.valid_rows(*variables)
        d = float(len(variables))
        tr = np.trace(delta_inv)
        k = (
            4.0
            * d
            * np.sqrt(np.linalg.det(delta))
            / (2.0 * np.trace(delta_inv @ delta_inv) + tr * tr)
        )
        return (k / n) ** (2.0 / (d + 4.0)) * diag

    def ToString(self) -> str:
        return "NormalReferenceRule"


class ScottsBandwidth(BandwidthSelector):
    """H = N^{-2/(d+4)} Σ (reference ScottsBandwidth.hpp:90-116) — the same
    factor as scipy.stats.gaussian_kde's default."""

    def bandwidth(self, df, variables) -> np.ndarray:
        variables = list(variables)
        if not variables:
            return np.zeros((0, 0))
        df = DataFrame.wrap(df)
        _check_rows(df, variables, len(variables), "Bandwidth")
        cov = _checked_cov(df, variables)
        n = df.valid_rows(*variables)
        d = len(variables)
        return n ** (-2.0 / (d + 4.0)) * cov

    def diag_bandwidth(self, df, variables) -> np.ndarray:
        variables = list(variables)
        if not variables:
            return np.zeros(0)
        df = DataFrame.wrap(df)
        _check_rows(df, variables, 1, "Diagonal")
        n = df.valid_rows(*variables)
        d = len(variables)
        k = n ** (-2.0 / (d + 4.0))
        mat = df.to_numpy(variables, drop_null=True, dtype=np.float64)
        return k * mat.var(axis=0, ddof=1)

    def ToString(self) -> str:
        return "ScottsBandwidth"
