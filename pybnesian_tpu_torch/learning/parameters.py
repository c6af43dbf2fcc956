"""Maximum-likelihood parameter estimation.

Rebuild of reference learning/parameters/mle_base.hpp:11 and
mle_LinearGaussianCPD.{hpp,cpp}. The per-factor closed forms (including the
singularity-guard ladder for 0/1/2/N parents) run on host in float64 — they
are O(n·k²) with tiny k and are not the hot path; the hot path (scoring many
candidate families) uses the batched device kernels in
:mod:`pybnesian_tpu.ops.gaussian`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..data import DataFrame
from ..utils import MACHINE_TOL

__all__ = [
    "LinearGaussianParams",
    "MLE",
    "MLELinearGaussianCPD",
    "MLEDiscreteFactor",
    "mle_lineargaussian",
]


@dataclasses.dataclass
class LinearGaussianParams:
    beta: np.ndarray  # [intercept, slopes...]
    variance: float


def mle_lineargaussian(df, variable: str, evidence) -> LinearGaussianParams:
    """Closed-form OLS ladder (reference mle_LinearGaussianCPD.hpp:12-230).

    variance = RSS / (n - k - 1); +inf when n <= k + 1. Constant parents get
    slope 0 (variance guard at machine tolerance)."""
    df = DataFrame.wrap(df)
    evidence = list(evidence)
    cols = [variable, *evidence]
    mat = df.to_numpy(cols, drop_null=True, dtype=np.float64)
    y = mat[:, 0]
    X = mat[:, 1:]
    n = len(y)
    k = len(evidence)

    if k == 0:
        if n == 0:
            return LinearGaussianParams(np.array([np.nan]), np.inf)
        mean = y.mean()
        if n == 1:
            return LinearGaussianParams(np.array([mean]), np.inf)
        var = float(np.sum((y - mean) ** 2) / (n - 1))
        return LinearGaussianParams(np.array([mean]), var)

    if k == 1:
        x = X[:, 0]
        my, mx = y.mean(), x.mean()
        dy, dx = y - my, x - mx
        var_x = float(dx @ dx) / (n - 1) if n > 1 else 0.0
        if var_x < MACHINE_TOL:
            beta = np.array([my, 0.0])
            resid = dy
        else:
            b = (float(dy @ dx) / (n - 1)) / var_x
            beta = np.array([my - b * mx, b])
            resid = dy - b * dx
        if n <= 2:
            return LinearGaussianParams(beta, np.inf)
        return LinearGaussianParams(beta, float(resid @ resid) / (n - 2))

    if k == 2:
        x1, x2 = X[:, 0], X[:, 1]
        m1, m2, my = x1.mean(), x2.mean(), y.mean()
        d1, d2, dy = x1 - m1, x2 - m2, y - my
        denom = max(n - 1, 1)
        v1 = float(d1 @ d1) / denom
        v2 = float(d2 @ d2) / denom
        c12 = float(d1 @ d2) / denom
        singular1 = v1 < MACHINE_TOL
        singular2 = v2 < MACHINE_TOL or (
            not singular1
            and abs(c12 / np.sqrt(v1 * v2)) > (1 - MACHINE_TOL)
        )
        if singular1 and singular2:
            beta = np.array([my, 0.0, 0.0])
            resid = dy
        elif singular1:
            cy2 = float(dy @ d2) / denom
            b2 = cy2 / v2
            beta = np.array([my - b2 * m2, 0.0, b2])
            resid = dy - b2 * d2
        elif singular2:
            cy1 = float(dy @ d1) / denom
            b1 = cy1 / v1
            beta = np.array([my - b1 * m1, b1, 0.0])
            resid = dy - b1 * d1
        else:
            cy1 = float(dy @ d1) / denom
            cy2 = float(dy @ d2) / denom
            den = v1 * v2 - c12 * c12
            b1 = (v2 * cy1 - c12 * cy2) / den
            b2 = (cy2 - b1 * c12) / v2
            beta = np.array([my - b1 * m1 - b2 * m2, b1, b2])
            resid = dy - b1 * d1 - b2 * d2
        if n <= 3:
            return LinearGaussianParams(beta, np.inf)
        return LinearGaussianParams(beta, float(resid @ resid) / (n - 3))

    # general case: least squares with intercept (QR, like the reference's
    # colPivHouseholderQr, mle_LinearGaussianCPD.hpp:173)
    design = np.column_stack([np.ones(n), X])
    beta, *_ = np.linalg.lstsq(design, y, rcond=None)
    if n <= k + 1:
        return LinearGaussianParams(beta, np.inf)
    resid = y - design @ beta
    return LinearGaussianParams(beta, float(resid @ resid) / (n - k - 1))


class MLELinearGaussianCPD:
    """MLE estimator for LinearGaussianCPD parameters — the concrete class the
    reference exposes as ``MLELinearGaussianCPD``
    (pybindings_learning/pybindings_parameters.cpp:64)."""

    def estimate(self, df, variable, evidence):
        return mle_lineargaussian(df, variable, evidence)


class MLEDiscreteFactor:
    """MLE estimator for DiscreteFactor CPTs
    (pybindings_learning/pybindings_parameters.cpp:166)."""

    def estimate(self, df, variable, evidence):
        from ..factors.discrete import mle_discrete

        return mle_discrete(df, variable, evidence)


def MLE(factor_type):
    """Factory mirroring the reference's ``MLE(factor_type)`` dispatcher
    (learning/parameters/mle_base.hpp:11): returns the concrete estimator
    object for the given FactorType."""
    from ..factors.lineargaussian import LinearGaussianCPDType
    from ..factors.discrete import DiscreteFactorType

    if factor_type == LinearGaussianCPDType():
        return MLELinearGaussianCPD()
    if factor_type == DiscreteFactorType():
        return MLEDiscreteFactor()
    raise ValueError(f"MLE not available for factor type {factor_type}")
