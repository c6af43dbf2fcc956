"""LinearGaussianCPD: y | evidence ~ N(beta0 + beta·evidence, variance).

Rebuild of reference factors/continuous/LinearGaussianCPD.{hpp,cpp} (565 LoC).
Parameters live on host (they are a handful of floats); per-row logl/cdf
evaluate as vectorized numpy/jnp expressions. Batched multi-family evaluation
(the structure-search hot path) goes through
:mod:`pybnesian_tpu.ops.gaussian` instead of this class.
"""

from __future__ import annotations

import math

import numpy as np

from ..data import DataFrame
from .base import Factor, FactorType

__all__ = ["LinearGaussianCPDType", "LinearGaussianCPD"]

_LOG_2PI = math.log(2 * math.pi)


class LinearGaussianCPDType(FactorType):
    def new_factor(self, model, variable, evidence, *args, **kwargs):
        """Dispatch to CLinearGaussianCPD when any evidence node is discrete
        (reference LinearGaussianCPD.cpp:33-59)."""
        if model is not None:
            from .discrete import DiscreteFactorType

            for e in evidence:
                if model.node_type(e) == DiscreteFactorType():
                    from .hybrid import CLinearGaussianCPD

                    return CLinearGaussianCPD(variable, evidence, *args, **kwargs)
        return LinearGaussianCPD(variable, evidence, *args, **kwargs)

    def ToString(self) -> str:
        return "LinearGaussianFactor"


class LinearGaussianCPD(Factor):
    # slotted: LG factors are created per node on every fit of an all-LG
    # network — the serial tier's hot allocation path
    __slots__ = ("_fitted", "_beta", "_variance")

    def __init__(self, variable, evidence=(), beta=None, variance=None):
        super().__init__(variable, evidence)
        self._fitted = False
        self._beta = None
        self._variance = None
        if beta is not None or variance is not None:
            beta = np.asarray(beta, dtype=np.float64).ravel()
            if len(beta) != len(self._evidence) + 1:
                raise ValueError(
                    f"Wrong number of beta parameters. Beta vector size: "
                    f"{len(beta)}. Expected beta vector size: "
                    f"{len(self._evidence) + 1}."
                )
            if variance is None or variance <= 0:
                raise ValueError("Variance must be a positive value.")
            self._beta = beta
            self._variance = float(variance)
            self._fitted = True

    # ------------------------------------------------------------- surface
    def type(self) -> FactorType:
        return LinearGaussianCPDType()

    def fitted(self) -> bool:
        return self._fitted

    @property
    def beta(self) -> np.ndarray:
        return self._beta

    @beta.setter
    def beta(self, value):
        value = np.asarray(value, dtype=np.float64).ravel()
        if len(value) != len(self._evidence) + 1:
            raise ValueError(
                f"Wrong number of beta parameters. Beta vector size: "
                f"{len(value)}. Expected beta vector size: "
                f"{len(self._evidence) + 1}."
            )
        self._beta = value

    @property
    def variance(self) -> float:
        return self._variance

    @variance.setter
    def variance(self, value):
        if value <= 0:
            raise ValueError("Variance must be a positive value.")
        self._variance = float(value)

    def data_type(self):
        """Always float64 (reference LinearGaussianCPD params are double)."""
        from ..data.arrow_interop import pa

        return pa.float64()

    # ------------------------------------------------------------------ fit
    def fit(self, df) -> None:
        from ..learning.parameters import mle_lineargaussian

        params = mle_lineargaussian(df, self._variable, self._evidence)
        self._beta = params.beta
        self._variance = params.variance
        self._fitted = True

    # ----------------------------------------------------------------- logl
    def _check_fitted(self):
        if not self._fitted:
            raise ValueError(
                f"Factor P({self._variable} | {self._evidence}) not fitted."
            )

    def _mean_and_y(self, df):
        df = DataFrame.wrap(df)
        cols = [self._variable, *self._evidence]
        mat = df.to_numpy(cols, drop_null=False, dtype=np.float64)
        y = mat[:, 0]
        mean = self._beta[0] + mat[:, 1:] @ self._beta[1:]
        null = ~df.combined_mask(*cols)
        return y, mean, null

    def logl(self, df) -> np.ndarray:
        """Per-row log-likelihood; NaN at rows with nulls in the family
        (reference LinearGaussianCPD.cpp:123-139)."""
        self._check_fitted()
        y, mean, null = self._mean_and_y(df)
        ll = (
            -0.5 * np.square(y - mean) / self._variance
            - 0.5 * np.log(self._variance)
            - 0.5 * _LOG_2PI
        )
        ll[null] = np.nan
        return ll

    def slogl(self, df) -> float:
        self._check_fitted()
        from ..models.base import _lg_factor_native_slogl

        out = _lg_factor_native_slogl(self, df)
        if out is not None:
            return out
        return float(np.nansum(self.logl(df)))

    def cdf(self, df) -> np.ndarray:
        self._check_fitted()
        from scipy.stats import norm

        y, mean, null = self._mean_and_y(df)
        out = norm.cdf(y, loc=mean, scale=math.sqrt(self._variance))
        out[null] = np.nan
        return out

    # --------------------------------------------------------------- sample
    def sample(self, n: int, evidence_values=None, seed: int | None = None):
        self._check_fitted()
        rng = np.random.default_rng(seed)
        mean = np.full(n, self._beta[0])
        if self._evidence:
            if evidence_values is None:
                raise ValueError(
                    f"Evidence values needed to sample "
                    f"P({self._variable} | {self._evidence})"
                )
            ev = DataFrame.wrap(evidence_values)
            mat = ev.to_numpy(self._evidence, drop_null=False, dtype=np.float64)
            if len(mat) != n:
                raise ValueError("evidence_values rows != n")
            mean = mean + mat @ self._beta[1:]
        from ..data.arrow_interop import pa

        return pa.array(mean + rng.normal(0.0, math.sqrt(self._variance), n))

    # ---------------------------------------------------------------- string
    def ToString(self) -> str:
        v = self._variable
        if self._evidence:
            ev = ", ".join(self._evidence)
            if self._fitted:
                terms = "".join(
                    f" + {b:.3f}*{e}"
                    for b, e in zip(self._beta[1:], self._evidence)
                )
                return (
                    f"[LinearGaussianCPD] P({v} | {ev}) = "
                    f"N({self._beta[0]:.3f}{terms}, {self._variance:.3f})"
                )
            return f"[LinearGaussianCPD] P({v} | {ev}) not fitted"
        if self._fitted:
            return (
                f"[LinearGaussianCPD] P({v}) = "
                f"N({self._beta[0]:.3f}, {self._variance:.3f})"
            )
        return f"[LinearGaussianCPD] P({v}) not fitted"

    # --------------------------------------------------------------- pickle
    def __getstate__(self):
        return {
            "variable": self._variable,
            "evidence": self._evidence,
            "fitted": self._fitted,
            "beta": None if self._beta is None else np.asarray(self._beta),
            "variance": self._variance,
        }

    def __setstate__(self, state):
        Factor.__init__(self, state["variable"], state["evidence"])
        self._fitted = state["fitted"]
        self._beta = state["beta"]
        self._variance = state["variance"]
