"""Multivariate Gaussian KDE models.

Rebuild of reference kde/KDE.{hpp,cpp} (~900 LoC).
Torch port, class surface only: construction, host ``fit`` and the
bandwidth. ``logl`` / ``whitened_training`` raise ``NotImplementedError``
until ROADMAP.md Queue 1 item 6 ports them.
"""

from __future__ import annotations

import math

import numpy as np

from ..data import DataFrame
from ..utils.exceptions import SingularCovarianceData
from .bandwidth import BandwidthSelector, NormalReferenceRule

__all__ = ["KDE"]

_LOG_2PI = math.log(2 * math.pi)


class KDE:
    """Full-bandwidth Gaussian KDE (reference kde/KDE.hpp:292)."""

    def __init__(self, variables, bandwidth_selector: BandwidthSelector | None = None):
        self._variables = list(variables)
        if not self._variables:
            raise ValueError("Cannot create a KDE model with 0 variables")
        self._bselector = bandwidth_selector or NormalReferenceRule()
        self._fitted = False
        self._bandwidth = None
        self._training = None  # host (N, d) float
        self._dtype = np.float64
        self._chol = None
        self._lognorm = None

    # ------------------------------------------------------------- surface
    def variables(self) -> list[str]:
        return list(self._variables)

    def num_variables(self) -> int:
        """Number of variables modelled (reference pybindings_kde.cpp:250)."""
        return len(self._variables)

    def save(self, filename: str) -> None:
        from ..utils.pickle import save_object

        save_object(self, filename)

    def fitted(self) -> bool:
        return self._fitted

    def data_type(self):
        """pyarrow DataType of the training data (reference KDE.hpp:292;
        raises when unfitted, matching kde/KDE.cpp)."""
        self._check_fitted_msg("KDE factor not fitted.")
        from ..data.arrow_interop import np_to_pa_type

        return np_to_pa_type(self._dtype)

    def num_instances(self) -> int:
        self._check_fitted()
        return len(self._training)

    def dataset(self) -> DataFrame:
        """Training data as a DataFrame (reference KDE.hpp:642-666 reads the
        device buffer back; here the host copy is authoritative)."""
        self._check_fitted()
        from .. import data as _data

        return DataFrame(
            [
                _data.Column(v, self._training[:, i].astype(self._dtype))
                for i, v in enumerate(self._variables)
            ]
        )

    def _check_test_dtype(self, df: DataFrame) -> None:
        """Reference raises when fit/test dtypes differ (dataset.hpp:878-905
        via CKDE.cpp: 'Data type of training and test datasets is
        different.')."""
        dt = df.same_type(*self._variables)
        if dt == "categorical" or np.dtype(dt) != np.dtype(self._dtype):
            raise ValueError("Data type of training and test datasets is different.")

    @property
    def bandwidth(self) -> np.ndarray:
        return self._bandwidth

    @bandwidth.setter
    def bandwidth(self, value):
        value = np.asarray(value, dtype=np.float64)
        d = len(self._variables)
        if value.shape != (d, d):
            raise ValueError(
                f"Bandwidth matrix must have shape ({d}, {d})"
            )
        self._bandwidth = value
        if self._training is not None:
            self._finish_fit()

    # ----------------------------------------------------------------- fit
    def fit(self, df) -> None:
        df = DataFrame.wrap(df)
        dt = df.same_type(*self._variables)
        self._dtype = np.dtype(dt) if dt != "categorical" else np.float64
        mat = df.to_numpy(self._variables, drop_null=True, dtype=np.float64)
        d = len(self._variables)
        if len(mat) <= d:
            raise SingularCovarianceData(
                f"KDE of {d} variables cannot be fitted with {len(mat)} "
                "instances"
            )
        self._bandwidth = np.asarray(
            self._bselector.bandwidth(df, self._variables), dtype=np.float64
        )
        self._training = mat
        self._finish_fit()

    def fit_with_bandwidth(self, training: np.ndarray, bandwidth: np.ndarray) -> None:
        """Direct fit from a matrix + bandwidth (used by CKDE to share the
        joint's training block, reference CKDE.hpp:182-200)."""
        self._training = np.asarray(training, dtype=np.float64)
        self._bandwidth = np.asarray(bandwidth, dtype=np.float64)
        self._finish_fit()

    def _finish_fit(self) -> None:
        try:
            self._chol = np.linalg.cholesky(self._bandwidth)
        except np.linalg.LinAlgError as exc:
            raise SingularCovarianceData(
                f"Bandwidth matrix for variables {self._variables} is not "
                "positive-definite."
            ) from exc
        n, d = self._training.shape
        self._lognorm = (
            -np.sum(np.log(np.diag(self._chol)))
            - 0.5 * d * _LOG_2PI
            - math.log(n)
        )
        self._fitted = True

    def _check_fitted(self):
        if not self._fitted:
            raise ValueError(f"KDE({self._variables}) not fitted.")

    def _check_fitted_msg(self, msg: str):
        if not self._fitted:
            raise ValueError(msg)

    # ------------------------------------------------------------ whitening
    def whitened_training(self):
        raise NotImplementedError(
            "KDE.whitened_training is not ported to torch yet (ROADMAP.md "
            "Queue 1 item 6: model-level KDE/CKDE likelihood and sampling)"
        )

    # ----------------------------------------------------------------- logl
    def logl(self, df) -> np.ndarray:
        raise NotImplementedError(
            "KDE.logl is not ported to torch yet (ROADMAP.md Queue 1 item 6: "
            "model-level KDE/CKDE likelihood and sampling)"
        )

    def slogl(self, df) -> float:
        return float(np.nansum(self.logl(df)))

    def ToString(self) -> str:
        return f"KDE({self._variables})"

    def __str__(self) -> str:
        return self.ToString()

    # --------------------------------------------------------------- pickle
    def __getstate__(self):
        return {
            "variables": self._variables,
            "bselector": self._bselector,
            "fitted": self._fitted,
            "bandwidth": self._bandwidth,
            "training": self._training,
            "dtype": np.dtype(self._dtype).name,
        }

    def __setstate__(self, state):
        self._variables = state["variables"]
        self._bselector = state["bselector"]
        self._fitted = False
        self._bandwidth = state["bandwidth"]
        self._training = state["training"]
        self._dtype = np.dtype(state["dtype"])
        self._chol = None
        self._lognorm = None
        if state["fitted"] and self._training is not None:
            self._finish_fit()

