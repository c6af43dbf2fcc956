"""Multivariate Gaussian KDE models.

Rebuild of reference kde/KDE.{hpp,cpp} (~900 LoC) and
kde/ProductKDE.{hpp,cpp}. Fit and whitening run on the host in float64
(scipy's triangular solve); the whitened rows then go to the device in the
data's dtype, where :func:`pybnesian_tpu_torch.ops.kde.kde_logl_whitened`
evaluates the pairwise logsumexp (the KDE kernel for float32 on a GPU).
"""

from __future__ import annotations

import math

import numpy as np

from ..data import DataFrame
from ..runtime.device import host_to_device
from ..utils.exceptions import SingularCovarianceData
from .bandwidth import BandwidthSelector, NormalReferenceRule

__all__ = ["KDE", "ProductKDE"]

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
        self._train_white = None  # device cache

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
        self._train_white = None
        self._fitted = True

    def _check_fitted(self):
        if not self._fitted:
            raise ValueError(f"KDE({self._variables}) not fitted.")

    def _check_fitted_msg(self, msg: str):
        if not self._fitted:
            raise ValueError(msg)

    # ------------------------------------------------------------ whitening
    def _whiten(self, mat: np.ndarray) -> np.ndarray:
        from scipy.linalg import solve_triangular

        return solve_triangular(self._chol, mat.T, lower=True).T

    def _to_device(self, mat: np.ndarray):
        """Whitened host rows as a tensor in the data's dtype on the
        policy's device."""
        return host_to_device(mat, self._dtype)

    def whitened_training(self):
        """Whitened training points as a tensor (cached): whitened on the
        host in float64, then cast to the data's dtype on the policy's
        device — float32 data on a GPU thereby takes the KDE kernel."""
        if self._train_white is None:
            self._train_white = self._to_device(self._whiten(self._training))
        return self._train_white

    # ----------------------------------------------------------------- logl
    def logl(self, df) -> np.ndarray:
        self._check_fitted()
        from ..ops.kde import kde_logl_whitened

        df = DataFrame.wrap(df)
        self._check_test_dtype(df)
        mat = df.to_numpy(self._variables, drop_null=False, dtype=np.float64)
        valid = df.combined_mask(*self._variables)
        test_white = self._to_device(self._whiten(np.nan_to_num(mat, nan=0.0)))
        out = kde_logl_whitened(self.whitened_training(), test_white,
                                float(self._lognorm))
        out = out.cpu().numpy().astype(np.float64)
        out[~valid] = np.nan
        return out

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
        self._train_white = None
        if state["fitted"] and self._training is not None:
            self._finish_fit()


class ProductKDE:
    """Diagonal-bandwidth KDE: product of 1-D Gaussian kernels
    (reference kde/ProductKDE.hpp:14-90). Equivalent to a full KDE with
    diagonal H, so it rides :class:`KDE`'s logl."""

    def __init__(self, variables, bandwidth_selector: BandwidthSelector | None = None):
        self._variables = list(variables)
        if not self._variables:
            raise ValueError("Cannot create a ProductKDE model with 0 variables")
        self._bselector = bandwidth_selector or NormalReferenceRule()
        self._kde: KDE | None = None
        self._diag = None
        self._fitted = False
        self._dtype = np.float64

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
        if not self._fitted:
            raise ValueError("ProductKDE factor not fitted.")
        from ..data.arrow_interop import np_to_pa_type

        return np_to_pa_type(self._dtype)

    def num_instances(self) -> int:
        return self._kde.num_instances()

    def dataset(self) -> DataFrame:
        return self._kde.dataset()

    @property
    def bandwidth(self) -> np.ndarray:
        return self._diag

    @bandwidth.setter
    def bandwidth(self, value):
        value = np.asarray(value, dtype=np.float64).ravel()
        if len(value) != len(self._variables):
            raise ValueError(
                f"Bandwidth vector must have {len(self._variables)} entries"
            )
        self._diag = value
        if self._kde is not None:
            self._kde.bandwidth = np.diag(value)

    def fit(self, df) -> None:
        df = DataFrame.wrap(df)
        dt = df.same_type(*self._variables)
        self._dtype = np.dtype(dt) if dt != "categorical" else np.float64
        self._diag = np.asarray(
            self._bselector.diag_bandwidth(df, self._variables),
            dtype=np.float64,
        )
        self._kde = KDE(self._variables, self._bselector)
        mat = df.to_numpy(self._variables, drop_null=True, dtype=np.float64)
        self._kde._dtype = self._dtype
        self._kde.fit_with_bandwidth(mat, np.diag(self._diag))
        self._fitted = True

    def logl(self, df) -> np.ndarray:
        if not self._fitted:
            raise ValueError(f"ProductKDE({self._variables}) not fitted.")
        return self._kde.logl(df)

    def slogl(self, df) -> float:
        return float(np.nansum(self.logl(df)))

    def ToString(self) -> str:
        return f"ProductKDE({self._variables})"

    def __getstate__(self):
        return {
            "variables": self._variables,
            "bselector": self._bselector,
            "fitted": self._fitted,
            "diag": self._diag,
            "kde": self._kde,
            "dtype": np.dtype(self._dtype).name,
        }

    def __setstate__(self, state):
        self._variables = state["variables"]
        self._bselector = state["bselector"]
        self._fitted = state["fitted"]
        self._diag = state["diag"]
        self._kde = state["kde"]
        self._dtype = np.dtype(state["dtype"])

