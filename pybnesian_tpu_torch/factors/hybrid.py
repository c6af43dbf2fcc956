"""Hybrid factors: mixtures of a base factor over discrete parent assignments.

Rebuild of reference factors/discrete/DiscreteAdaptator.hpp (568 LoC):
``CLinearGaussianCPD`` = DiscreteAdaptator<LinearGaussianCPD> and ``HCKDE`` =
DiscreteAdaptator<CKDE> (LinearGaussianCPD.hpp:123-140, CKDE.hpp:748-770).
As in the reference, these share their base factor's FactorType —
``LinearGaussianCPDType.new_factor`` / ``CKDEType.new_factor`` dispatch to the
adaptator when any evidence node is discrete (LinearGaussianCPD.cpp:33-59,
CKDE.cpp:15-33). Unfittable configurations (singular sub-data) are skipped
gracefully: their rows evaluate to NaN (DiscreteAdaptator.hpp fit/logl_impl).

Copied from ``pybnesian_tpu/factors/hybrid.py``.
"""

from __future__ import annotations

import math

import numpy as np

from ..data import DataFrame
from ..utils import MACHINE_TOL
from ..utils.exceptions import SingularCovarianceData
from .base import Assignment, Factor, FactorType
from .ckde import CKDE, CKDEType
from .discrete import create_cardinality_strides, flat_indices
from .lineargaussian import LinearGaussianCPD, LinearGaussianCPDType

__all__ = ["DiscreteAdaptator", "CLinearGaussianCPD", "HCKDE",
           "CLinearGaussianCPDType", "HCKDEType"]

# Aliases kept for API discoverability; the reference has no separate types
# for the adaptators (they return the base factor's type).
CLinearGaussianCPDType = LinearGaussianCPDType
HCKDEType = CKDEType


class DiscreteAdaptator(Factor):
    """Fits one base factor per discrete-parent configuration."""

    # subclasses set these
    _base_cls = None
    _name = "DiscreteAdaptator"

    def __init__(self, variable, evidence=(), *args, assignment_args=None, **kwargs):
        super().__init__(variable, evidence)
        self._args = args
        self._kwargs = kwargs
        # optional per-assignment construction args:
        # {Assignment: (args tuple)} (reference SpecificBaseFactorParameters)
        self._assignment_args = dict(assignment_args or {})
        self._fitted = False
        self._discrete_evidence: list[str] = []
        self._continuous_evidence: list[str] = []
        self._discrete_values: dict[str, tuple] = {}
        self._cardinality = None
        self._strides = None
        self._factors: list = []

    # ------------------------------------------------------------- factory
    def _make_base(self, assignment: Assignment):
        spec = self._assignment_args.get(assignment)
        if spec is not None:
            args = spec if isinstance(spec, tuple) else (spec,)
            return self._base_cls(
                self._variable, self._continuous_evidence, *args
            )
        return self._base_cls(
            self._variable, self._continuous_evidence, *self._args,
            **self._kwargs
        )

    @staticmethod
    def _base_fit_ok(factor, df) -> bool:
        """Fitter policy: False marks the configuration unusable
        (reference LinearGaussianFitter / CKDEFitter)."""
        try:
            factor.fit(df)
        except SingularCovarianceData:
            return False
        variance = getattr(factor, "variance", None)
        if variance is not None and (
            variance < MACHINE_TOL or math.isinf(variance)
        ):
            return False
        return True

    # ------------------------------------------------------------- surface
    def type(self) -> FactorType:
        raise NotImplementedError

    def fitted(self) -> bool:
        return self._fitted

    def data_type(self):
        self._check_fitted()
        for f in self._factors:
            if f is not None:
                return f.data_type()
        from ..data.arrow_interop import pa

        return pa.float64()

    def _check_fitted(self):
        if not self._fitted:
            raise ValueError(f"Factor {self.ToString()} not fitted.")

    def _assignment_from_config(self, config: int) -> Assignment:
        values = {}
        for i, e in enumerate(self._discrete_evidence):
            card = int(self._cardinality[i])
            stride = int(self._strides[i])
            code = (config // stride) % card
            values[e] = self._discrete_values[e][code]
        return Assignment(values)

    def conditional_factor(self, assignment: Assignment):
        """Base factor for a given discrete assignment
        (reference DiscreteAdaptator.hpp conditional_factor)."""
        self._check_fitted()
        if not self._discrete_evidence:
            return self._factors[0]
        config = 0
        for i, e in enumerate(self._discrete_evidence):
            value = assignment[e]
            code = self._discrete_values[e].index(value)
            config += code * int(self._strides[i])
        return self._factors[config]

    # ------------------------------------------------------------------ fit
    def fit(self, df) -> None:
        df = DataFrame.wrap(df)
        discrete, continuous = [], []
        for e in self._evidence:
            if df.is_discrete(e):
                discrete.append(e)
            elif df.is_continuous(e):
                continuous.append(e)
            else:
                raise ValueError(
                    f"Non valid data type for variable {e}."
                )
        self._discrete_evidence = discrete
        self._continuous_evidence = continuous
        self._factors = []
        self._discrete_values = {}

        if not discrete:
            factor = self._make_base(Assignment({}))
            if not self._base_fit_ok(factor, df):
                factor = None
            self._factors = [factor]
            self._cardinality = np.zeros(0, np.int64)
            self._strides = np.zeros(0, np.int64)
        else:
            card, strides = create_cardinality_strides(
                df, discrete[0], discrete[1:]
            )
            self._cardinality = card
            self._strides = strides
            for e in discrete:
                self._discrete_values[e] = df.categories(e)
            num_configs = int(np.prod(card))
            config_idx = flat_indices(df, discrete, strides)
            all_rows = np.arange(df.num_rows)
            for c in range(num_configs):
                rows = all_rows[config_idx == c]
                if len(rows) == 0:
                    self._factors.append(None)
                    continue
                assignment = self._assignment_from_config(c)
                factor = self._make_base(assignment)
                if not factor.fitted():
                    if not self._base_fit_ok(factor, df.take(rows)):
                        factor = None
                self._factors.append(factor)
        self._fitted = True

    # ----------------------------------------------------------------- logl
    def _check_domain(self, df: DataFrame):
        for e in self._discrete_evidence:
            if df.categories(e) != self._discrete_values[e]:
                raise ValueError(
                    f"Categories of column '{e}' are different from the "
                    "categories used for fitting."
                )

    def logl(self, df) -> np.ndarray:
        self._check_fitted()
        df = DataFrame.wrap(df)
        self._check_domain(df)
        if not self._discrete_evidence:
            if self._factors[0] is None:
                return np.full(df.num_rows, np.nan)
            return np.asarray(self._factors[0].logl(df))
        config_idx = flat_indices(df, self._discrete_evidence, self._strides)
        res = np.full(df.num_rows, np.nan)
        all_rows = np.arange(df.num_rows)
        live = [
            (c, all_rows[config_idx == c])
            for c in range(len(self._factors))
            if self._factors[c] is not None and np.any(config_idx == c)
        ]
        if self._base_cls is CKDE and len(live) > 1:
            # all configurations' sub-CKDEs in ONE device launch
            from .ckde import batched_ckde_logl_many

            entries = []
            valids = []
            for c, rows in live:
                f = self._factors[c]
                cols = [self._variable, *f.evidence()]
                sub = df.take(rows)
                mat = sub.to_numpy(cols, drop_null=False, dtype=np.float64)
                valids.append(sub.combined_mask(*cols))
                entries.append((f, np.nan_to_num(mat, nan=0.0)))
            outs = batched_ckde_logl_many(entries)
            for (c, rows), vals, valid in zip(live, outs, valids):
                vals = vals.copy()
                vals[~valid] = np.nan
                res[rows] = vals
            return res
        for c, rows in live:
            res[rows] = np.asarray(self._factors[c].logl(df.take(rows)))
        return res

    def slogl(self, df) -> float:
        return float(np.nansum(self.logl(df)))

    # --------------------------------------------------------------- sample
    def sample(self, n: int, evidence_values=None, seed: int | None = None):
        self._check_fitted()
        if not self._discrete_evidence:
            if self._factors[0] is None:
                from ..data.arrow_interop import pa

                return pa.array(np.full(n, np.nan))
            ev = None
            if self._continuous_evidence:
                ev = evidence_values
            return self._factors[0].sample(n, ev, seed=seed)
        ev = DataFrame.wrap(evidence_values)
        self._check_domain(ev)
        config_idx = flat_indices(ev, self._discrete_evidence, self._strides)
        out = np.full(n, np.nan)
        all_rows = np.arange(n)
        for c in range(len(self._factors)):
            rows = all_rows[config_idx == c]
            if len(rows) == 0:
                continue
            f = self._factors[c]
            if f is None:
                continue
            sub_ev = (
                ev.take(rows) if self._continuous_evidence else None
            )
            out[rows] = np.asarray(
                f.sample(len(rows), sub_ev, seed=None if seed is None else seed + c)
            )
        from ..data.arrow_interop import pa

        return pa.array(out)

    # ---------------------------------------------------------------- string
    def ToString(self) -> str:
        v = self._variable
        if self._evidence:
            ev = ", ".join(self._evidence)
            header = f"[{self._name}] P({v} | {ev})"
        else:
            header = f"[{self._name}] P({v})"
        if not self._fitted:
            return header + " not fitted."
        if self._discrete_evidence:
            # per-assignment sub-factor table
            # (reference DiscreteAdaptator.hpp:374-410, libfort char_table)
            from ..utils.tables import char_table

            varname = v
            if self._continuous_evidence:
                varname = f"{v} | " + ", ".join(self._continuous_evidence)
            rows = []
            for c, f in enumerate(self._factors):
                assignment = self._assignment_from_config(c)
                cells = [
                    str(assignment.value(e)) for e in self._discrete_evidence
                ]
                cells.append("not fitted" if f is None else f.ToString())
                rows.append(cells)
            table = char_table(
                [("", len(self._discrete_evidence)), (varname, 1)],
                list(self._discrete_evidence) + [""],
                rows,
            )
            return header + "\n" + table
        base = self._factors[0]
        # the base factor can legitimately be None when its fit failed
        # (the Fitter skip policy leaves an unfittable config unfitted)
        return header + " = " + ("not fitted" if base is None else base.ToString())

    # --------------------------------------------------------------- pickle
    def __getstate__(self):
        return {
            "variable": self._variable,
            "evidence": self._evidence,
            "args": self._args,
            "kwargs": self._kwargs,
            "assignment_args": self._assignment_args,
            "fitted": self._fitted,
            "discrete_evidence": self._discrete_evidence,
            "continuous_evidence": self._continuous_evidence,
            "discrete_values": self._discrete_values,
            "cardinality": self._cardinality,
            "strides": self._strides,
            "factors": self._factors,
        }

    def __setstate__(self, state):
        Factor.__init__(self, state["variable"], state["evidence"])
        self._args = state["args"]
        self._kwargs = state["kwargs"]
        self._assignment_args = state["assignment_args"]
        self._fitted = state["fitted"]
        self._discrete_evidence = state["discrete_evidence"]
        self._continuous_evidence = state["continuous_evidence"]
        self._discrete_values = state["discrete_values"]
        self._cardinality = state["cardinality"]
        self._strides = state["strides"]
        self._factors = state["factors"]


class CLinearGaussianCPD(DiscreteAdaptator):
    """Conditional linear Gaussian: one LinearGaussianCPD per discrete parent
    configuration (reference LinearGaussianCPD.hpp:140)."""

    _base_cls = LinearGaussianCPD
    _name = "CLinearGaussianCPD"

    def type(self) -> FactorType:
        return LinearGaussianCPDType()


class HCKDE(DiscreteAdaptator):
    """Hybrid semiparametric factor: one CKDE per discrete parent
    configuration (reference CKDE.hpp:770)."""

    _base_cls = CKDE
    _name = "HCKDE"

    def type(self) -> FactorType:
        return CKDEType()
