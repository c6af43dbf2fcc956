"""DiscreteFactor: conditional probability table over categorical data.

Rebuild of reference factors/discrete/DiscreteFactor.{hpp,cpp} (535 LoC) and
factors/discrete/discrete_indices.{hpp,cpp}. The CPT is stored as a flat
log-probability vector indexed by strides (variable stride 1, then parents in
order), exactly the reference layout; unseen parent configurations fall back
to the log-uniform distribution (mle_DiscreteFactor.cpp:28-33).
"""

from __future__ import annotations

import numpy as np

from ..data import DataFrame
from .base import Factor, FactorType

__all__ = [
    "DiscreteFactorType",
    "DiscreteFactor",
    "create_cardinality_strides",
    "joint_counts",
    "mle_discrete",
    "DiscreteParams",
]


class DiscreteFactorType(FactorType):
    def new_factor(self, model, variable, evidence, *args, **kwargs):
        return DiscreteFactor(variable, evidence)

    def ToString(self) -> str:
        return "DiscreteFactor"


def create_cardinality_strides(df: DataFrame, variable, evidence):
    """(cardinality, strides) vectors over [variable, *evidence]
    (reference discrete_indices.hpp)."""
    vars_ = [variable, *evidence]
    card = np.array([df.cardinality(v) for v in vars_], dtype=np.int64)
    strides = np.ones(len(vars_), dtype=np.int64)
    for i in range(1, len(vars_)):
        strides[i] = strides[i - 1] * card[i - 1]
    return card, strides


def flat_indices(df: DataFrame, variables, strides):
    """Per-row flat configuration index; -1 where any column is null."""
    codes = np.stack([df.codes(v).astype(np.int64) for v in variables], axis=1)
    valid = (codes >= 0).all(axis=1)
    idx = (codes * strides[None, :]).sum(axis=1)
    idx[~valid] = -1
    return idx


def joint_counts(df: DataFrame, variable, evidence, cardinality, strides):
    """Counts over the full joint configuration space, nulls dropped
    (reference discrete_indices.cpp joint_counts)."""
    num_configs = int(np.prod(cardinality))
    idx = flat_indices(df, [variable, *evidence], strides)
    idx = idx[idx >= 0]
    return np.bincount(idx, minlength=num_configs).astype(np.int64)


class HostJointCounter:
    """Per-column int64 code cache for repeated contingency counting.

    Hill-climbing rescoring calls joint_counts hundreds of times on the
    same DataFrame; extracting + widening the category codes dominates the
    count itself (the bincount over 10k rows is ~10µs). Caching the widened
    codes and per-column null masks makes each family count a handful of
    fused multiply-adds + one bincount."""

    def __init__(self, df: DataFrame):
        self.df = df
        self._cols: dict[str, tuple[np.ndarray, bool]] = {}

    def _col(self, name: str):
        entry = self._cols.get(name)
        if entry is None:
            codes = self.df.codes(name).astype(np.int64)
            entry = (codes, bool((codes < 0).any()))
            self._cols[name] = entry
        return entry

    def counts(self, variable, evidence, cardinality, strides) -> np.ndarray:
        codes, any_null = self._col(variable)
        idx = codes * strides[0]
        valid = (codes >= 0) if any_null else None
        for v, s in zip(evidence, strides[1:]):
            c, has_null = self._col(v)
            idx += c * s
            if has_null:
                valid = (c >= 0) if valid is None else (valid & (c >= 0))
                any_null = True
        if any_null:
            idx = idx[valid]
        num_configs = int(np.prod(cardinality))
        return np.bincount(idx, minlength=num_configs)


class DiscreteParams:
    def __init__(self, logprob, cardinality):
        self.logprob = logprob
        self.cardinality = cardinality


def mle_discrete(df, variable, evidence) -> DiscreteParams:
    """ML CPT estimation (reference mle_DiscreteFactor.cpp:5-42)."""
    df = DataFrame.wrap(df)
    card, strides = create_cardinality_strides(df, variable, evidence)
    counts = joint_counts(df, variable, evidence, card, strides)
    k = int(card[0])
    num_parent_configs = int(np.prod(card[1:])) if len(card) > 1 else 1
    counts2 = counts.reshape(num_parent_configs, k)
    totals = counts2.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        logprob = np.log(counts2) - np.log(totals)
    uniform = -np.log(k)
    logprob[np.repeat(totals[:, 0] == 0, k).reshape(num_parent_configs, k)] = (
        uniform
    )
    return DiscreteParams(logprob.reshape(-1), card)


class DiscreteFactor(Factor):
    def __init__(self, variable, evidence=()):
        super().__init__(variable, evidence)
        self._fitted = False
        self._logprob = None
        self._cardinality = None
        self._strides = None
        self._categories: dict[str, tuple] | None = None

    def type(self) -> FactorType:
        return DiscreteFactorType()

    def fitted(self) -> bool:
        return self._fitted

    def data_type(self):
        """Dictionary type with the smallest index width for the fitted
        cardinality (reference DiscreteFactor.hpp:77-88)."""
        if not self._fitted:
            raise ValueError("DiscreteFactor factor not fitted.")
        from ..data.arrow_interop import dictionary_type

        return dictionary_type(int(self._cardinality[0]))

    def logprob(self) -> np.ndarray:
        return self._logprob

    def cardinality(self) -> np.ndarray:
        return self._cardinality

    def category_counts(self) -> dict:
        return dict(self._categories) if self._categories else {}

    # ------------------------------------------------------------------ fit
    def fit(self, df) -> None:
        df = DataFrame.wrap(df)
        vars_ = [self._variable, *self._evidence]
        for v in vars_:
            if not df.is_discrete(v):
                raise ValueError(
                    f"Wrong data type to fit DiscreteFactor. Column '{v}' is "
                    "not categorical."
                )
        params = mle_discrete(df, self._variable, self._evidence)
        self._logprob = params.logprob
        self._cardinality = params.cardinality
        self._strides = np.ones(len(vars_), dtype=np.int64)
        for i in range(1, len(vars_)):
            self._strides[i] = self._strides[i - 1] * self._cardinality[i - 1]
        self._categories = {v: df.categories(v) for v in vars_}
        self._fitted = True

    def _check_fitted(self):
        if not self._fitted:
            raise ValueError(
                f"Factor P({self._variable} | {self._evidence}) not fitted."
            )

    def _check_domain(self, df: DataFrame):
        """Fitted categories must match the data's categories exactly
        (reference DiscreteFactor.hpp:122-126)."""
        for v, cats in self._categories.items():
            if df.categories(v) != cats:
                raise ValueError(
                    f"Categories of column '{v}' are different from the "
                    "categories used for fitting."
                )

    # ----------------------------------------------------------------- logl
    def logl(self, df) -> np.ndarray:
        self._check_fitted()
        df = DataFrame.wrap(df)
        self._check_domain(df)
        idx = flat_indices(df, [self._variable, *self._evidence], self._strides)
        out = np.full(len(idx), np.nan)
        valid = idx >= 0
        out[valid] = self._logprob[idx[valid]]
        return out

    def slogl(self, df) -> float:
        return float(np.nansum(self.logl(df)))

    # --------------------------------------------------------------- sample
    def sample(self, n: int, evidence_values=None, seed: int | None = None):
        """Inverse-CDF per parent configuration
        (reference DiscreteFactor.hpp:144-207). Returns integer codes plus the
        category labels via :meth:`variable_categories`."""
        self._check_fitted()
        rng = np.random.default_rng(seed)
        k = int(self._cardinality[0])
        prob = np.exp(self._logprob).reshape(-1, k)
        if self._evidence:
            if evidence_values is None:
                raise ValueError(
                    f"Evidence values needed to sample "
                    f"P({self._variable} | {self._evidence})"
                )
            ev = DataFrame.wrap(evidence_values)
            self._check_domain_evidence(ev)
            codes = np.stack(
                [ev.codes(v).astype(np.int64) for v in self._evidence], axis=1
            )
            pstrides = self._strides[1:] // k
            config = (codes * pstrides[None, :]).sum(axis=1)
            p = prob[config]
        else:
            p = np.broadcast_to(prob[0], (n, k))
        cdf = np.cumsum(p, axis=1)
        u = rng.random(n)[:, None]
        draws = (u > cdf).sum(axis=1).astype(np.int32)
        draws = np.minimum(draws, k - 1)
        from ..data.arrow_interop import column_to_pa
        from ..data.dataframe import Column

        return column_to_pa(
            Column(self._variable, draws, self._categories[self._variable])
        )

    def _check_domain_evidence(self, df: DataFrame):
        for v in self._evidence:
            if df.categories(v) != self._categories[v]:
                raise ValueError(
                    f"Categories of column '{v}' are different from the "
                    "categories used for fitting."
                )

    def variable_categories(self) -> tuple:
        self._check_fitted()
        return self._categories[self._variable]

    # ---------------------------------------------------------------- string
    def ToString(self) -> str:
        """Header plus a CPT table when fitted (the reference renders libfort
        tables, DiscreteAdaptator.hpp includes <fort.hpp>)."""
        v = self._variable
        if self._evidence:
            ev = ", ".join(self._evidence)
            header = f"[DiscreteFactor] P({v} | {ev})"
        else:
            header = f"[DiscreteFactor] P({v})"
        if not self._fitted:
            return header + " not fitted."
        from ..utils.tables import char_table

        cats = self._categories[self._variable]
        k = len(cats)
        prob = np.exp(self._logprob).reshape(-1, k)
        if self._evidence:
            ev_cards = [len(self._categories[e]) for e in self._evidence]
            rows = []
            for cfg in range(prob.shape[0]):
                rem = cfg
                assignment = []
                for e, card in zip(self._evidence, ev_cards):
                    assignment.append(str(self._categories[e][rem % card]))
                    rem //= card
                rows.append(assignment + [f"{p:.3g}" for p in prob[cfg]])
            table = char_table(
                [("", len(self._evidence)), (v, k)],
                list(self._evidence) + [str(c) for c in cats],
                rows,
            )
        else:
            table = char_table(
                [(v, k)],
                [str(c) for c in cats],
                [[f"{p:.3g}" for p in prob[0]]],
            )
        return header + "\n" + table

    # --------------------------------------------------------------- pickle
    def __getstate__(self):
        return {
            "variable": self._variable,
            "evidence": self._evidence,
            "fitted": self._fitted,
            "logprob": self._logprob,
            "cardinality": self._cardinality,
            "strides": self._strides,
            "categories": self._categories,
        }

    def __setstate__(self, state):
        Factor.__init__(self, state["variable"], state["evidence"])
        self._fitted = state["fitted"]
        self._logprob = state["logprob"]
        self._cardinality = state["cardinality"]
        self._strides = state["strides"]
        self._categories = state["categories"]
