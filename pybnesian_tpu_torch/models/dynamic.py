"""Dynamic Bayesian networks: static BN over past slices + conditional
transition BN.

Rebuild of reference models/DynamicBayesianNetwork.{hpp,cpp} (669 LoC):
the static BN covers variables ``v_t_1..v_t_m``; the transition BN is a
conditional BN with nodes ``v_t_0`` given interface ``v_t_1..v_t_m``; both
share one BayesianNetworkType. logl routes the first ``m`` rows to the static
BN (one instance built from them) and the rest through the transition BN's
shifted windows (DynamicBayesianNetwork.cpp:71-150); sampling seeds ``m``
rows from the static BN then rolls the transition model forward.

Copied from ``pybnesian_tpu/models/dynamic.py``.
"""

from __future__ import annotations

import numpy as np

from ..data import DataFrame
from ..data.dynamic import (
    DynamicDataFrame,
    create_static_df,
    create_temporal_slices,
    create_transition_df,
)
from ..utils import temporal_name, temporal_names
from .base import BayesianNetworkType, ConditionalBayesianNetwork
from .networks import (
    CLGNetworkType,
    DiscreteBNType,
    GaussianNetworkType,
    HeterogeneousBNType,
    HomogeneousBNType,
    KDENetworkType,
    SemiparametricBNType,
)

__all__ = [
    "DynamicBayesianNetwork",
    "DynamicGaussianNetwork",
    "DynamicDiscreteBN",
    "DynamicKDENetwork",
    "DynamicSemiparametricBN",
    "DynamicCLGNetwork",
    "DynamicHomogeneousBN",
    "DynamicHeterogeneousBN",
]


class DynamicBayesianNetwork:
    def __init__(self, type_or_variables, variables_or_order=None,
                 markovian_order=None, static_bn=None, transition_bn=None):
        # Reference ctors (DynamicBayesianNetwork.hpp:43-100):
        # (type, variables, markovian_order) or
        # (variables, markovian_order, static_bn, transition_bn).
        if isinstance(type_or_variables, BayesianNetworkType):
            bn_type = type_or_variables
            variables = list(variables_or_order)
            m = int(markovian_order)
        else:
            variables = list(type_or_variables)
            m = int(variables_or_order)
            if transition_bn is None and markovian_order is not None:
                # 4-positional form shifts the networks into later slots.
                static_bn, transition_bn = markovian_order, static_bn
            if static_bn is None or transition_bn is None:
                raise ValueError(
                    "Either a BayesianNetworkType or explicit static and "
                    "transition networks are required"
                )
            bn_type = None
        if static_bn is not None and transition_bn is not None:
            if static_bn.type() != transition_bn.type():
                raise ValueError(
                    "Static and transition Bayesian networks do not have "
                    "the same type."
                )
            bn_type = transition_bn.type()
        self._variables = variables
        self._markovian_order = m
        self._type = bn_type
        if static_bn is not None:
            self._static = static_bn
        else:
            self._static = bn_type.new_bn(temporal_names(variables, 1, m))
        if transition_bn is not None:
            self._transition = transition_bn
        else:
            self._transition = bn_type.new_cbn(
                temporal_names(variables, 0, 0), temporal_names(variables, 1, m)
            )
        if not isinstance(self._transition, ConditionalBayesianNetwork):
            raise ValueError("transition_bn must be a conditional BN")
        for v in variables:
            present = temporal_name(v, 0)
            if not self._transition.contains_node(present):
                raise ValueError(
                    f"Node {present} not present in transition "
                    "BayesianNetwork."
                )
            for i in range(1, m + 1):
                name = temporal_name(v, i)
                if not self._static.contains_node(name):
                    raise ValueError(
                        f"Node {name} not present in static BayesianNetwork."
                    )
                if not self._transition.contains_interface_node(name):
                    raise ValueError(
                        f"Interface node {name} not present in transition "
                        "BayesianNetwork."
                    )

    # ------------------------------------------------------------- surface
    def type(self) -> BayesianNetworkType:
        return self._type

    def variables(self) -> list[str]:
        return list(self._variables)

    def markovian_order(self) -> int:
        return self._markovian_order

    def num_variables(self) -> int:
        return len(self._variables)

    def contains_variable(self, name: str) -> bool:
        return name in self._variables

    def add_variable(self, name: str) -> None:
        """Add a variable: node in the transition slice 0 plus one node per
        past slice in static/interface (reference
        DynamicBayesianNetwork.cpp:37-52)."""
        if self.contains_variable(name):
            raise ValueError(
                f"Cannot add variable {name}: a variable with the same name "
                "already exists."
            )
        self._variables.append(name)
        self._transition.add_node(temporal_name(name, 0))
        for i in range(1, self._markovian_order + 1):
            slice_name = temporal_name(name, i)
            self._static.add_node(slice_name)
            self._transition.add_interface_node(slice_name)

    def remove_variable(self, name: str) -> None:
        """(reference DynamicBayesianNetwork.cpp:54-68)."""
        if not self.contains_variable(name):
            raise ValueError(
                f"Cannot remove variable {name}: no variable with that name."
            )
        self._variables.remove(name)
        self._transition.remove_node(temporal_name(name, 0))
        for i in range(1, self._markovian_order + 1):
            slice_name = temporal_name(name, i)
            self._static.remove_node(slice_name)
            self._transition.remove_interface_node(slice_name)

    def static_bn(self):
        return self._static

    def transition_bn(self):
        return self._transition

    @property
    def include_cpd(self) -> bool:
        """Whether pickling includes fitted CPDs
        (reference pybindings_models.cpp:2662)."""
        return bool(getattr(self._static, "include_cpd", False))

    @include_cpd.setter
    def include_cpd(self, value: bool) -> None:
        self._static.include_cpd = bool(value)
        self._transition.include_cpd = bool(value)

    def clone(self) -> "DynamicBayesianNetwork":
        new = DynamicBayesianNetwork.__new__(DynamicBayesianNetwork)
        new._variables = list(self._variables)
        new._markovian_order = self._markovian_order
        new._type = self._type
        new._static = self._static.clone()
        new._transition = self._transition.clone()
        return new

    def fitted(self) -> bool:
        return self._static.fitted() and self._transition.fitted()

    def _check_fitted(self):
        if not self.fitted():
            raise ValueError("DynamicBayesianNetwork not fitted.")

    # ------------------------------------------------------------------ fit
    def fit(self, df, construction_args=None) -> None:
        ddf = df if isinstance(df, DynamicDataFrame) else DynamicDataFrame(
            df, self._markovian_order
        )
        self._static.fit(ddf.static_df(), construction_args)
        self._transition.fit(ddf.transition_df(), construction_args)

    # ------------------------------------------------------------ likelihood
    def logl(self, df) -> np.ndarray:
        """(reference DynamicBayesianNetwork.cpp:71-113)."""
        self._check_fitted()
        df = DataFrame.wrap(df)
        m = self._markovian_order
        if df.num_rows < m:
            raise ValueError(
                f"Not enough information. There are less rows in test "
                f"DataFrame ({df.num_rows}) than the markovian order of the "
                f"DynamicBayesianNetwork ({m})"
            )
        ll = np.zeros(df.num_rows)
        head = df.take(np.arange(m))
        dstatic = create_static_df(head, m)
        for i in range(m):
            for v in self._variables:
                cpd = self._static.cpd(temporal_name(v, m - i))
                ll[i] += cpd.slogl(dstatic)
        slices = create_temporal_slices(df, m)
        dtransition = create_transition_df(slices)
        for v in self._variables:
            cpd = self._transition.cpd(temporal_name(v, 0))
            vll = np.asarray(cpd.logl(dtransition))
            ll[m:] += vll
        return ll

    def slogl(self, df) -> float:
        return float(np.nansum(self.logl(df)))

    # ---------------------------------------------------------------- sample
    def sample(self, n: int, seed: int | None = None) -> DataFrame:
        """Static BN seeds the first m rows; the transition model rolls
        forward one row at a time (reference DynamicBayesianNetwork.cpp)."""
        self._check_fitted()
        m = self._markovian_order
        if n < m:
            raise ValueError("n must be at least the markovian order")
        static_sample = self._static.sample(1, seed=seed).to_pandas()
        import pandas as pd

        series = {v: [] for v in self._variables}
        for i in range(m):
            # row i corresponds to slice m - i
            for v in self._variables:
                series[v].append(static_sample[temporal_name(v, m - i)].iloc[0])
        base_seed = 0 if seed is None else seed
        for t in range(m, n):
            # build a single-row evidence frame with slices 1..m
            ev_data = {}
            for s in range(1, m + 1):
                for v in self._variables:
                    val = series[v][t - s]
                    ev_data[temporal_name(v, s)] = self._as_column(v, [val])
            ev = DataFrame.wrap(ev_data)
            row = self._transition.sample(
                1, evidence=ev, seed=base_seed + t
            ).to_pandas()
            for v in self._variables:
                series[v].append(row[temporal_name(v, 0)].iloc[0])
        out = {}
        for v in self._variables:
            col = self._static.cpd(temporal_name(v, 1))
            out[v] = self._to_series(v, series[v])
        return DataFrame.wrap(out)

    def _as_column(self, variable, values):
        cats = self._categories(variable)
        if cats is not None:
            import pandas as pd

            return pd.Categorical(values, categories=list(cats))
        return np.asarray(values, dtype=np.float64)

    def _to_series(self, variable, values):
        return self._as_column(variable, values)

    def _categories(self, variable):
        from ..factors.discrete import DiscreteFactor

        name = temporal_name(variable, 0)
        try:
            cpd = self._transition.cpd(name)
        except ValueError:
            return None
        if isinstance(cpd, DiscreteFactor):
            return cpd.variable_categories()
        return None

    # ---------------------------------------------------------------- string
    def ToString(self) -> str:
        return (
            f"DynamicBayesianNetwork [{self._type.ToString()}] "
            f"({len(self._variables)} variables, markovian_order="
            f"{self._markovian_order})"
        )

    def __str__(self) -> str:
        return self.ToString()

    def __repr__(self) -> str:
        return self.ToString()

    # --------------------------------------------------------------- pickle
    def save(self, filename: str, include_cpd: bool = False) -> None:
        from ..utils.pickle import save_object

        prev_s = getattr(self._static, "include_cpd", False)
        prev_t = getattr(self._transition, "include_cpd", False)
        self._static.include_cpd = include_cpd
        self._transition.include_cpd = include_cpd
        try:
            save_object(self, filename)
        finally:
            self._static.include_cpd = prev_s
            self._transition.include_cpd = prev_t

    def __getstate__(self):
        state = {
            "variables": self._variables,
            "markovian_order": self._markovian_order,
            "type": self._type,
            "static": self._static,
            "transition": self._transition,
        }
        extra = getattr(self, "__getstate_extra__", None)
        if callable(extra):
            state["extra"] = extra()
        return state

    def __setstate__(self, state):
        self._variables = state["variables"]
        self._markovian_order = state["markovian_order"]
        self._type = state["type"]
        self._static = state["static"]
        self._transition = state["transition"]
        if "extra" in state:
            setter = getattr(self, "__setstate_extra__", None)
            if callable(setter):
                setter(state["extra"])


def _dynamic_wrapper(name, type_factory, type_err):
    class _Dynamic(DynamicBayesianNetwork):
        def __init__(self, variables, markovian_order,
                     static_bn=None, transition_bn=None):
            if static_bn is not None or transition_bn is not None:
                super().__init__(
                    variables, markovian_order, static_bn, transition_bn
                )
                if self._type != type_factory():
                    raise ValueError(type_err)
            else:
                super().__init__(type_factory(), variables, markovian_order)

    _Dynamic.__name__ = name
    _Dynamic.__qualname__ = name
    return _Dynamic


DynamicGaussianNetwork = _dynamic_wrapper(
    "DynamicGaussianNetwork", GaussianNetworkType,
    "Bayesian networks are not Gaussian."
)
DynamicDiscreteBN = _dynamic_wrapper(
    "DynamicDiscreteBN", DiscreteBNType, "Bayesian networks are not discrete."
)
DynamicKDENetwork = _dynamic_wrapper(
    "DynamicKDENetwork", KDENetworkType,
    "Bayesian networks are not KDE networks."
)
DynamicSemiparametricBN = _dynamic_wrapper(
    "DynamicSemiparametricBN", SemiparametricBNType,
    "Bayesian networks are not semiparametric."
)
DynamicCLGNetwork = _dynamic_wrapper(
    "DynamicCLGNetwork", CLGNetworkType, "Bayesian networks are not Gaussian."
)


class DynamicHomogeneousBN(DynamicBayesianNetwork):
    def __init__(self, factor_type, variables=None, markovian_order=None,
                 static_bn=None, transition_bn=None):
        from ..factors.base import FactorType

        if isinstance(factor_type, FactorType):
            super().__init__(
                HomogeneousBNType(factor_type), variables, markovian_order
            )
        else:
            # (variables, markovian_order, static_bn, transition_bn)
            super().__init__(
                factor_type, variables, markovian_order, static_bn
            )
            if not isinstance(self._type, HomogeneousBNType):
                raise ValueError("Bayesian networks are not HomogeneousBNType.")


class DynamicHeterogeneousBN(DynamicBayesianNetwork):
    def __init__(self, default_factor_types, variables=None,
                 markovian_order=None, static_bn=None, transition_bn=None):
        from ..factors.base import FactorType

        spec = default_factor_types
        is_spec = isinstance(spec, (dict, FactorType)) or (
            isinstance(spec, (list, tuple))
            and spec
            and isinstance(spec[0], FactorType)
        )
        if is_spec:
            super().__init__(
                HeterogeneousBNType(spec), variables, markovian_order
            )
        else:
            # (variables, markovian_order, static_bn, transition_bn)
            super().__init__(spec, variables, markovian_order, static_bn)
            if not isinstance(self._type, HeterogeneousBNType):
                raise ValueError(
                    "Bayesian networks are not HeterogeneousBNType."
                )
