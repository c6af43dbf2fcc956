"""Concrete Bayesian-network families.

Rebuild of reference models/{GaussianNetwork,DiscreteBN,KDENetwork,
SemiparametricBN,CLGNetwork,HomogeneousBN,HeterogeneousBN}.hpp. Each family is
a ``BayesianNetworkType`` policy singleton plus thin BN / conditional-BN
class wrappers.
"""

from __future__ import annotations

import numpy as np

from ..data import DataFrame
from ..factors.base import FactorType, UnknownFactorType
from ..factors.discrete import DiscreteFactorType
from ..factors.lineargaussian import LinearGaussianCPDType
from .base import (
    BayesianNetwork,
    BayesianNetworkBase,
    BayesianNetworkType,
    ConditionalBayesianNetwork,
)

__all__ = [
    "GaussianNetworkType",
    "GaussianNetwork",
    "ConditionalGaussianNetwork",
    "DiscreteBNType",
    "DiscreteBN",
    "ConditionalDiscreteBN",
    "KDENetworkType",
    "KDENetwork",
    "ConditionalKDENetwork",
    "SemiparametricBNType",
    "SemiparametricBN",
    "ConditionalSemiparametricBN",
    "CLGNetworkType",
    "CLGNetwork",
    "ConditionalCLGNetwork",
    "HomogeneousBNType",
    "HomogeneousBN",
    "ConditionalHomogeneousBN",
    "HeterogeneousBNType",
    "HeterogeneousBN",
    "ConditionalHeterogeneousBN",
]


def _is_discrete(df: DataFrame, variable: str) -> bool:
    return df.is_discrete(variable)


# =========================================================== Gaussian
class GaussianNetworkType(BayesianNetworkType):
    """Homogeneous LinearGaussian (reference models/GaussianNetwork.hpp:12)."""

    def is_homogeneous(self) -> bool:
        return True

    def default_node_type(self) -> FactorType:
        return LinearGaussianCPDType()

    def data_default_node_type(self, df, variable):
        if df.is_continuous(variable):
            return [LinearGaussianCPDType()]
        raise ValueError(
            f"Data type of node {variable} not compatible with "
            "GaussianNetworkType"
        )

    def requires_continuous_data(self) -> bool:
        return True

    def new_bn(self, nodes):
        return GaussianNetwork(nodes)

    def new_cbn(self, nodes, interface_nodes):
        return ConditionalGaussianNetwork(nodes, interface_nodes)

    def ToString(self) -> str:
        return "GaussianNetworkType"


# =========================================================== Discrete
class DiscreteBNType(BayesianNetworkType):
    """Homogeneous DiscreteFactor (reference models/DiscreteBN.hpp:15)."""

    def is_homogeneous(self) -> bool:
        return True

    def default_node_type(self) -> FactorType:
        return DiscreteFactorType()

    def data_default_node_type(self, df, variable):
        if df.is_discrete(variable):
            return [DiscreteFactorType()]
        raise ValueError(
            f"Data type of node {variable} not compatible with DiscreteBNType"
        )

    def requires_discrete_data(self) -> bool:
        return True

    def new_bn(self, nodes):
        return DiscreteBN(nodes)

    def new_cbn(self, nodes, interface_nodes):
        return ConditionalDiscreteBN(nodes, interface_nodes)

    def ToString(self) -> str:
        return "DiscreteNetworkType"


# =========================================================== KDE
class KDENetworkType(BayesianNetworkType):
    """Homogeneous CKDE (reference models/KDENetwork.hpp:12)."""

    def is_homogeneous(self) -> bool:
        return True

    def default_node_type(self) -> FactorType:
        from ..factors.ckde import CKDEType

        return CKDEType()

    def data_default_node_type(self, df, variable):
        if df.is_continuous(variable):
            return [self.default_node_type()]
        raise ValueError(
            f"Data type of node {variable} not compatible with KDENetworkType"
        )

    def requires_continuous_data(self) -> bool:
        return True

    def new_bn(self, nodes):
        return KDENetwork(nodes)

    def new_cbn(self, nodes, interface_nodes):
        return ConditionalKDENetwork(nodes, interface_nodes)

    def ToString(self) -> str:
        return "KDENetworkType"


# =========================================================== Semiparametric
class SemiparametricBNType(BayesianNetworkType):
    """Heterogeneous {LinearGaussian ⇄ CKDE} + discrete
    (reference models/SemiparametricBN.hpp:43-126)."""

    def is_homogeneous(self) -> bool:
        return False

    def data_default_node_type(self, df, variable):
        from ..factors.ckde import CKDEType

        if df.is_continuous(variable):
            return [LinearGaussianCPDType(), CKDEType()]
        if df.is_discrete(variable):
            return [DiscreteFactorType()]
        raise ValueError(
            f"Data type of node {variable} not compatible with "
            "SemiparametricBNType"
        )

    def compatible_node_type(self, model, variable, node_type) -> bool:
        from ..factors.ckde import CKDEType

        if node_type == DiscreteFactorType():
            # a discrete node cannot have continuous parents
            for p in model.parents(variable):
                pt = model.node_type(p)
                if pt in (LinearGaussianCPDType(), CKDEType()):
                    return False
            # and its children must remain valid
            return True
        if node_type in (LinearGaussianCPDType(), CKDEType()):
            # continuous node cannot be parent of a discrete node: checked in
            # can_have_arc
            return True
        # user-defined types allowed
        return True

    def can_have_arc(self, model, source, target) -> bool:
        # block continuous -> discrete (SemiparametricBN.hpp:94-104)
        st = model.node_type(source)
        tt = model.node_type(target)
        from ..factors.ckde import CKDEType

        continuous = (LinearGaussianCPDType(), CKDEType())
        if st in continuous and tt == DiscreteFactorType():
            return False
        return True

    def alternative_node_type(self, model, variable):
        """LG ⇄ CKDE toggle (SemiparametricBN.hpp:107-126)."""
        from ..factors.ckde import CKDEType

        nt = model.node_type(variable)
        if nt == LinearGaussianCPDType():
            return [CKDEType()]
        if nt == CKDEType():
            return [LinearGaussianCPDType()]
        return []

    def new_bn(self, nodes):
        return SemiparametricBN(nodes)

    def new_cbn(self, nodes, interface_nodes):
        return ConditionalSemiparametricBN(nodes, interface_nodes)

    def ToString(self) -> str:
        return "SemiparametricBNType"


# =========================================================== CLG
class CLGNetworkType(BayesianNetworkType):
    """Conditional linear Gaussian (reference models/CLGNetwork.hpp:14-100):
    discrete nodes get DiscreteFactor, continuous get (C)LinearGaussian;
    continuous may not parent discrete."""

    def is_homogeneous(self) -> bool:
        return False

    def data_default_node_type(self, df, variable):
        if df.is_discrete(variable):
            return [DiscreteFactorType()]
        if df.is_continuous(variable):
            # continuous nodes use LinearGaussianCPDType; new_factor
            # dispatches to CLinearGaussianCPD when discrete parents exist
            # (reference CLGNetwork.hpp:14-100, LinearGaussianCPD.cpp:33-59)
            return [LinearGaussianCPDType()]
        raise ValueError(
            f"Data type of node {variable} not compatible with CLGNetworkType"
        )

    def compatible_node_type(self, model, variable, node_type) -> bool:
        return node_type in (DiscreteFactorType(), LinearGaussianCPDType())

    def can_have_arc(self, model, source, target) -> bool:
        st = model.node_type(source)
        tt = model.node_type(target)
        if st == LinearGaussianCPDType() and tt == DiscreteFactorType():
            return False
        return True

    def new_bn(self, nodes):
        return CLGNetwork(nodes)

    def new_cbn(self, nodes, interface_nodes):
        return ConditionalCLGNetwork(nodes, interface_nodes)

    def ToString(self) -> str:
        return "CLGNetworkType"


# =========================================================== Homogeneous
class HomogeneousBNType(BayesianNetworkType):
    """User-supplied single factor type (reference models/HomogeneousBN.hpp:10)."""

    @classmethod
    def _default_singleton(cls) -> bool:
        return False

    def __init__(self, factor_type: FactorType):
        self.factor_type = factor_type

    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other) and self.factor_type == other.factor_type
        )

    def __hash__(self) -> int:
        return hash((type(self), self.factor_type))

    def is_homogeneous(self) -> bool:
        return True

    def default_node_type(self) -> FactorType:
        return self.factor_type

    def data_default_node_type(self, df, variable):
        return [self.factor_type]

    def new_bn(self, nodes):
        return HomogeneousBN(self.factor_type, nodes)

    def new_cbn(self, nodes, interface_nodes):
        return ConditionalHomogeneousBN(self.factor_type, nodes, interface_nodes)

    def ToString(self) -> str:
        return f"HomogeneousBNType({self.factor_type.ToString()})"

    def __reduce__(self):
        return (HomogeneousBNType, (self.factor_type,))


# =========================================================== Heterogeneous
def _dtype_key(x) -> str:
    """Canonical string key for a data type: accepts pyarrow DataTypes
    (reference MapDataToFactor keys, models/HeterogeneousBN.hpp:22-110),
    numpy dtypes, or strings. Categorical/dictionary types map to
    'categorical'."""
    try:
        import pyarrow as pa

        if isinstance(x, pa.DataType):
            if pa.types.is_float32(x):
                return "float32"
            if pa.types.is_float64(x):
                return "float64"
            if pa.types.is_dictionary(x):
                return "categorical"
            return str(x)
    except ImportError:  # pragma: no cover
        pass
    if isinstance(x, str):
        return x
    try:
        return str(np.dtype(x))
    except TypeError:
        return str(x)


class HeterogeneousBNType(BayesianNetworkType):
    """User-supplied default factor types, optionally per data type
    (reference models/HeterogeneousBN.hpp:22-110)."""

    @classmethod
    def _default_singleton(cls) -> bool:
        return False

    def __init__(self, default_factor_types):
        # list[FactorType]  OR  dict[data-type -> list[FactorType]] with
        # pyarrow DataType / numpy dtype / string keys
        if isinstance(default_factor_types, dict):
            self.default_map = {
                _dtype_key(k): list(v)
                for k, v in default_factor_types.items()
            }
            self.default_list = None
        else:
            self.default_list = list(default_factor_types)
            self.default_map = None

    def __eq__(self, other) -> bool:
        if type(self) is not type(other):
            return False
        return (
            self.default_list == other.default_list
            and self.default_map == other.default_map
        )

    def __hash__(self) -> int:
        if self.default_list is not None:
            return hash((type(self), tuple(self.default_list)))
        return hash(
            (type(self), frozenset((k, tuple(v)) for k, v in self.default_map.items()))
        )

    def is_homogeneous(self) -> bool:
        return False

    def data_default_node_type(self, df, variable):
        if self.default_map is not None:
            key = _dtype_key(df.col_dtype(variable))
            if key in self.default_map:
                return self.default_map[key]
            raise ValueError(
                f"No default factor type for data type '{key}' of node "
                f"{variable}"
            )
        return self.default_list

    def single_default(self) -> bool:
        return self.default_map is None

    def default_node_types(self):
        """Dict of default FactorType lists per data type
        (reference models/HeterogeneousBN.hpp:115)."""
        if self.default_map is not None:
            return dict(self.default_map)
        return {}

    def new_bn(self, nodes):
        arg = self.default_map if self.default_map is not None else self.default_list
        return HeterogeneousBN(arg, nodes)

    def new_cbn(self, nodes, interface_nodes):
        arg = self.default_map if self.default_map is not None else self.default_list
        return ConditionalHeterogeneousBN(arg, nodes, interface_nodes)

    def ToString(self) -> str:
        if self.default_list is not None:
            inner = ", ".join(t.ToString() for t in self.default_list)
        else:
            inner = "; ".join(
                f"{k}: [{', '.join(t.ToString() for t in v)}]"
                for k, v in self.default_map.items()
            )
        return f"HeterogeneousBNType({inner})"

    def __reduce__(self):
        arg = self.default_map if self.default_map is not None else self.default_list
        return (HeterogeneousBNType, (arg,))


# ============================================================ BN wrappers
class GaussianNetwork(BayesianNetwork):
    def __init__(self, nodes=None, arcs=None, graph=None):
        super().__init__(GaussianNetworkType(), nodes, arcs, graph)


class ConditionalGaussianNetwork(ConditionalBayesianNetwork):
    def __init__(self, nodes=None, interface_nodes=None, arcs=None, graph=None):
        super().__init__(
            GaussianNetworkType(), nodes, interface_nodes, arcs, graph
        )


class DiscreteBN(BayesianNetwork):
    def __init__(self, nodes=None, arcs=None, graph=None):
        super().__init__(DiscreteBNType(), nodes, arcs, graph)


class ConditionalDiscreteBN(ConditionalBayesianNetwork):
    def __init__(self, nodes=None, interface_nodes=None, arcs=None, graph=None):
        super().__init__(DiscreteBNType(), nodes, interface_nodes, arcs, graph)


class KDENetwork(BayesianNetwork):
    def __init__(self, nodes=None, arcs=None, graph=None):
        super().__init__(KDENetworkType(), nodes, arcs, graph)


class ConditionalKDENetwork(ConditionalBayesianNetwork):
    def __init__(self, nodes=None, interface_nodes=None, arcs=None, graph=None):
        super().__init__(KDENetworkType(), nodes, interface_nodes, arcs, graph)


class SemiparametricBN(BayesianNetwork):
    def __init__(self, nodes=None, arcs=None, graph=None, node_types=None):
        super().__init__(SemiparametricBNType(), nodes, arcs, graph, node_types)


class ConditionalSemiparametricBN(ConditionalBayesianNetwork):
    def __init__(self, nodes=None, interface_nodes=None, arcs=None, graph=None,
                 node_types=None):
        super().__init__(
            SemiparametricBNType(), nodes, interface_nodes, arcs, graph,
            node_types
        )


class CLGNetwork(BayesianNetwork):
    def __init__(self, nodes=None, arcs=None, graph=None):
        super().__init__(CLGNetworkType(), nodes, arcs, graph)


class ConditionalCLGNetwork(ConditionalBayesianNetwork):
    def __init__(self, nodes=None, interface_nodes=None, arcs=None, graph=None):
        super().__init__(CLGNetworkType(), nodes, interface_nodes, arcs, graph)


class HomogeneousBN(BayesianNetwork):
    def __init__(self, factor_type, nodes=None, arcs=None, graph=None):
        super().__init__(HomogeneousBNType(factor_type), nodes, arcs, graph)


class ConditionalHomogeneousBN(ConditionalBayesianNetwork):
    def __init__(self, factor_type, nodes=None, interface_nodes=None,
                 arcs=None, graph=None):
        super().__init__(
            HomogeneousBNType(factor_type), nodes, interface_nodes, arcs, graph
        )


class HeterogeneousBN(BayesianNetwork):
    def __init__(self, default_factor_types, nodes=None, arcs=None, graph=None,
                 node_types=None):
        super().__init__(
            HeterogeneousBNType(default_factor_types), nodes, arcs, graph,
            node_types
        )


class ConditionalHeterogeneousBN(ConditionalBayesianNetwork):
    def __init__(self, default_factor_types, nodes=None, interface_nodes=None,
                 arcs=None, graph=None, node_types=None):
        super().__init__(
            HeterogeneousBNType(default_factor_types),
            nodes,
            interface_nodes,
            arcs,
            graph,
            node_types,
        )
