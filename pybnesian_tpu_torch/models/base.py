"""Bayesian-network model layer: type-policy objects × generic containers.

Rebuild of reference models/BayesianNetwork.hpp (1,468 LoC):
``BayesianNetworkType`` is a singleton policy object answering questions about
homogeneity, default/compatible factor types, and arc legality
(BayesianNetwork.hpp:224-301); ``BayesianNetwork`` is the generic container
(reference ``BNGeneric<DagType>``) delegating structure to a
:class:`~pybnesian_tpu.graph.Dag` and storing one CPD per node.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..data import DataFrame
from ..factors.base import Arguments, FactorType, UnknownFactorType
from ..graph import ConditionalDag, Dag, NodeLookupError
from ..runtime.tracing import span

_LOG_2PI = math.log(2.0 * math.pi)

# ---------------------------------------------------------------------------
# Native all-LG serial tier (pybnesian_tpu/_native/lgfast.c): small/medium
# pure-LinearGaussian networks run fit / slogl / sample as ONE C call each.
# The TPU kernels win every batched workload; this tier wins the
# serial-shaped ones (BASELINE config 1) where per-call Python plumbing,
# not compute, is the cost (reference runs the same loops in C++:
# mle_LinearGaussianCPD.hpp:12-69, BayesianNetwork.hpp:960-1066).
_LGFAST = None
_LGFAST_TRIED = False
# builds a process tries before it keeps a failure: each runs under the
# build's lock, so a second finds what a concurrent build finished, or
# compiles again where the first compiler failed for a moment
_LGFAST_ATTEMPTS = 2


def _lgfast_mod():
    global _LGFAST, _LGFAST_TRIED
    if not _LGFAST_TRIED:
        import os

        from .._native import build_ext_and_import

        src = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "_native",
            "lgfast.c",
        )
        for _ in range(_LGFAST_ATTEMPTS):
            try:
                _LGFAST = build_ext_and_import(src, "lgfast")
                break
            except Exception:
                _LGFAST = None
        _LGFAST_TRIED = True
    return _LGFAST


# (names, {name: position}) per pandas column Index, keyed on the Index
# OBJECT identity (pandas treats Index objects as immutable; any column
# mutation replaces the Index). A 2-slot MRU avoids iterating arrow-backed
# Index objects (~µs each) on every fit/slogl call.
_COLMAP: list = [None, None]
_PD_DF = None


def _pandas_df_cls():
    global _PD_DF
    if _PD_DF is None:
        import pandas

        _PD_DF = pandas.DataFrame
    return _PD_DF


def _df_colmap(df):
    cols = df.columns
    e0 = _COLMAP[0]
    if e0 is not None and e0[0] is cols:
        return e0
    e1 = _COLMAP[1]
    if e1 is not None and e1[0] is cols:
        _COLMAP[0], _COLMAP[1] = e1, e0
        return e1
    names = list(cols)
    pos = {}
    for i, c in enumerate(names):
        if type(c) is not str:
            return None
        pos[c] = i
    entry = (cols, names, pos, [None])
    _COLMAP[0], _COLMAP[1] = entry, _COLMAP[0]
    return entry


def _df_values(df, cm):
    """(n, d) float64 matrix for a gate-checked single-dtype frame. For
    single-block frames the extracted VIEW is cached in the colmap entry
    and revalidated per call against the live block buffer identity
    (``view.base is block.values``), so in-place value edits flow through
    and block replacement (``df[c] = ...``) forces re-extraction."""
    blocks = df._mgr.blocks
    slot = cm[3]
    if len(blocks) == 1:
        bv = blocks[0].values
        vals = slot[0]
        if vals is not None and vals.base is bv:
            return vals
        vals = df.to_numpy()
        if vals.base is bv:
            slot[0] = vals
        return vals
    return df.to_numpy()

def _lg_factor_native_slogl(cpd, df):
    """slogl of ONE fitted LinearGaussianCPD through the same native
    kernel the model-level fast path uses — per-node values are therefore
    bitwise identical between ``model.slogl`` and ``sum(cpd.slogl)``
    (reference BNGeneric::slogl contract). Returns None whenever the fast
    preconditions fail (caller runs the generic numpy path)."""
    mod = _lgfast_mod()
    if mod is None:
        return None
    v = cpd._variance
    if not (isinstance(v, float) and v > 0.0 and math.isfinite(v)):
        return None
    beta = cpd._beta
    ev = cpd._evidence
    if (
        type(beta) is not np.ndarray
        or beta.dtype != np.float64
        or beta.ndim != 1
        or beta.shape[0] != len(ev) + 1
        or not beta.flags.c_contiguous
    ):
        return None
    if type(df) is (_PD_DF or _pandas_df_cls()):
        mgr = getattr(df, "_mgr", None)
        blocks = getattr(mgr, "blocks", None)
        if not blocks or any(b.dtype != np.float64 for b in blocks):
            return None
        cm = _df_colmap(df)
        if cm is None:
            return None
        pos = cm[2]
        try:
            yidx = np.array([pos[cpd._variable]], np.int32)
            pidx = np.fromiter((pos[e] for e in ev), np.int32, len(ev))
        except KeyError:
            return None
        vals = _df_values(df, cm)
        if vals.dtype != np.float64 or vals.ndim != 2:
            return None
    elif type(df) is DataFrame:
        # wrapped frame: stack the family columns as (k+1, n) and hand the
        # kernel the F-contiguous transpose, so the unit-stride SIMD loops
        # run and the value is BITWISE identical to the pandas route (the
        # reference's slogl identity tests compare across entry points)
        arrs = []
        for c in (cpd._variable, *ev):
            col = df._columns.get(c)
            if col is None or col.categories is not None:
                return None
            cv = col.values
            if cv.dtype != np.float64 or not cv.flags.c_contiguous:
                return None
            arrs.append(cv)
        vals = np.stack(arrs).T
        k = len(ev)
        yidx = np.array([0], np.int32)
        pidx = np.arange(1, k + 1, dtype=np.int32)
    else:
        return None
    indptr = np.array([0, len(ev)], np.int32)
    out = np.empty(1)
    total = mod.lgf_slogl(
        vals, yidx, indptr, pidx, beta.reshape(1, -1), np.array([v]), out
    )
    if total != total:  # NaN rows: the generic path owns null semantics
        return None
    return float(out[0])


# per-type-class arity of data_default_node_type: True = the reference's
# single-argument (arrow DataType) signature, False = (df, variable)
_DDNT_SINGLE_ARG: dict[type, bool] = {}

__all__ = [
    "BayesianNetworkType",
    "BayesianNetworkBase",
    "BayesianNetwork",
    "ConditionalBayesianNetwork",
]


class BayesianNetworkType:
    """Policy singleton (reference models/BayesianNetwork.hpp:224-301)."""

    _singleton = None

    def __new__(cls, *args, **kwargs):
        if cls._default_singleton() and cls._singleton is not None:
            return cls._singleton
        inst = super().__new__(cls)
        if cls._default_singleton():
            cls._singleton = inst
        return inst

    @classmethod
    def _default_singleton(cls) -> bool:
        return True

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return hash(type(self))

    # ------------------------------------------------------------- policy
    def is_homogeneous(self) -> bool:
        raise NotImplementedError

    def default_node_type(self) -> FactorType:
        """Single factor type of homogeneous networks."""
        raise NotImplementedError

    def data_default_node_type(self, df: DataFrame, variable: str):
        """Priority list of factor types for a column, from data
        (reference SemiparametricBN.hpp:43-55)."""
        raise NotImplementedError

    def compatible_node_type(self, model, variable: str, node_type: FactorType) -> bool:
        return True

    def can_have_arc(self, model, source: str, target: str) -> bool:
        return True

    def alternative_node_type(self, model, variable: str) -> list[FactorType]:
        """Candidate alternative types for the ChangeNodeType operator
        (reference SemiparametricBN.hpp:107-126)."""
        return []

    def requires_discrete_data(self) -> bool:
        return False

    def requires_continuous_data(self) -> bool:
        return False

    def new_bn(self, nodes) -> "BayesianNetwork":
        return BayesianNetwork(self, nodes)

    def new_cbn(self, nodes, interface_nodes) -> "ConditionalBayesianNetwork":
        return ConditionalBayesianNetwork(self, nodes, interface_nodes)

    def ToString(self) -> str:
        return type(self).__name__

    def __str__(self) -> str:
        return self.ToString()

    def __repr__(self) -> str:
        return self.ToString()

    def __reduce__(self):
        if type(self)._default_singleton():
            return (type(self), ())
        return super().__reduce__()


class BayesianNetworkBase:
    """Shared surface of (conditional) Bayesian networks
    (reference models/BayesianNetwork.hpp:29-145)."""

    # subclasses set: self._type, self._graph, self._cpds, self._node_types

    # Whether pickling includes fitted CPDs (reference
    # pybindings_models.cpp:1117 def_property "include_cpd"); instance
    # assignment shadows this class default.
    include_cpd = False

    # Copy-on-write graph storage: models built from an interned structure
    # template carry only a template reference until something actually
    # touches the graph; the first access materialises a private copy.
    # Mirrors the reference's cheap C++ graph construction without paying
    # Python-object graph building on every small-model pipeline.
    _graph_v = None
    _graph_tpl = None

    @property
    def _graph(self):
        g = self._graph_v
        if g is None:
            tpl = self._graph_tpl
            if tpl is None:
                raise AttributeError("model graph not initialised")
            g = tpl.proto._structural_copy()
            self._graph_v = g
        return g

    @_graph.setter
    def _graph(self, value):
        self._graph_v = value
        self._graph_tpl = None

    # ------------------------------------------------------------ structure
    def graph(self):
        return self._graph

    def type(self) -> BayesianNetworkType:
        return self._type

    def num_nodes(self) -> int:
        return self._graph.num_nodes()

    def num_arcs(self) -> int:
        return self._graph.num_arcs()

    def nodes(self) -> list[str]:
        return self._graph.nodes()

    def arcs(self) -> list[tuple[str, str]]:
        return self._graph.arcs()

    def contains_node(self, name: str) -> bool:
        return self._graph.contains_node(name)

    def index(self, name: str) -> int:
        return self._graph.index(name)

    def name(self, idx: int) -> str:
        return self._graph.name(idx)

    def indices(self) -> dict:
        return self._graph.indices()

    def collapsed_indices(self) -> dict:
        return self._graph.collapsed_indices()

    def collapsed_from_index(self, idx: int) -> int:
        return self._graph.collapsed_from_index(idx)

    def index_from_collapsed(self, cidx: int) -> int:
        return self._graph.index_from_collapsed(cidx)

    def collapsed_name(self, cidx: int) -> str:
        return self._graph.collapsed_name(cidx)

    def is_valid(self, idx: int) -> bool:
        return self._graph.is_valid(idx)

    def is_root(self, node) -> bool:
        return self._graph.is_root(node)

    def is_leaf(self, node) -> bool:
        return self._graph.is_leaf(node)

    def _clone_extra_into(self, new) -> None:
        """Carry Python-subclass extra state through clone via the
        ``__getstate_extra__``/``__setstate_extra__`` contract (reference
        pybindings keep_python_alive clone semantics: hc returns a clone of
        the start model that must preserve subclass attributes)."""
        extra = getattr(self, "__getstate_extra__", None)
        setter = getattr(new, "__setstate_extra__", None)
        if callable(extra) and callable(setter):
            setter(extra())

    def can_have_cpd(self, name: str) -> bool:
        """Whether the node stores a CPD (interface nodes in conditional BNs
        do not; reference BayesianNetwork.hpp:601,1311)."""
        return name in self._fit_nodes()

    def check_compatible_cpd(self, cpd) -> None:
        """Validate a CPD against the model's nodes, parent sets and node
        types (reference BayesianNetwork.hpp:863-911)."""
        if cpd.variable() not in self._fit_nodes():
            raise ValueError(
                "CPD defined on variable which is not present in the model:\n"
                + cpd.ToString()
            )
        all_nodes = set(self._all_nodes())
        evidence = list(cpd.evidence())
        for ev in evidence:
            if ev not in all_nodes:
                raise ValueError(
                    f"Evidence variable {ev} is not present in the model:\n"
                    + cpd.ToString()
                )
        pa = self.parents(cpd.variable())
        if len(pa) != len(evidence) or set(pa) != set(evidence):
            raise ValueError(
                "CPD do not have the model's parent set as evidence:\n"
                + cpd.ToString()
                + "\nParents: " + ", ".join(pa)
            )
        nt = self.node_type(cpd.variable())
        if nt != UnknownFactorType() and cpd.type() != nt:
            raise ValueError(
                f"Factor {cpd.ToString()} is of type {cpd.type().ToString()}."
                f" Bayesian network expects type {nt.ToString()}"
            )

    def collapsed_index(self, name: str) -> int:
        return self._graph.collapsed_index(name)

    def parents(self, node) -> list[str]:
        return self._graph.parents(node)

    def children(self, node) -> list[str]:
        return self._graph.children(node)

    def num_parents(self, node) -> int:
        return self._graph.num_parents(node)

    def num_children(self, node) -> int:
        return self._graph.num_children(node)

    def has_arc(self, source, target) -> bool:
        return self._graph.has_arc(source, target)

    def has_path(self, source, target) -> bool:
        return self._graph.has_path(source, target)

    def roots(self) -> list[str]:
        return self._graph.roots()

    def leaves(self) -> list[str]:
        return self._graph.leaves()

    def topological_sort(self) -> list[str]:
        return self._graph.topological_sort()

    def has_unknown_node_types(self) -> bool:
        # reference iterates nodes() (BayesianNetwork.hpp:750-756); interface
        # nodes carry no CPD and legitimately stay Unknown
        return any(
            self.node_type(n) == UnknownFactorType() for n in self.nodes()
        )

    def add_node(self, name: str) -> int:
        idx = self._graph.add_node(name)
        if not self._type.is_homogeneous():
            self._node_types.setdefault(name, UnknownFactorType())
        return idx

    def remove_node(self, node) -> None:
        self._lgfs = None
        name = node if isinstance(node, str) else self._graph.name(node)
        self._graph.remove_node(name)
        self._cpds.pop(name, None)
        self._node_types.pop(name, None)

    def can_add_arc(self, source, target) -> bool:
        s = source if isinstance(source, str) else self._graph.name(source)
        t = target if isinstance(target, str) else self._graph.name(target)
        return self._graph.can_add_arc(s, t) and self._type.can_have_arc(
            self, s, t
        )

    def can_flip_arc(self, source, target) -> bool:
        s = source if isinstance(source, str) else self._graph.name(source)
        t = target if isinstance(target, str) else self._graph.name(target)
        return self._graph.can_flip_arc(s, t) and self._type.can_have_arc(
            self, t, s
        )

    def add_arc(self, source, target) -> None:
        self._lgfs = None
        s = source if isinstance(source, str) else self._graph.name(source)
        t = target if isinstance(target, str) else self._graph.name(target)
        if not self._type.can_have_arc(self, s, t):
            raise ValueError(
                f"Arc {s} -> {t} is not allowed by {self._type.ToString()}"
            )
        self._graph.add_arc(s, t)

    def add_arc_unsafe(self, source, target) -> None:
        self._lgfs = None
        self._graph.add_arc_unsafe(source, target)

    def remove_arc(self, source, target) -> None:
        self._lgfs = None
        self._graph.remove_arc(source, target)

    def flip_arc(self, source, target) -> None:
        self._lgfs = None
        s = source if isinstance(source, str) else self._graph.name(source)
        t = target if isinstance(target, str) else self._graph.name(target)
        if not self._type.can_have_arc(self, t, s):
            raise ValueError(
                f"Arc {t} -> {s} is not allowed by {self._type.ToString()}"
            )
        self._graph.flip_arc(s, t)

    # ----------------------------------------------------------- node types
    def node_type(self, node) -> FactorType:
        name = node if isinstance(node, str) else self._graph.name(node)
        self._graph.index(name)  # existence check
        if self._type.is_homogeneous():
            return self._type.default_node_type()
        return self._node_types.get(name, UnknownFactorType())

    def node_types(self) -> dict:
        # Only non-interface nodes carry a type (reference
        # BayesianNetwork.hpp node_types over nodes()).
        return {n: self.node_type(n) for n in self.nodes()}

    def set_node_type(self, node, node_type: FactorType) -> None:
        name = node if isinstance(node, str) else self._graph.name(node)
        if self._type.is_homogeneous():
            if node_type != self._type.default_node_type():
                raise ValueError(
                    f"Wrong factor type {node_type} for homogeneous network "
                    f"{self._type.ToString()}"
                )
            return
        if not self._type.compatible_node_type(self, name, node_type):
            raise ValueError(
                f"Factor type {node_type} not compatible with node {name} in "
                f"{self._type.ToString()}"
            )
        old = self._node_types.get(name)
        self._lgfs = None
        self._node_types[name] = node_type
        if old is not None and old != node_type:
            self._cpds.pop(name, None)

    def underlying_node_type(self, df, node) -> FactorType:
        """Concrete type after resolving UnknownFactorType from data
        (reference BayesianNetwork.hpp underlying_node_type)."""
        nt = self.node_type(node)
        if nt == UnknownFactorType():
            df = DataFrame.wrap(df)
            name = node if isinstance(node, str) else self._graph.name(node)
            defaults = self._data_default_types(df, name)
            if not defaults:
                raise ValueError(
                    f"No default factor type for node {name} with data type "
                    f"{df.col_dtype(name)}"
                )
            return defaults[0]
        return nt

    def _data_default_types(self, df: DataFrame, name: str):
        """Call the type policy's ``data_default_node_type`` supporting BOTH
        signatures: this framework's ``(df, variable)`` and the reference's
        ``(arrow_data_type)`` (BayesianNetwork.hpp:259, used by Python
        extension types written against the reference API)."""
        fn = self._type.data_default_node_type
        tcls = type(self._type)
        single_arg = _DDNT_SINGLE_ARG.get(tcls)
        if single_arg is None:
            import inspect

            try:
                params = [
                    p
                    for p in inspect.signature(fn).parameters.values()
                    if p.kind
                    in (
                        inspect.Parameter.POSITIONAL_ONLY,
                        inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    )
                ]
                single_arg = len(params) == 1
            except (TypeError, ValueError):
                single_arg = False
            _DDNT_SINGLE_ARG[tcls] = single_arg
        if single_arg:
            from ..data.arrow_interop import column_pa_type

            out = fn(column_pa_type(df.col(name)))
        else:
            out = fn(df, name)
        if out is not None and not isinstance(out, (list, tuple)):
            return [out]
        return out

    def set_unknown_node_types(self, df, type_blacklist=None) -> None:
        df = DataFrame.wrap(df)
        blacklist = type_blacklist or []
        # reference iterates nodes() — interface nodes of a conditional BN
        # carry no CPD and never get a type resolved
        # (BayesianNetwork.hpp:727)
        for n in self.nodes():
            if self.node_type(n) == UnknownFactorType():
                defaults = self._data_default_types(df, n)
                chosen = None
                for d in defaults:
                    if not any(
                        (bn == n and bt == d) for (bn, bt) in blacklist
                    ):
                        chosen = d
                        break
                if chosen is None:
                    raise ValueError(
                        f"All default factor types for node {n} are "
                        "blacklisted"
                    )
                self._node_types[n] = chosen

    def force_type_whitelist(self, type_whitelist) -> None:
        for name, ftype in type_whitelist or []:
            self.set_node_type(name, ftype)

    def force_whitelist(self, arc_whitelist) -> None:
        for (s, t) in arc_whitelist or []:
            if not self.has_arc(s, t):
                if self.has_arc(t, s):
                    self.flip_arc(t, s)
                else:
                    self.add_arc(s, t)

    def _all_nodes(self) -> list[str]:
        return self._graph.nodes()

    # ------------------------------------------------------------------ CPDs
    def cpd(self, node):
        name = node if isinstance(node, str) else self._graph.name(node)
        cpd = self._cpds.get(name)
        if cpd is None:
            raise ValueError(
                f'CPD of variable "{name}" not added. Call add_cpds() or '
                "fit() to add the CPD."
            )
        return cpd

    def add_cpds(self, cpds: Sequence) -> None:
        """(reference BayesianNetwork.hpp:913-940): validate every CPD,
        resolve UnknownFactorType nodes from the CPD types, then store."""
        for cpd in cpds:
            self.check_compatible_cpd(cpd)
        new_types = [
            (c.variable(), c.type())
            for c in cpds
            if self.node_type(c.variable()) == UnknownFactorType()
        ]
        self.force_type_whitelist(new_types)
        self._lgfs = None
        for cpd in cpds:
            self._cpds[cpd.variable()] = cpd

    def fitted(self) -> bool:
        for n in self._fit_nodes():
            cpd = self._cpds.get(n)
            if cpd is None or not cpd.fitted():
                return False
        return True

    def _fit_nodes(self) -> list[str]:
        return self.nodes()

    def _must_construct_cpd(self, cpd, node_type, evidence) -> bool:
        """(reference BayesianNetwork.hpp must_construct_cpd)."""
        return (
            cpd is None
            or cpd.type() != node_type
            or set(cpd.evidence()) != set(evidence)
        )

    def fit(self, df, construction_args: Arguments | None = None) -> None:
        if construction_args is None and self._fit_lg_native(df):
            return
        self._lgfs = None
        df = DataFrame.wrap(df)
        args = construction_args or Arguments()
        self._check_data_compat(df)
        if not self._type.is_homogeneous():
            self.set_unknown_node_types(df)
        if self._fit_lg_fast(df, args):
            return
        for n in self._fit_nodes():
            node_type = self.underlying_node_type(df, n)
            evidence = self.parents(n)
            cpd = self._cpds.get(n)
            a, kw = args.args(n, node_type)
            if self._must_construct_cpd(cpd, node_type, evidence):
                cpd = node_type.new_factor(self, n, evidence, *a, **kw)
                cpd.fit(df)
                self._cpds[n] = cpd
            elif not cpd.fitted():
                cpd.fit(df)

    def _fit_lg_fast(self, df: DataFrame, args: Arguments) -> bool:
        """All-LinearGaussian fit from ONE shared centered Gram matrix.

        The per-node MLE ladder recomputes column extractions and inner
        products per family; for a pure linear-Gaussian network on complete
        data every normal-equation block is a sub-matrix of the single
        d×d Gram, so the whole network fits in one O(n·d²) pass (same
        closed forms as mle_lineargaussian, reference
        mle_LinearGaussianCPD.hpp:12-230). Returns False — leaving the
        generic per-node path to run — on: non-LG node types, per-node
        construction args, nulls, too few rows, or any numerically
        suspect family (singular/ill-conditioned parent block)."""
        from ..factors.lineargaussian import (
            LinearGaussianCPD,
            LinearGaussianCPDType,
        )
        from ..learning.parameters import mle_lineargaussian
        from ..utils import MACHINE_TOL

        lg_t = LinearGaussianCPDType()
        todo = []
        max_k = 0
        for n in self._fit_nodes():
            if self.underlying_node_type(df, n) != lg_t:
                return False
            a, kw = args.args(n, lg_t)
            if a or kw:
                return False
            evidence = self.parents(n)
            cpd = self._cpds.get(n)
            must = self._must_construct_cpd(cpd, lg_t, evidence)
            if must or not cpd.fitted():
                # a reused CPD may carry the same parent SET in a different
                # order — the slope vector must follow ITS evidence order
                ev_order = list(evidence) if must else list(cpd.evidence())
                todo.append((n, ev_order, must))
                max_k = max(max_k, len(evidence))
        if not todo:
            return True
        cols: list[str] = []
        seen = set()
        for n, evidence, _ in todo:
            for c in (n, *evidence):
                if c not in seen:
                    seen.add(c)
                    cols.append(c)
        try:
            mat = df.to_numpy(cols, drop_null=False, dtype=np.float64)
        except Exception:
            return False
        n_rows = len(mat)
        if n_rows <= max_k + 1 or np.isnan(mat).any():
            return False
        idx = {c: i for i, c in enumerate(cols)}
        means = mat.mean(axis=0)
        xc = mat - means
        gram = xc.T @ xc

        fitted = []
        for n, evidence, must in todo:
            yi = idx[n]
            k = len(evidence)
            if k == 0:
                beta = np.array([means[yi]])
                variance = float(gram[yi, yi]) / (n_rows - 1)
            else:
                p = [idx[e] for e in evidence]
                gy = gram[p, yi]
                pvar_tol = (n_rows - 1) * MACHINE_TOL
                if k == 1:
                    v1 = gram[p[0], p[0]]
                    if v1 < pvar_tol:
                        fitted.append((n, evidence, must, None))
                        continue
                    b = gy / v1
                elif k == 2:
                    v1 = gram[p[0], p[0]]
                    v2 = gram[p[1], p[1]]
                    c12 = gram[p[0], p[1]]
                    det = v1 * v2 - c12 * c12
                    if (
                        v1 < pvar_tol
                        or v2 < pvar_tol
                        or det <= 1e3 * MACHINE_TOL * v1 * v2
                    ):
                        fitted.append((n, evidence, must, None))
                        continue
                    b = np.array(
                        [
                            (v2 * gy[0] - c12 * gy[1]) / det,
                            (v1 * gy[1] - c12 * gy[0]) / det,
                        ]
                    )
                else:
                    s = gram[np.ix_(p, p)]
                    if np.any(np.diag(s) < pvar_tol):
                        fitted.append((n, evidence, must, None))  # ladder handles it
                        continue
                    try:
                        chol = np.linalg.cholesky(s)
                    except np.linalg.LinAlgError:
                        fitted.append((n, evidence, must, None))
                        continue
                    ldiag = np.diag(chol)
                    # rcond proxy: collinear parent blocks make the smallest
                    # Cholesky pivot collapse relative to the largest
                    if (ldiag.min() / ldiag.max()) ** 2 < 1e3 * MACHINE_TOL:
                        fitted.append((n, evidence, must, None))  # near-collinear
                        continue
                    from scipy.linalg import cho_solve

                    b = cho_solve((chol, True), gy, check_finite=False)
                    if not np.all(np.isfinite(b)):
                        fitted.append((n, evidence, must, None))
                        continue
                rss = float(gram[yi, yi] - b @ gram[p, yi])
                if not np.isfinite(rss) or rss < 0.0:
                    fitted.append((n, evidence, must, None))
                    continue
                beta = np.concatenate(([means[yi] - b @ means[p]], b))
                variance = rss / (n_rows - k - 1)
            fitted.append((n, evidence, must, (beta, variance)))

        for n, evidence, must, params in fitted:
            cpd = self._cpds.get(n)
            if must:
                cpd = lg_t.new_factor(self, n, evidence)
                self._cpds[n] = cpd
            if params is None:
                cpd.fit(df)
                continue
            beta, variance = params
            assert isinstance(cpd, LinearGaussianCPD)
            cpd._beta = beta
            cpd._variance = variance
            cpd._fitted = True
        return True

    # -------------------------------------------------- native all-LG tier
    # Class default: no fast state until a native fit succeeds. Mutators
    # reset it; use-time verification (per-CPD identity checks) catches
    # everything else (e.g. mutation through graph()).
    _lgfs = None

    def _fit_lg_native(self, df) -> bool:
        """All-LG fit as one C call (``lgfast.lgf_fit``): shared centered
        Gram + per-node closed forms with the exact numeric guards of
        :meth:`_fit_lg_fast`. Engages only for homogeneous LG networks on
        all-float64 pandas frames; returns False (generic path runs) in
        every other case. On success also caches the index/parameter block
        that lets slogl/sample run as single C calls."""
        mod = _lgfast_mod()
        if mod is None:
            return False
        t = self._type
        try:
            if not t.is_homogeneous():
                return False
            from ..factors.lineargaussian import (
                LinearGaussianCPD,
                LinearGaussianCPDType,
            )

            if type(t.default_node_type()) is not LinearGaussianCPDType:
                return False
        except Exception:
            return False
        if type(df) is not (_PD_DF or _pandas_df_cls()):
            return False
        mgr = getattr(df, "_mgr", None)
        blocks = getattr(mgr, "blocks", None)
        if not blocks or any(b.dtype != np.float64 for b in blocks):
            return False
        cm = _df_colmap(df)
        if cm is None:
            return False
        _cols_obj, names, pos = cm[0], cm[1], cm[2]
        if len(names) > 64:
            return False
        cpds = self._cpds
        tpl = self._graph_tpl
        if tpl is not None and self._graph_v is None and not cpds:
            # ---------------- interned-template lane: the graph is pristine
            # (any mutation would have materialised it), every node needs a
            # fresh factor, and the per-df index block is cached on the
            # template — the whole plan is a dictionary hit.
            nodes = tpl.nodes
            dn = len(nodes)
            if dn == 0 or dn > 64:
                return False
            slot = tpl.plan_slot
            if slot is not None and slot[0] is _cols_obj:
                p = slot[1]
            else:
                node_pos = {n: j for j, n in enumerate(nodes)}
                try:
                    yidx = np.fromiter(
                        (pos[n] for n in nodes), np.int32, dn
                    )
                    indptr = np.empty(dn + 1, np.int32)
                    indptr[0] = 0
                    flat = []
                    flat_n = []
                    for j, ev in enumerate(tpl.parents):
                        for e in ev:
                            flat.append(pos[e])
                            flat_n.append(node_pos[e])
                        indptr[j + 1] = len(flat)
                    maxk = max(map(len, tpl.parents))
                except KeyError:
                    return False
                p = {
                    "yidx": yidx,
                    "indptr": indptr,
                    "pidx": np.array(flat, np.int32),
                    "pidx_n": np.array(flat_n, np.int32),
                    "use": np.arange(len(names), dtype=np.int32),
                    "maxk": maxk,
                    "topo_idx": np.fromiter(
                        (node_pos[n] for n in tpl.topo_names), np.int32, dn
                    ),
                    "dfcols": tuple(names),
                    "node_pos": node_pos,
                }
                p["st_proto"] = {
                    "dfcols": p["dfcols"],
                    "cols_obj": None,
                    "yidx": yidx,
                    "indptr": indptr,
                    "pidx": p["pidx"],
                    "betas": None,
                    "vars": None,
                    "items": None,
                    "n_nodes": dn,
                    "plan_ev": tpl.parents,
                    "num_arcs": tpl.num_arcs,
                    "topo": p["topo_idx"],
                    "pidx_n": p["pidx_n"],
                    "order_names": tpl.topo_names,
                    "node_pos": node_pos,
                }
                tpl.plan_slot = (_cols_obj, p)
            vals = _df_values(df, cm)
            n_rows = vals.shape[0]
            maxk = p["maxk"]
            if (
                n_rows <= maxk + 1
                or vals.dtype != np.float64
                or vals.ndim != 2
            ):
                return False
            betas = np.zeros((dn, maxk + 1))
            vars_ = np.empty(dn)
            flags = np.empty(dn, np.uint8)
            yidx, indptr, pidx = p["yidx"], p["indptr"], p["pidx"]
            try:
                rc = mod.lgf_fit(
                    vals, p["use"], yidx, indptr, pidx, betas, vars_, flags
                )
            except Exception:
                return False
            if rc != 0:
                return False
            new = LinearGaussianCPD.__new__
            items = []
            wrapped = None
            parents = tpl.parents
            vlist = vars_.tolist()
            for j, n in enumerate(nodes):
                ev = parents[j]
                cpd = new(LinearGaussianCPD)
                cpd._variable = n
                # shared with the immutable template (evidence() copies out)
                cpd._evidence = ev
                cpds[n] = cpd
                if not flags[j]:
                    if wrapped is None:
                        wrapped = DataFrame.wrap(df)
                    cpd._fitted = False
                    cpd._beta = None
                    cpd._variance = None
                    cpd.fit(wrapped)
                    betas[j, : len(ev) + 1] = cpd._beta
                    vars_[j] = cpd._variance
                    vlist[j] = float(cpd._variance)
                beta_view = betas[j, : len(ev) + 1]
                cpd._beta = beta_view
                v = vlist[j]
                cpd._variance = v
                cpd._fitted = True
                items.append((n, cpd, beta_view, v))
            st = p["st_proto"].copy()
            st["cols_obj"] = _cols_obj
            st["betas"] = betas
            st["vars"] = vars_
            st["items"] = items
            self._lgfs = st
            return True
        # -------------------------------- generic lane (live graph / reused
        # CPDs): build the plan from graph + factor introspection
        nodes = self._fit_nodes()
        dn = len(nodes)
        if dn == 0 or dn > 64:
            return False
        graph = self._graph
        plan = []  # (node, ev_order, must, keep, existing_cpd)
        maxk = 0
        npar = 0
        try:
            for n in nodes:
                if n not in pos:
                    return False
                evidence = graph.parents(n)
                cpd = cpds.get(n)
                must = (
                    cpd is None
                    or type(cpd) is not LinearGaussianCPD
                    or set(cpd.evidence()) != set(evidence)
                )
                # a reused fitted CPD keeps its parameters (reference
                # must_construct_cpd semantics: only unfitted/reshaped
                # CPDs are (re)estimated)
                ev = evidence if must else list(cpd.evidence())
                keep = not must and cpd._fitted
                if keep and (
                    type(cpd._beta) is not np.ndarray
                    or cpd._beta.shape[0] != len(ev) + 1
                    or not isinstance(cpd._variance, float)
                    or cpd._beta.dtype != np.float64
                ):
                    return False
                for e in ev:
                    if e not in pos:
                        return False
                k = len(ev)
                if k > maxk:
                    maxk = k
                npar += k
                plan.append((n, ev, must, keep, cpd))
        except Exception:
            return False
        vals = _df_values(df, cm)
        n_rows = vals.shape[0]
        if n_rows <= maxk + 1 or vals.dtype != np.float64 or vals.ndim != 2:
            return False
        yidx = np.empty(dn, np.int32)
        indptr = np.empty(dn + 1, np.int32)
        pidx = np.empty(npar, np.int32)
        indptr[0] = 0
        o = 0
        for j, (n, ev, _m, _k, _c) in enumerate(plan):
            yidx[j] = pos[n]
            for e in ev:
                pidx[o] = pos[e]
                o += 1
            indptr[j + 1] = o
        use = np.arange(len(names), dtype=np.int32)
        betas = np.zeros((dn, maxk + 1))
        vars_ = np.empty(dn)
        flags = np.empty(dn, np.uint8)
        try:
            rc = mod.lgf_fit(vals, use, yidx, indptr, pidx, betas, vars_, flags)
        except Exception:
            return False
        if rc != 0:
            return False
        items = []
        wrapped = None
        for j, (n, ev, must, keep, cpd) in enumerate(plan):
            if must:
                cpd = LinearGaussianCPD(n, ev)
                cpds[n] = cpd
            if keep:
                betas[j, : len(ev) + 1] = cpd._beta
                vars_[j] = cpd._variance
            elif not flags[j]:
                # numeric guard fired: the generic ladder owns the
                # degenerate-family semantics (singular parent blocks)
                if wrapped is None:
                    wrapped = DataFrame.wrap(df)
                cpd.fit(wrapped)
                betas[j, : len(ev) + 1] = cpd._beta
                vars_[j] = cpd._variance
            beta_view = betas[j, : len(ev) + 1]
            cpd._beta = beta_view
            cpd._variance = float(vars_[j])
            cpd._fitted = True
            items.append((n, cpd, beta_view, cpd._variance))
        self._lgfs = {
            "dfcols": tuple(names),
            "cols_obj": _cols_obj,
            "yidx": yidx,
            "indptr": indptr,
            "pidx": pidx,
            "betas": betas,
            "vars": vars_,
            "items": items,
            "n_nodes": dn,
            "plan_ev": [p[1] for p in plan],
            "num_arcs": graph.num_arcs(),
            "topo": None,
        }
        return True

    def _lgfs_verify(self, st) -> bool:
        """Cheap use-time revalidation of the cached fast state: every node
        still holds the SAME fitted LG factor with the SAME parameter
        buffers. Any mismatch (user replaced/unfitted a CPD, pickle
        round-trip, variance edit) falls back to the generic path."""
        cpds = self._cpds
        if len(cpds) != st["n_nodes"]:
            return False
        for n, cpd, beta, var in st["items"]:
            c = cpds.get(n)
            if (
                c is not cpd
                or c._beta is not beta
                or c._variance != var
                or not c._fitted
                or not (var > 0.0 and math.isfinite(var))
            ):
                return False
        return True

    def _lg_native_slogl(self, st, df):
        """slogl as one C call; None → caller runs the generic path."""
        if type(df) is not (_PD_DF or _pandas_df_cls()):
            return None
        cols = df.columns
        if cols is st["cols_obj"] or tuple(cols) == st["dfcols"]:
            yidx, indptr, pidx = st["yidx"], st["indptr"], st["pidx"]
        else:
            pos = {c: i for i, c in enumerate(cols)}
            try:
                yidx = np.fromiter(
                    (pos[n] for n, *_ in st["items"]), np.int32, st["n_nodes"]
                )
                pidx = np.fromiter(
                    (pos[e] for ev in st["plan_ev"] for e in ev),
                    np.int32,
                    len(st["pidx"]),
                )
            except KeyError:
                return None
            indptr = st["indptr"]
        if not self._lgfs_verify(st):
            return None
        mgr = getattr(df, "_mgr", None)
        blocks = getattr(mgr, "blocks", None)
        if not blocks or any(b.dtype != np.float64 for b in blocks):
            return None
        cm = _df_colmap(df)
        if cm is None:
            return None
        vals = _df_values(df, cm)
        if vals.dtype != np.float64:
            return None
        per_node = st.get("per_node")
        if per_node is None:
            per_node = st["per_node"] = np.empty(st["n_nodes"])
        total = _lgfast_mod().lgf_slogl(
            vals, yidx, indptr, pidx, st["betas"], st["vars"], per_node
        )
        if total != total:  # NaN: data has nulls; generic path owns the rule
            return None
        # exact left-to-right sum of per-factor values: the reference's
        # BNGeneric::slogl is literally that sum and its suite asserts
        # bitwise equality with sum(cpd.slogl()) (BayesianNetwork_test.py)
        return sum(per_node.tolist())

    def _lg_native_sample(self, st, n, seed, ordered):
        """Ancestral sampling as one C call. The stream is deterministic
        per seed and per-variable identical across ``ordered`` flags (the
        observable contract); it is NOT the per-node numpy stream of the
        generic path — sampling distribution semantics are unchanged."""
        if not self._lgfs_verify(st):
            return None
        g = self._graph_v
        if g is None:
            # COW template still pristine — the structure cannot have
            # changed since fit (any mutation materialises the graph)
            if self._graph_tpl is None:
                return None
        elif (
            g.num_nodes() != st["n_nodes"]
            or g.num_arcs() != st["num_arcs"]
        ):
            return None
        if st["topo"] is None:
            try:
                order = self._graph.topological_sort()
            except Exception:
                return None
            node_pos = {it[0]: j for j, it in enumerate(st["items"])}
            try:
                st["topo"] = np.fromiter(
                    (node_pos[nm] for nm in order), np.int32, st["n_nodes"]
                )
                st["pidx_n"] = np.fromiter(
                    (node_pos[e] for ev in st["plan_ev"] for e in ev),
                    np.int32,
                    len(st["pidx"]),
                )
            except KeyError:
                return None
            st["order_names"] = order
        base_seed = (
            seed
            if seed is not None
            else np.random.SeedSequence().entropy % (2**31)
        )
        out = np.empty((st["n_nodes"], n))
        _lgfast_mod().lgf_sample(
            st["topo"],
            st["indptr"],
            st["pidx_n"],
            st["betas"],
            st["vars"],
            n,
            int(base_seed),
            out,
        )
        node_pos = st.get("node_pos")
        if node_pos is None:
            node_pos = {it[0]: j for j, it in enumerate(st["items"])}
            st["node_pos"] = node_pos
        if ordered:
            names = (
                [it[0] for it in st["items"]]
                if self._graph_v is None and self._graph_tpl is not None
                else self.nodes()
            )
        else:
            names = st["order_names"]
        return DataFrame._from_float_arrays(
            names, [out[node_pos[nm]] for nm in names], n
        )

    def _check_data_compat(self, df: DataFrame) -> None:
        if self._type.requires_discrete_data():
            for n in self._fit_nodes():
                if not df.is_discrete(n):
                    raise ValueError(
                        f"Node '{n}' is not categorical; "
                        f"{self._type.ToString()} requires categorical data."
                    )

    def _check_fitted(self):
        if not self.fitted():
            missing = [
                n
                for n in self._fit_nodes()
                if n not in self._cpds or not self._cpds[n].fitted()
            ]
            raise ValueError(
                "Model not fitted. Missing CPDs: " + ", ".join(missing)
            )

    # ------------------------------------------------------------ likelihood
    def _batched_ckde_logl(self, df: DataFrame) -> dict:
        """Per-row logl of all plain-CKDE nodes in ONE device launch
        (TPU-first replacement for the per-node factor.logl loop: each
        separate launch costs a dispatch round trip). Returns {node: (m,)
        float64 array}; empty dict when fewer than two CKDE nodes."""
        from ..factors.ckde import CKDE

        nodes = [
            n
            for n in self._fit_nodes()
            if type(self._cpds.get(n)) is CKDE and self._cpds[n].fitted()
        ]
        if len(nodes) < 2:
            return {}
        from ..factors.ckde import batched_ckde_logl_many

        entries = []
        valid_rows = {}
        with span("pb.slogl.ckde.pack"):
            for n in nodes:
                cpd = self._cpds[n]
                cols = [n, *cpd.evidence()]
                mat = df.to_numpy(cols, drop_null=False, dtype=np.float64)
                valid_rows[n] = df.combined_mask(*cols)
                entries.append((cpd, np.nan_to_num(mat, nan=0.0)))
        with span("pb.slogl.ckde"):
            outs = batched_ckde_logl_many(entries)
        result = {}
        for n, vals in zip(nodes, outs):
            vals = vals.copy()
            vals[~valid_rows[n]] = np.nan
            result[n] = vals
        return result

    def _lg_fast_logl_matrix(self, df: DataFrame):
        """Per-(row, node) logl of an all-LinearGaussian model as ONE
        gemm: every node's conditional mean is an affine map of the data
        columns, so means for all nodes come from ``mat @ W + b0``.
        Returns an (m, num_nodes) array, or None when any node is not a
        fitted LG factor, a variance is non-positive/non-finite, or the
        data has nulls (the generic per-factor path owns null
        semantics)."""
        from ..factors.lineargaussian import LinearGaussianCPD

        nodes = self._fit_nodes()
        cpds = []
        for n in nodes:
            cpd = self._cpds.get(n)
            if type(cpd) is not LinearGaussianCPD or not cpd.fitted():
                return None
            if not (np.isfinite(cpd._variance) and cpd._variance > 0.0):
                return None
            cpds.append(cpd)
        cols: list[str] = []
        seen = set()
        for cpd in cpds:
            for c in (cpd.variable(), *cpd.evidence()):
                if c not in seen:
                    seen.add(c)
                    cols.append(c)
        try:
            mat = df.to_numpy(cols, drop_null=False, dtype=np.float64)
        except Exception:
            return None
        if np.isnan(mat).any():
            return None
        idx = {c: i for i, c in enumerate(cols)}
        w = np.zeros((len(cols), len(nodes)))
        b0 = np.empty(len(nodes))
        var = np.empty(len(nodes))
        yidx = np.empty(len(nodes), dtype=np.intp)
        for j, cpd in enumerate(cpds):
            b0[j] = cpd._beta[0]
            var[j] = cpd._variance
            yidx[j] = idx[cpd.variable()]
            for coef, e in zip(cpd._beta[1:], cpd.evidence()):
                w[idx[e], j] += coef
        mean = mat @ w + b0
        y = mat[:, yidx]
        return (
            -0.5 * np.square(y - mean) / var
            - 0.5 * np.log(var)
            - 0.5 * _LOG_2PI
        )

    def logl(self, df) -> np.ndarray:
        """Per-row joint log-likelihood. Rows with nulls in any family yield
        NaN (reference BNGeneric::logl accumulates NaN)."""
        with span("pb.slogl"):
            self._check_fitted()
            df = DataFrame.wrap(df)
            fast = self._lg_fast_logl_matrix(df)
            if fast is not None:
                return fast.sum(axis=1)
            total = np.zeros(df.num_rows)
            batched = self._batched_ckde_logl(df)
            for n in self._fit_nodes():
                if n in batched:
                    total = total + batched[n]
                else:
                    with span("pb.slogl.lg"):
                        total = total + np.asarray(self._cpds[n].logl(df))
            return total

    def slogl(self, df) -> float:
        """Sum of per-factor slogl (each factor skips its own null rows,
        reference BNGeneric::slogl:1010)."""
        with span("pb.slogl"):
            st = self._lgfs
            if st is not None:
                out = self._lg_native_slogl(st, df)
                if out is not None:
                    return out
            self._check_fitted()
            df = DataFrame.wrap(df)
            # NOTE: no matrix shortcut here — slogl is the SUM of per-factor
            # slogl values (reference BNGeneric::slogl:1010, asserted
            # bitwise by its suite), and each LG factor's slogl is already
            # one native call
            batched = self._batched_ckde_logl(df)
            total = 0.0
            for n in self._fit_nodes():
                if n in batched:
                    total += float(np.nansum(batched[n]))
                else:
                    with span("pb.slogl.lg"):
                        total += self._cpds[n].slogl(df)
            return total

    # ---------------------------------------------------------------- sample
    def sample(self, n: int, seed: int | None = None, ordered: bool = False):
        """Ancestral sampling (reference BNGeneric::sample:1024-1066)."""
        st = self._lgfs
        if st is not None:
            out = self._lg_native_sample(st, n, seed, ordered)
            if out is not None:
                return out
        self._check_fitted()
        import pandas as pd

        from ..factors.lineargaussian import LinearGaussianCPD

        order = self._graph.topological_sort()
        data: dict[str, object] = {}
        base_seed = seed if seed is not None else np.random.SeedSequence().entropy % (2**31)
        for i, node in enumerate(order):
            cpd = self._cpds[node]
            evidence = cpd.evidence()
            if type(cpd) is LinearGaussianCPD and all(
                isinstance(data.get(e), np.ndarray) for e in evidence
            ):
                # same arithmetic and rng stream as LinearGaussianCPD.sample,
                # skipping the per-node DataFrame round trip
                rng = np.random.default_rng(int(base_seed) + i)
                mean = np.full(n, cpd._beta[0])
                if evidence:
                    emat = np.column_stack([data[e] for e in evidence])
                    mean = mean + emat @ cpd._beta[1:]
                data[node] = mean + rng.normal(
                    0.0, math.sqrt(cpd._variance), n
                )
                continue
            ev_df = (
                DataFrame.wrap({e: data[e] for e in evidence})
                if evidence
                else None
            )
            values = cpd.sample(n, ev_df, seed=int(base_seed) + i)
            data[node] = self._postprocess_sample(cpd, values)
        col_order = self.nodes() if ordered else order
        return DataFrame.wrap({c: data[c] for c in col_order})

    @staticmethod
    def _postprocess_sample(cpd, values):
        import pyarrow as pa

        if isinstance(values, (pa.Array, pa.ChunkedArray)):
            if pa.types.is_dictionary(values.type):
                return values.to_pandas()
            return values.to_numpy(zero_copy_only=False)
        from ..factors.discrete import DiscreteFactor

        if isinstance(cpd, DiscreteFactor):
            import pandas as pd

            return pd.Categorical.from_codes(
                np.asarray(values), categories=list(cpd.variable_categories())
            )
        return np.asarray(values)

    # ---------------------------------------------------------------- pickle
    def save(self, filename: str, include_cpd: bool = False) -> None:
        from ..utils.pickle import save_object

        prev = getattr(self, "include_cpd", False)
        self.include_cpd = include_cpd
        try:
            save_object(self, filename)
        finally:
            self.include_cpd = prev

    def __getstate__(self):
        include_cpd = getattr(self, "include_cpd", False)
        state = {
            "type": self._type,
            "graph": self._graph,
            "node_types": dict(self._node_types),
            "cpds": dict(self._cpds) if include_cpd else {},
        }
        extra = getattr(self, "__getstate_extra__", None)
        if callable(extra):
            state["extra"] = extra()
        return state

    def __setstate__(self, state):
        self._type = state["type"]
        self._graph = state["graph"]
        self._node_types = state["node_types"]
        self._cpds = state["cpds"]
        if "extra" in state:
            setter = getattr(self, "__setstate_extra__", None)
            if callable(setter):
                setter(state["extra"])

    # ---------------------------------------------------------------- string
    def ToString(self) -> str:
        return (
            f"{type(self).__name__} [{self._type.ToString()}] "
            f"({self.num_nodes()} nodes, {self.num_arcs()} arcs)"
        )

    def __str__(self) -> str:
        return self.ToString()

    def __repr__(self) -> str:
        return self.ToString()


def _classify_bn_arg(value):
    """Classify one positional model-constructor argument the way the
    reference's pybind11 overload set does (pybindings_models.cpp:2213-2556):
    a graph object, a node-name list, an arc list, or a node-type list."""
    if value is None:
        return None
    if isinstance(value, (Dag, ConditionalDag)) or (
        not isinstance(value, (list, tuple)) and hasattr(value, "to_dag")
    ):
        return "graph"
    if isinstance(value, (list, tuple)):
        seq = list(value)
        if not seq:
            return "names"
        first = seq[0]
        if isinstance(first, str):
            return "names"
        if isinstance(first, (tuple, list)) and len(first) == 2:
            if isinstance(first[1], FactorType):
                return "node_types"
            return "arcs"
    raise TypeError(
        "incompatible constructor arguments: cannot interpret "
        f"{value!r}: expected a graph, node-name list, arc list, or "
        "(node, FactorType) list"
    )


def _reslot_bn_args(positional, n_name_slots):
    """Re-dispatch positional constructor values into (names..., arcs, graph,
    node_types) slots, mirroring the reference's overload resolution. The
    first ``n_name_slots`` str-lists fill the name slots in order (nodes,
    then interface_nodes for conditional networks)."""
    names = []
    arcs = graph = node_types = None
    for value in positional:
        kind = _classify_bn_arg(value)
        if kind is None:
            continue
        if kind == "names" and len(names) < n_name_slots:
            names.append(list(value))
        elif kind in ("names", "arcs"):
            if arcs is not None:
                raise TypeError("Duplicate arc list in model constructor")
            arcs = [tuple(a) for a in value]
        elif kind == "graph":
            if graph is not None:
                raise TypeError("Duplicate graph in model constructor")
            graph = value
        else:
            if node_types is not None:
                raise TypeError("Duplicate node-type list in model constructor")
            node_types = [tuple(t) for t in value]
    while len(names) < n_name_slots:
        names.append(None)
    return (*names, arcs, graph, node_types)


class _GraphTemplate:
    """Interned validated structure: the prototype Dag plus the derived
    metadata the all-LG fast paths need without touching a live graph."""

    __slots__ = (
        "proto", "nodes", "parents", "topo_names", "num_arcs", "plan_slot"
    )

    def __init__(self, proto, nodes, parents, topo_names, num_arcs):
        self.proto = proto
        self.nodes = nodes
        self.parents = parents  # list of parent-name lists, nodes() order
        self.topo_names = topo_names
        self.num_arcs = num_arcs
        self.plan_slot = None  # (cols_obj, plan dict) — per-df index block


# (id(type), nodes, arcs) → _GraphTemplate. Identity-keyed on the type
# singleton (BayesianNetworkType __eq__ is class-wide, too coarse for
# stateful types); the template holds a strong ref so the id stays valid.
_BN_TEMPLATES: dict = {}


class BayesianNetwork(BayesianNetworkBase):
    """Generic unconditional BN (reference BNGeneric over Dag)."""

    def __init__(self, type: BayesianNetworkType, nodes=None, arcs=None,
                 graph=None, node_types=None):
        if (
            graph is None
            and node_types is None
            and type.__class__.can_have_arc is BayesianNetworkType.can_have_arc
            and nodes.__class__ is list
            and arcs.__class__ is list
            and nodes
            and nodes[0].__class__ is str
        ):
            # interned-structure fast lane: identical (type, nodes, arcs)
            # constructions share one validated template; the graph is
            # copied lazily on first real access (COW)
            try:
                key = (id(type), tuple(nodes), tuple(arcs))
                tpl = _BN_TEMPLATES.get(key)
            except TypeError:
                key = tpl = None
            if tpl is not None:
                self._type = type
                self._cpds = {}
                self._node_types = {}
                self._graph_tpl = tpl
                return
            if key is not None and all(
                a.__class__ is tuple
                and len(a) == 2
                and a[0].__class__ is str
                and a[1].__class__ is str
                for a in arcs
            ):
                self._init_slow(type, nodes, arcs, None, None)
                g = self._graph_v
                if g is not None and g.__class__ is Dag:
                    if len(_BN_TEMPLATES) > 256:
                        _BN_TEMPLATES.clear()
                    node_names = g.nodes()
                    _BN_TEMPLATES[key] = _GraphTemplate(
                        g._structural_copy(),
                        node_names,
                        [g.parents(n) for n in node_names],
                        g.topological_sort(),
                        g.num_arcs(),
                    )
                return
        self._init_slow(type, nodes, arcs, graph, node_types)

    def _init_slow(self, type, nodes=None, arcs=None, graph=None,
                   node_types=None):
        nodes, arcs, graph, node_types = _reslot_bn_args(
            (nodes, arcs, graph, node_types), 1
        )
        self._type = type
        self._cpds = {}
        self._node_types = {}
        if graph is not None:
            self._graph = graph
        else:
            self._graph = Dag(list(nodes or []))
            # nodes are inferred from arc endpoints only in the arcs-only
            # construction; with an explicit node list, unknown endpoints are
            # an error (reference pybindings_models.cpp overloads +
            # generic_graph node lookup)
            infer_nodes = nodes is None
            for (s, t) in arcs or []:
                for endpoint in (s, t):
                    if not self._graph.contains_node(endpoint):
                        if infer_nodes:
                            self._graph.add_node(endpoint)
                        else:
                            raise NodeLookupError(
                                f"Node '{endpoint}' not present in the graph"
                            )
                if not type.can_have_arc(self, s, t):
                    raise ValueError(
                        f"Arc {s} -> {t} not allowed by {type.ToString()}"
                    )
                self._graph.add_arc(s, t)
        for (n, ft) in node_types or []:
            self.set_node_type(n, ft)

    def conditional_bn(self, nodes=None, interface_nodes=None):
        """(reference BNGeneric::conditional_bn:1068)."""
        if nodes is None:
            nodes = self.nodes()
            interface_nodes = []
        cbn = ConditionalBayesianNetwork(self._type, nodes, interface_nodes)
        total = set(nodes) | set(interface_nodes or [])
        for (s, t) in self.arcs():
            if s in total and t in total and not cbn.graph().is_interface(t):
                cbn.add_arc(s, t)
        for name, nt in self._node_types.items():
            if name in set(nodes):
                cbn._node_types[name] = nt
        for name, cpd in self._cpds.items():
            if name in set(nodes):
                cbn._cpds[name] = cpd
        return cbn

    def unconditional_bn(self) -> "BayesianNetwork":
        return self.clone()

    def clone(self) -> "BayesianNetwork":
        import copy

        new = type(self).__new__(type(self))
        new._type = self._type
        new._graph = copy.deepcopy(self._graph)
        new._cpds = dict(self._cpds)
        new._node_types = dict(self._node_types)
        self._clone_extra_into(new)
        return new

    def __setstate__(self, state):
        super().__setstate__(state)


class ConditionalBayesianNetwork(BayesianNetworkBase):
    """Conditional BN: interface nodes carry no CPD
    (reference models/BayesianNetwork.hpp:1237-1314)."""

    def __init__(self, type: BayesianNetworkType, nodes=None,
                 interface_nodes=None, arcs=None, graph=None, node_types=None):
        nodes, interface_nodes, arcs, graph, node_types = _reslot_bn_args(
            (nodes, interface_nodes, arcs, graph, node_types), 2
        )
        self._type = type
        self._cpds = {}
        self._node_types = {}
        if graph is not None:
            self._graph = graph
        else:
            self._graph = ConditionalDag(
                list(nodes or []), list(interface_nodes or [])
            )
            for (s, t) in arcs or []:
                self._graph.add_arc(s, t)
        for (n, ft) in node_types or []:
            self.set_node_type(n, ft)

    def interface_nodes(self) -> list[str]:
        return self._graph.interface_nodes()

    def num_interface_nodes(self) -> int:
        return self._graph.num_interface_nodes()

    def joint_nodes(self) -> list[str]:
        return self._graph.joint_nodes()

    def is_interface(self, node) -> bool:
        return self._graph.is_interface(node)

    def interface_arcs(self) -> list[tuple[str, str]]:
        return self._graph.interface_arcs()

    # ------- interface-node mutation + collapsed spaces (graph delegation,
    # reference pybindings_models ConditionalBayesianNetworkBase surface)
    def num_joint_nodes(self) -> int:
        return self._graph.num_joint_nodes()

    def contains_interface_node(self, name: str) -> bool:
        return self._graph.contains_interface_node(name)

    def contains_joint_node(self, name: str) -> bool:
        return self._graph.contains_joint_node(name)

    def add_interface_node(self, name: str) -> int:
        return self._graph.add_interface_node(name)

    def remove_interface_node(self, node) -> None:
        self._graph.remove_interface_node(node)

    def set_interface(self, node) -> None:
        name = node if isinstance(node, str) else self._graph.name(node)
        self._graph.set_interface(node)
        self._cpds.pop(name, None)
        self._node_types.pop(name, None)

    def set_node(self, node) -> None:
        self._graph.set_node(node)

    def interface_collapsed_index(self, name: str) -> int:
        return self._graph.interface_collapsed_index(name)

    def interface_collapsed_from_index(self, idx: int) -> int:
        return self._graph.interface_collapsed_from_index(idx)

    def index_from_interface_collapsed(self, cidx: int) -> int:
        return self._graph.index_from_interface_collapsed(cidx)

    def interface_collapsed_name(self, cidx: int) -> str:
        return self._graph.interface_collapsed_name(cidx)

    def interface_collapsed_indices(self) -> dict:
        return self._graph.interface_collapsed_indices()

    def joint_collapsed_index(self, name: str) -> int:
        return self._graph.joint_collapsed_index(name)

    def joint_collapsed_from_index(self, idx: int) -> int:
        return self._graph.joint_collapsed_from_index(idx)

    def index_from_joint_collapsed(self, cidx: int) -> int:
        return self._graph.index_from_joint_collapsed(cidx)

    def joint_collapsed_name(self, cidx: int) -> str:
        return self._graph.joint_collapsed_name(cidx)

    def joint_collapsed_indices(self) -> dict:
        return self._graph.joint_collapsed_indices()

    def _all_nodes(self) -> list[str]:
        return self._graph.joint_nodes()

    def _fit_nodes(self) -> list[str]:
        return self.nodes()

    def sample(self, n: int = None, evidence=None, concat_evidence: bool = False,
               seed: int | None = None, ordered: bool = False):
        """Sample given interface evidence
        (reference BayesianNetwork.hpp:1237,1314)."""
        self._check_fitted()
        if evidence is None:
            raise ValueError(
                "ConditionalBayesianNetwork::sample needs interface evidence"
            )
        ev = DataFrame.wrap(evidence)
        if n is None:
            n = ev.num_rows
        if ev.num_rows != n:
            raise ValueError("evidence rows != n")
        order = self._graph.topological_sort()
        data = {name: ev.col(name) for name in self.interface_nodes()}
        base_seed = seed if seed is not None else 0
        for i, node in enumerate(order):
            cpd = self._cpds[node]
            evs = cpd.evidence()
            ev_df = (
                DataFrame.wrap({e: data[e] for e in evs}) if evs else None
            )
            values = cpd.sample(n, ev_df, seed=int(base_seed) + i)
            data[node] = self._postprocess_sample(cpd, values)
        cols = self.nodes() if ordered else order
        if concat_evidence:
            cols = cols + self.interface_nodes()
        return DataFrame.wrap({c: data[c] for c in cols})

    def unconditional_bn(self) -> BayesianNetwork:
        bn = BayesianNetwork(
            self._type, self.joint_nodes(), self.arcs()
        )
        bn._node_types = dict(self._node_types)
        bn._cpds = dict(self._cpds)
        return bn

    def conditional_bn(self) -> "ConditionalBayesianNetwork":
        return self.clone()

    def clone(self) -> "ConditionalBayesianNetwork":
        import copy

        new = type(self).__new__(type(self))
        new._type = self._type
        new._graph = copy.deepcopy(self._graph)
        new._cpds = dict(self._cpds)
        new._node_types = dict(self._node_types)
        self._clone_extra_into(new)
        return new
