"""Operators and operator sets for score-based structure search.

Rebuild of reference learning/operators/operators.{hpp,cpp}. The delta matrix
semantics are preserved exactly (operators.cpp:19-437):

- ``delta[source, target]`` holds the score delta of the *operation on the
  pair*: removal if the arc exists, flip-gain if the reverse arc exists,
  addition otherwise;
- ``find_max`` sorts all candidate deltas and returns the first legal
  operator (acyclicity / max-indegree / tabu checked lazily);
- ``update_scores`` recomputes only the columns of nodes whose families
  changed.

Batched difference: every (re)scoring pass collects its candidate families
and evaluates them through ``Score.local_score_batch`` — one batched device
call instead of one ``local_score`` per candidate (the reference's serial
loop, operators.cpp:114-131).

Copied from ``pybnesian_tpu/learning/operators/__init__.py``; it uses
numpy and the port's tracing spans and counters only. The validation
cache of ``hc`` takes every score through
``ValidatedScore.vlocal_score_batch``
(:meth:`LocalScoreCache.update_vlocal_scores`). Each rescoring pass of an
operator set (the arc set's cells, the node-type set's nodes) is the span
``pb.hc.cells``, its score call nested inside it, and adds the cells or
nodes it rescored to the counter ``hc.operator_cells``.
"""

from __future__ import annotations

import math

import numpy as np

from ...factors.base import FactorType
from ...models.base import ConditionalBayesianNetwork
from ...runtime.tracing import count, span

#: Score deltas are quantized at this absolute resolution. Batched device
#: evaluation pads families to bucketed shapes, so the same family can differ
#: across calls by ~1e-11 (different summation orders); without quantization
#: a flip and its opposite can both appear to have positive delta and the
#: search oscillates forever. Any real score difference is far above 1e-9.
DELTA_RESOLUTION = 1e-9


def _quantize(d: float) -> float:
    if not math.isfinite(d):
        return d
    return round(d / DELTA_RESOLUTION) * DELTA_RESOLUTION


__all__ = [
    "Operator",
    "ArcOperator",
    "AddArc",
    "RemoveArc",
    "FlipArc",
    "ChangeNodeType",
    "OperatorTabuSet",
    "LocalScoreCache",
    "OperatorSet",
    "ArcOperatorSet",
    "ChangeNodeTypeSet",
    "OperatorPool",
]


# ================================================================ operators
class Operator:
    def __init__(self, delta: float):
        self._delta = float(delta)

    def delta(self) -> float:
        return self._delta

    def apply(self, model) -> None:
        raise NotImplementedError

    def opposite(self, model) -> "Operator":
        raise NotImplementedError

    def nodes_changed(self, model) -> list[str]:
        raise NotImplementedError

    def ToString(self) -> str:
        raise NotImplementedError

    def __str__(self) -> str:
        return self.ToString()

    def __repr__(self) -> str:
        return self.ToString()


class ArcOperator(Operator):
    def __init__(self, source: str, target: str, delta: float):
        super().__init__(delta)
        self._source = source
        self._target = target

    def source(self) -> str:
        return self._source

    def target(self) -> str:
        return self._target


class AddArc(ArcOperator):
    def apply(self, model) -> None:
        model.add_arc(self._source, self._target)

    def opposite(self, model) -> Operator:
        return RemoveArc(self._source, self._target, -self._delta)

    def nodes_changed(self, model) -> list[str]:
        return [self._target]

    def ToString(self) -> str:
        return f"AddArc({self._source} -> {self._target}; Delta: {self._delta})"

    def __eq__(self, other):
        return (
            isinstance(other, AddArc)
            and self._source == other._source
            and self._target == other._target
        )

    def __hash__(self):
        return hash(("AddArc", self._source, self._target))


class RemoveArc(ArcOperator):
    def apply(self, model) -> None:
        model.remove_arc(self._source, self._target)

    def opposite(self, model) -> Operator:
        return AddArc(self._source, self._target, -self._delta)

    def nodes_changed(self, model) -> list[str]:
        return [self._target]

    def ToString(self) -> str:
        return f"RemoveArc({self._source} -> {self._target}; Delta: {self._delta})"

    def __eq__(self, other):
        return (
            isinstance(other, RemoveArc)
            and self._source == other._source
            and self._target == other._target
        )

    def __hash__(self):
        return hash(("RemoveArc", self._source, self._target))


class FlipArc(ArcOperator):
    def apply(self, model) -> None:
        model.flip_arc(self._source, self._target)

    def opposite(self, model) -> Operator:
        return FlipArc(self._target, self._source, -self._delta)

    def nodes_changed(self, model) -> list[str]:
        return [self._source, self._target]

    def ToString(self) -> str:
        return f"FlipArc({self._source} -> {self._target}; Delta: {self._delta})"

    def __eq__(self, other):
        return (
            isinstance(other, FlipArc)
            and self._source == other._source
            and self._target == other._target
        )

    def __hash__(self):
        return hash(("FlipArc", self._source, self._target))


class ChangeNodeType(Operator):
    def __init__(self, node: str, node_type: FactorType, delta: float):
        super().__init__(delta)
        self._node = node
        self._node_type = node_type

    def node(self) -> str:
        return self._node

    def node_type(self) -> FactorType:
        return self._node_type

    def apply(self, model) -> None:
        model.set_node_type(self._node, self._node_type)

    def opposite(self, model) -> Operator:
        return ChangeNodeType(
            self._node, model.node_type(self._node), -self._delta
        )

    def nodes_changed(self, model) -> list[str]:
        return [self._node]

    def ToString(self) -> str:
        return (
            f"ChangeNodeType({self._node} -> {self._node_type}; "
            f"Delta: {self._delta})"
        )

    def __eq__(self, other):
        return (
            isinstance(other, ChangeNodeType)
            and self._node == other._node
            and self._node_type == other._node_type
        )

    def __hash__(self):
        return hash(("ChangeNodeType", self._node, self._node_type))


class OperatorTabuSet:
    """(reference operators.hpp:258-292)."""

    def __init__(self):
        self._set = set()

    def insert(self, op: Operator) -> None:
        self._set.add(op)

    def contains(self, op: Operator) -> bool:
        return op in self._set

    def clear(self) -> None:
        self._set.clear()

    def empty(self) -> bool:
        return not self._set

    def __contains__(self, op) -> bool:
        return op in self._set


class LocalScoreCache:
    """Per-node local score cache (reference operators.hpp:295-338)."""

    def __init__(self):
        self._scores: dict[str, float] = {}

    def cache_local_scores(self, model, score) -> None:
        nodes = model.nodes()
        fams = [(n, model.parents(n)) for n in nodes]
        values = score.local_score_batch(model, fams)
        self._scores = dict(zip(nodes, values.tolist()))

    def cache_vlocal_scores(self, model, score) -> None:
        """Seeds every node's validation score by the route ``hc``'s
        updates take (:meth:`update_vlocal_scores`), so a validation
        delta subtracts two values of one route."""
        self._scores = {}
        self.update_vlocal_scores(model, score, model.nodes())

    def update_vlocal_scores(self, model, score, nodes) -> None:
        """The validation scores of ``nodes``' families in one
        ``score.vlocal_score_batch`` call. A family whose batch value is
        not finite takes the fitted factor's value
        (``score.vlocal_score``) instead: for a constant variable that is
        the factor's 0.0 where the batch gives −inf. A family's batch
        value is the same alone and in any batch, so a family always takes
        the same route. Counts ``hc.validation_batched`` (families in the
        batch) and ``hc.validation_refits`` (families refitted)."""
        fams = [(n, model.parents(n)) for n in nodes]
        values = score.vlocal_score_batch(model, fams)
        refits = 0
        for (n, ps), v in zip(fams, values.tolist()):
            if not math.isfinite(v):
                v = float(score.vlocal_score(model, n, ps))
                refits += 1
            self._scores[n] = v
        count("hc.validation_batched", len(fams))
        count("hc.validation_refits", refits)

    def update_local_score(self, model, score, node: str) -> None:
        self._scores[node] = float(score.local_score(model, node))

    def update_vlocal_score(self, model, score, node: str) -> None:
        self.update_vlocal_scores(model, score, [node])

    def local_score(self, model, node: str) -> float:
        return self._scores[node]

    def sum(self) -> float:
        return float(sum(self._scores.values()))


# ============================================================= operator sets
class OperatorSet:
    """(reference operators.hpp:340-433)."""

    def __init__(self):
        self._local_cache: LocalScoreCache | None = None
        self._owns_local_cache = False
        self._blacklist: list[tuple[str, str]] = []
        self._whitelist: list[tuple[str, str]] = []
        self._type_blacklist: list = []
        self._type_whitelist: list = []
        self._max_indegree = 0

    # restriction setters (operators.hpp:399-433)
    def set_arc_blacklist(self, blacklist) -> None:
        self._blacklist = list(blacklist or [])

    def set_arc_whitelist(self, whitelist) -> None:
        self._whitelist = list(whitelist or [])

    def set_type_blacklist(self, blacklist) -> None:
        self._type_blacklist = list(blacklist or [])

    def set_type_whitelist(self, whitelist) -> None:
        self._type_whitelist = list(whitelist or [])

    def set_max_indegree(self, max_indegree: int) -> None:
        self._max_indegree = int(max_indegree)

    def set_local_cache(self, cache: LocalScoreCache) -> None:
        self._local_cache = cache
        self._owns_local_cache = False

    def local_score_cache(self) -> LocalScoreCache | None:
        """Shared per-node score cache (reference operators.hpp:747)."""
        return self._local_cache

    def _initialize_local_cache(self, model) -> None:
        if self._local_cache is None:
            self._local_cache = LocalScoreCache()
            self._owns_local_cache = True

    def cache_scores(self, model, score) -> None:
        raise NotImplementedError

    def find_max(self, model, tabu: OperatorTabuSet | None = None):
        raise NotImplementedError

    def find_max_tabu(self, model, tabu_set: OperatorTabuSet):
        """Tabu-aware variant — separate overridable entry point, matching
        the reference's Python-extension contract
        (pybindings_operators.cpp:779)."""
        return self.find_max(model, tabu_set)

    def update_scores(self, model, score, changed_nodes) -> None:
        raise NotImplementedError

    def finished(self) -> None:
        if self._owns_local_cache:
            self._local_cache = None
            self._owns_local_cache = False


class ArcOperatorSet(OperatorSet):
    """Add/Remove/Flip arc candidates with a dense delta matrix
    (reference operators.cpp:19-437)."""

    def __init__(self, blacklist=None, whitelist=None, max_indegree=0):
        super().__init__()
        self.set_arc_blacklist(blacklist)
        self.set_arc_whitelist(whitelist)
        self._max_indegree = int(max_indegree)
        self.delta = None
        self.valid_op = None
        self._sources: list[str] = []
        self._targets: list[str] = []
        self._spos: dict[str, int] = {}
        self._tpos: dict[str, int] = {}

    # ----------------------------------------------------------- caching
    def _update_valid_ops(self, model) -> None:
        conditional = isinstance(model, ConditionalBayesianNetwork)
        self._targets = model.nodes()
        self._sources = model.joint_nodes() if conditional else model.nodes()
        self._spos = {n: i for i, n in enumerate(self._sources)}
        self._tpos = {n: i for i, n in enumerate(self._targets)}
        ns, nt = len(self._sources), len(self._targets)
        self.delta = np.full((ns, nt), -np.inf)
        # the cells whose delta is a flip's (the reverse arc present when
        # the cell was last scored)
        self._flip = np.zeros((ns, nt), dtype=bool)
        self.valid_op = np.ones((ns, nt), dtype=bool)
        for (s, t) in [*self._whitelist, *self._blacklist]:
            # unknown names are a caller error, not a no-op
            # (reference validate_whitelists.cpp)
            if s not in self._spos or t not in self._tpos:
                raise ValueError(
                    f"Arc ({s}, {t}) restriction uses a node not present in "
                    "the graph."
                )
        # arc in blacklist and whitelist -> raise (operators.cpp:31 via
        # util::validate_restrictions, validate_whitelists.hpp:170-175)
        conflicts = set(map(tuple, self._whitelist)) & set(
            map(tuple, self._blacklist)
        )
        if conflicts:
            s, t = sorted(conflicts)[0]
            raise ValueError(f"Arc {s} -> {t} in blacklist and whitelist")
        for (s, t) in self._whitelist:
            self.valid_op[self._spos[s], self._tpos[t]] = False
            if s in self._tpos and t in self._spos:
                self.valid_op[self._spos[t], self._tpos[s]] = False
        for (s, t) in self._blacklist:
            self.valid_op[self._spos[s], self._tpos[t]] = False
        for t in self._targets:
            if t in self._spos:
                self.valid_op[self._spos[t], self._tpos[t]] = False

    def _pair_families(self, model, source, target):
        """Families whose scores define delta[source, target]
        (reference cache_score_operation, operators.cpp:71-98).
        Returns (kind, [families]) where each family is (var, parents)."""
        parents_t = model.parents(target)
        if model.has_arc(source, target):
            pa = [p for p in parents_t if p != source]
            return "remove", [(target, pa)]
        elif source in self._tpos and model.has_arc(target, source):
            pa_s = [p for p in model.parents(source) if p != target]
            pa_t = parents_t + [source]
            return "flip", [(source, pa_s), (target, pa_t)]
        else:
            return "add", [(target, parents_t + [source])]

    def cache_scores(self, model, score) -> None:
        if not score.compatible_bn(model):
            raise ValueError("BayesianNetwork is not compatible with the score.")
        self._initialize_local_cache(model)
        if self._owns_local_cache:
            self._local_cache.cache_local_scores(model, score)
        self._update_valid_ops(model)
        self._recompute_cells(
            model,
            score,
            [
                (si, ti)
                for si in range(len(self._sources))
                for ti in range(len(self._targets))
                if self.valid_op[si, ti]
            ],
        )

    def _recompute_cells(self, model, score, cells) -> None:
        """Batch-evaluate the families needed by the given (si, ti) cells and
        fill the delta matrix — the single-device-call hot path. Works in
        graph-index space (adjacency-set membership, cached parent-name
        lists per target) instead of per-cell name-based model calls: the
        hc inner loop touches thousands of cells per run and the reference
        does this walk in C++ (operators.cpp:100-180)."""
        count("hc.operator_cells", len(cells))
        with span("pb.hc.cells"):
            self._rescore_cells(model, score, cells)

    def _rescore_cells(self, model, score, cells) -> None:
        from ...models.base import BayesianNetworkType

        bn_type = model.type()
        # the base-class arc policy allows everything — skip the per-cell
        # double call in that (overwhelmingly common) case
        generic_arcs = (
            type(bn_type).can_have_arc is BayesianNetworkType.can_have_arc
        )
        g = model._graph
        gnodes = g._nodes
        gind = g._indices
        family_index: dict[tuple, int] = {}
        families: list[tuple] = []
        cell_plans = []
        pnames_cache: dict[int, list] = {}  # target graph idx -> parent names

        def pnames(idx):
            out = pnames_cache.get(idx)
            if out is None:
                out = [gnodes[p].name for p in gnodes[idx].parents]
                pnames_cache[idx] = out
            return out

        sources = self._sources
        targets = self._targets
        tpos = self._tpos
        for (si, ti) in cells:
            source, target = sources[si], targets[ti]
            if not generic_arcs and not bn_type.can_have_arc(
                model, source, target
            ):
                # keep -inf
                cell_plans.append(None)
                continue
            s_idx = gind[source]
            t_idx = gind[target]
            parents_t = gnodes[t_idx].parents
            if s_idx in parents_t:
                kind = "remove"
                fams = [(target, [p for p in pnames(t_idx) if p != source])]
            elif source in tpos and t_idx in gnodes[s_idx].parents:
                kind = "flip"
                fams = [
                    (source, [p for p in pnames(s_idx) if p != target]),
                    (target, pnames(t_idx) + [source]),
                ]
            else:
                kind = "add"
                fams = [(target, pnames(t_idx) + [source])]
            idxs = []
            for fam in fams:
                key = (fam[0], frozenset(fam[1]))
                fi = family_index.get(key)
                if fi is None:
                    fi = family_index[key] = len(families)
                    families.append(fam)
                idxs.append(fi)
            cell_plans.append((si, ti, source, target, kind, idxs))

        if not families:
            return
        values = score.local_score_batch(model, families)
        lc = self._local_cache._scores
        delta, flip = self.delta, self._flip
        for plan in cell_plans:
            if plan is None:
                continue
            si, ti, source, target, kind, idxs = plan
            cached_t = lc[target]
            if kind == "flip":
                d = values[idxs[0]] + values[idxs[1]] - lc[source] - cached_t
            else:
                d = values[idxs[0]] - cached_t
            delta[si, ti] = _quantize(d)
            flip[si, ti] = kind == "flip"

    # ----------------------------------------------------------- find max
    def find_max(self, model, tabu: OperatorTabuSet | None = None):
        conditional = isinstance(model, ConditionalBayesianNetwork)
        add_legal = None
        if not conditional:
            # one native transitive closure amortizes every candidate's
            # acyclicity check (vs per-candidate has_path BFS,
            # reference operators.hpp:488-560)
            from ...graph.closure import add_arc_legality

            add_legal = add_arc_legality(model.graph().adjacency_matrix())
        flat = self.delta.ravel()
        order = np.argsort(-flat, kind="stable")
        nt = len(self._targets)
        for flat_idx in order:
            si, ti = divmod(int(flat_idx), nt)
            if not self.valid_op[si, ti]:
                continue
            d = self.delta[si, ti]
            if not np.isfinite(d):
                break  # deltas are sorted: everything after is -inf too
            source, target = self._sources[si], self._targets[ti]
            op = self._op_for_pair(
                model, source, target, d, conditional, add_legal, si, ti
            )
            if op is None:
                continue
            if tabu is not None and op in tabu:
                continue
            return op
        return None

    def _op_for_pair(self, model, source, target, d, conditional,
                     add_legal=None, si=None, ti=None):
        if model.has_arc(source, target):
            return RemoveArc(source, target, d)
        if conditional and model.is_interface(source):
            if self._max_indegree > 0 and model.num_parents(target) >= self._max_indegree:
                return None
            if model.type().can_have_arc(model, source, target):
                return AddArc(source, target, d)
            return None
        if source in self._tpos and model.has_arc(target, source):
            if model.can_flip_arc(target, source):
                if (
                    self._max_indegree > 0
                    and model.num_parents(target) >= self._max_indegree
                ):
                    return None
                return FlipArc(target, source, d)
            return None
        if add_legal is not None:
            can_add = bool(add_legal[si, ti]) and model.type().can_have_arc(
                model, source, target
            )
        else:
            can_add = model.can_add_arc(source, target)
        if can_add:
            if (
                self._max_indegree > 0
                and model.num_parents(target) >= self._max_indegree
            ):
                return None
            return AddArc(source, target, d)
        return None

    # ------------------------------------------------------------- update
    def update_scores(self, model, score, changed_nodes) -> None:
        if self._local_cache is None:
            raise RuntimeError("cache_scores() not called before update_scores()")
        if self._owns_local_cache:
            fams = [(n, model.parents(n)) for n in changed_nodes]
            values = score.local_score_batch(model, fams)
            for n, v in zip(changed_nodes, values):
                self._local_cache._scores[n] = float(v)
        cells = []
        for n in changed_nodes:
            if n not in self._tpos:
                continue
            ti = self._tpos[n]
            for si in range(len(self._sources)):
                if self.valid_op[si, ti]:
                    cells.append((si, ti))
            # the flip deltas stored at (n, other) also involve n's column,
            # and one whose arc other -> n is gone (removed: only n
            # changed) is an add cell now
            if n in self._spos:
                si_n = self._spos[n]
                for other in self._targets:
                    ti_o = self._tpos[other]
                    if self.valid_op[si_n, ti_o] and (
                        model.has_arc(n, other) or model.has_arc(other, n)
                        or self._flip[si_n, ti_o]
                    ):
                        cells.append((si_n, ti_o))
        cells = list(dict.fromkeys(cells))
        self._recompute_cells(model, score, cells)


class ChangeNodeTypeSet(OperatorSet):
    """Node-type change candidates for heterogeneous networks
    (reference operators.cpp:439-555)."""

    def __init__(self, type_whitelist=None):
        super().__init__()
        self.set_type_whitelist(type_whitelist)
        self._deltas: dict[str, list[tuple[FactorType, float]]] = {}

    def cache_scores(self, model, score) -> None:
        if model.type().is_homogeneous():
            raise ValueError(
                "ChangeNodeTypeSet can only be used with non-homogeneous "
                "Bayesian networks."
            )
        self._initialize_local_cache(model)
        if self._owns_local_cache:
            self._local_cache.cache_local_scores(model, score)
        self._recompute_nodes(model, score, model.nodes())

    def _allowed(self, node, alt) -> bool:
        for (bn, bt) in self._type_blacklist:
            if bn == node and bt == alt:
                return False
        for (wn, wt) in self._type_whitelist:
            if wn == node:
                return False  # whitelisted node type is frozen
        return True

    def _recompute_nodes(self, model, score, nodes) -> None:
        count("hc.operator_cells", len(nodes))
        with span("pb.hc.cells"):
            self._rescore_nodes(model, score, nodes)

    def _rescore_nodes(self, model, score, nodes) -> None:
        families = []
        plans = []
        for n in nodes:
            alts = model.type().alternative_node_type(model, n)
            entries = []
            for alt in alts:
                if not self._allowed(n, alt):
                    continue
                if not model.type().compatible_node_type(model, n, alt):
                    continue
                entries.append((alt, len(families)))
                families.append((n, model.parents(n), alt))
            plans.append((n, entries))
        if not families:
            for n, _ in plans:
                self._deltas[n] = []
            return
        values = score.local_score_batch(model, families)
        for n, entries in plans:
            cached = self._local_cache.local_score(model, n)
            self._deltas[n] = [
                (alt, _quantize(float(values[i]) - cached))
                for alt, i in entries
            ]

    def find_max(self, model, tabu: OperatorTabuSet | None = None):
        best = None
        for n, entries in self._deltas.items():
            for alt, d in entries:
                op = ChangeNodeType(n, alt, d)
                if tabu is not None and op in tabu:
                    continue
                if best is None or d > best.delta():
                    best = op
        return best

    def update_scores(self, model, score, changed_nodes) -> None:
        if self._local_cache is None:
            raise RuntimeError("cache_scores() not called before update_scores()")
        if self._owns_local_cache:
            fams = [(n, model.parents(n)) for n in changed_nodes]
            values = score.local_score_batch(model, fams)
            for n, v in zip(changed_nodes, values):
                self._local_cache._scores[n] = float(v)
        self._recompute_nodes(model, score, changed_nodes)


class OperatorPool(OperatorSet):
    """Max over member sets sharing one score cache
    (reference operators.hpp:751-906)."""

    def __init__(self, op_sets):
        super().__init__()
        if not op_sets:
            raise ValueError("op_sets cannot be empty")
        self._op_sets = list(op_sets)

    def set_arc_blacklist(self, blacklist) -> None:
        super().set_arc_blacklist(blacklist)
        for s in getattr(self, "_op_sets", []):
            s.set_arc_blacklist(blacklist)

    def set_arc_whitelist(self, whitelist) -> None:
        super().set_arc_whitelist(whitelist)
        for s in getattr(self, "_op_sets", []):
            s.set_arc_whitelist(whitelist)

    def set_type_blacklist(self, blacklist) -> None:
        super().set_type_blacklist(blacklist)
        for s in getattr(self, "_op_sets", []):
            s.set_type_blacklist(blacklist)

    def set_type_whitelist(self, whitelist) -> None:
        super().set_type_whitelist(whitelist)
        for s in getattr(self, "_op_sets", []):
            s.set_type_whitelist(whitelist)

    def set_max_indegree(self, max_indegree) -> None:
        super().set_max_indegree(max_indegree)
        for s in getattr(self, "_op_sets", []):
            s.set_max_indegree(max_indegree)

    def cache_scores(self, model, score) -> None:
        self._initialize_local_cache(model)
        if self._owns_local_cache:
            self._local_cache.cache_local_scores(model, score)
        for s in self._op_sets:
            s.set_local_cache(self._local_cache)
            s.cache_scores(model, score)

    def find_max(self, model, tabu: OperatorTabuSet | None = None):
        best = None
        for s in self._op_sets:
            op = s.find_max(model) if tabu is None else s.find_max_tabu(model, tabu)
            if op is not None and (best is None or op.delta() > best.delta()):
                best = op
        return best

    def update_scores(self, model, score, changed_nodes) -> None:
        if self._owns_local_cache:
            fams = [(n, model.parents(n)) for n in changed_nodes]
            values = score.local_score_batch(model, fams)
            for n, v in zip(changed_nodes, values):
                self._local_cache._scores[n] = float(v)
        for s in self._op_sets:
            s.update_scores(model, score, changed_nodes)

    def finished(self) -> None:
        for s in self._op_sets:
            s.finished()
        super().finished()
