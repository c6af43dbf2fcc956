"""PC-stable constraint-based structure learning + Meek rules.

Rebuild of reference learning/algorithms/pc.{hpp,cpp} and constraint.hpp:
skeleton discovery with sepset orders 0/1/≥2 (pc.cpp:33-263), v-structure
orientation with three policies — sepset-based, ambiguous-vote with
``ambiguous_threshold`` (default 0.5), optional bidirected arcs
(constraint.hpp:296-389) — and Meek rules 1-3 to fixpoint
(constraint.hpp:391-511).

Copied from ``pybnesian_tpu/learning/algorithms/pc.py``.
"""

from __future__ import annotations

import itertools

import numpy as np

from ...graph import ConditionalPartiallyDirectedGraph, PartiallyDirectedGraph
from ...utils import Combinations2Sets

__all__ = ["PC", "MeekRules", "SepSet"]


class SepSet:
    """Separating sets discovered during skeleton search
    (reference constraint.hpp SepSet)."""

    def __init__(self):
        self._map = {}

    def insert(self, edge, sepset, pvalue) -> None:
        self._map[frozenset(edge)] = (set(sepset), pvalue)

    def sepset(self, edge):
        key = frozenset(edge)
        if key not in self._map:
            raise KeyError(f"Edge {tuple(edge)} not found in sepset")
        return self._map[key]

    def __contains__(self, edge) -> bool:
        return frozenset(edge) in self._map


# ============================================================== Meek rules
class MeekRules:
    """(reference constraint.hpp:391-511)."""

    @staticmethod
    def rule1(pdag) -> bool:
        """a -> b — c  with a not adjacent to c  ⇒  b -> c."""

        def find_new(to_check):
            new_arcs = []
            for (a, b) in to_check:
                for c in pdag.neighbors(b):
                    if not pdag.has_connection(a, c):
                        new_arcs.append((b, c))
            return new_arcs

        new_arcs = find_new(pdag.arcs())
        for (s, t) in new_arcs:
            pdag.direct(s, t)
        changed = bool(new_arcs)
        to_check = new_arcs
        while to_check:
            new_arcs = find_new(to_check)
            for (s, t) in new_arcs:
                pdag.direct(s, t)
            to_check = new_arcs
        return changed

    @staticmethod
    def rule2(pdag) -> bool:
        """a — b with a directed path a -> c -> b  ⇒  a -> b."""
        new_arcs = []
        for (u, v) in pdag.edges():
            children_u = set(pdag.children(u))
            parents_v = set(pdag.parents(v))
            if children_u & parents_v:
                new_arcs.append((u, v))
                continue
            parents_u = set(pdag.parents(u))
            children_v = set(pdag.children(v))
            if parents_u & children_v:
                new_arcs.append((v, u))
        for (s, t) in new_arcs:
            pdag.direct(s, t)
        return bool(new_arcs)

    @staticmethod
    def rule3(pdag) -> bool:
        """b — a, b — c1, b — c2, c1 -> a, c2 -> a, c1 /~ c2  ⇒  b -> a."""
        changed = False
        for a in list(pdag.nodes()):
            parents = set(pdag.parents(a))
            nbr = pdag.neighbors(a)
            if len(parents) < 2 or not nbr:
                continue
            new_arcs = []
            for b in nbr:
                inter = set(pdag.neighbors(b)) & parents
                if len(inter) >= 2:
                    for c1, c2 in itertools.combinations(sorted(inter), 2):
                        if not pdag.has_connection(c1, c2):
                            new_arcs.append((b, a))
            for (s, t) in new_arcs:
                pdag.direct(s, t)
            changed |= bool(new_arcs)
        return changed

    @staticmethod
    def all_rules_sequential_interactive(pdag) -> None:
        changed = True
        while changed:
            changed = False
            changed |= MeekRules.rule1(pdag)
            changed |= MeekRules.rule2(pdag)
            changed |= MeekRules.rule3(pdag)


# =========================================================== skeleton search
def _adjacent_pool(g, node, exclude=None):
    pool = set(g.neighbors(node)) | set(g.parents(node))
    pool.discard(node)
    if exclude is not None:
        pool.discard(exclude)
    return pool


# Upper bound on tests evaluated per batch call at the PC level; batch-aware
# tests (RCoT) sub-chunk internally to fit device memory.
_PC_BATCH = 2048


def _batch_eval(test, triples):
    """One batched p-value evaluation, serial fallback for duck-typed tests
    that only expose ``pvalue``."""
    fn = getattr(test, "pvalue_batch", None)
    if fn is not None:
        return np.asarray(fn(triples), dtype=np.float64)
    return np.array(
        [test.pvalue(x, y, *zs) for (x, y, zs) in triples], dtype=np.float64
    )


def _has_real_batch(test) -> bool:
    """True when the test carries an actual batched kernel. Serial tests
    (base-class or duck-typed ``pvalue``-only) should be driven one
    candidate per edge per round, so the round-robin batcher performs
    EXACTLY the serial early-exit evaluation count."""
    from ..independences.base import IndependenceTest

    fn = getattr(type(test), "pvalue_batch", None)
    return fn is not None and fn is not IndependenceTest.pvalue_batch


def _batched_sepset_search(edge_iters, test, alpha, bar=None):
    """Round-robin batched early-exit search.

    ``edge_iters`` maps each edge to an iterator over its candidate sepsets
    (tuples), in the exact order the serial algorithm would try them. Each
    round, every still-active edge contributes its next few candidates; the
    whole round is evaluated in ONE ``pvalue_batch`` call. An edge resolves
    on the FIRST candidate (in its own order) whose p-value exceeds alpha —
    identical results to the serial loop, with the per-test dispatch cost
    amortised across every open edge of the sweep (the batched redesign of
    reference pc.cpp:92-263's per-test loop).
    """
    active = dict(edge_iters)  # insertion-ordered
    resolved = {}
    # batch-kernel tests amortise dispatch, so probe several candidates per
    # edge per round (doubling); serial tests stay at 1 per round so every
    # edge performs exactly the serial early-exit evaluation count
    batch_test = _has_real_batch(test)
    ramp = 8 if batch_test else 1
    while active:
        per_edge = max(1, min(ramp, _PC_BATCH // len(active)))
        if batch_test:
            ramp *= 2
        triples = []
        owners = []  # aligned: (edge, candidate)
        dry = set()
        for edge, it in active.items():
            took = 0
            for cand in it:
                triples.append((edge[0], edge[1], tuple(cand)))
                owners.append((edge, cand))
                took += 1
                if took >= per_edge:
                    break
            if took < per_edge:
                dry.add(edge)
        if not triples:
            for edge in active:
                if bar is not None:
                    bar.tick()
            break
        pvals = _batch_eval(test, triples)
        decided = set()
        for (edge, cand), p in zip(owners, pvals):
            if edge in decided or edge in resolved:
                continue
            if p > alpha:
                resolved[edge] = (set(cand), float(p))
                decided.add(edge)
        for edge in decided | dry:
            if active.pop(edge, None) is not None and bar is not None:
                bar.tick()
    return resolved


def _batched_assoc_sweep(edge_iters, test, alpha, init):
    """Round-robin batched MAX-p-value sweep with early exit past alpha.

    ``edge_iters`` maps (x, y) pairs to iterators over candidate sepsets in
    serial order; ``init`` holds each pair's starting value. Returns each
    pair's running max p-value, where a pair stops contributing once its
    value exceeds alpha — the batched form of MMPC's ``update_min_assoc``
    loop (reference mmpc.cpp:511-556): pairs that never exceed alpha get
    their EXACT maximum over all candidates, pairs that do are dropped
    downstream so their early-stopped value is equivalent.
    """
    vals = dict(init)
    active = {e: it for e, it in edge_iters.items() if vals[e] <= alpha}
    batch_test = _has_real_batch(test)  # see _batched_sepset_search
    ramp = 8 if batch_test else 1
    while active:
        per_edge = max(1, min(ramp, _PC_BATCH // len(active)))
        if batch_test:
            ramp *= 2
        triples = []
        owners = []
        dry = set()
        for edge, it in active.items():
            took = 0
            for cand in it:
                triples.append((edge[0], edge[1], tuple(cand)))
                owners.append(edge)
                took += 1
                if took >= per_edge:
                    break
            if took < per_edge:
                dry.add(edge)
        if not triples:
            break
        pvals = _batch_eval(test, triples)
        stopped = set()
        for edge, p in zip(owners, pvals):
            if edge in stopped:
                continue
            if p > vals[edge]:
                vals[edge] = p
            if vals[edge] > alpha:
                stopped.add(edge)
        for e in stopped | dry:
            active.pop(e, None)
    return vals


def _find_skeleton(g, test, alpha, edge_whitelist, sepset: SepSet,
                   verbose: int = 0):
    """(reference pc.cpp:222-263). Candidate sweeps are evaluated through
    ``pvalue_batch`` so device-backed tests fuse each order's surviving
    tests into a handful of launches."""
    from ...utils.progress import progress_bar

    wl = {frozenset(e) for e in edge_whitelist}
    bar = progress_bar(verbose)

    # order 0 (pc.cpp:33-90)
    cand0 = [
        (u, v) for (u, v) in g.edges() if frozenset((u, v)) not in wl
    ]
    bar.set_text("No. sepset 0")
    bar.set_max_progress(len(cand0))
    for start in range(0, len(cand0), _PC_BATCH):
        chunk = cand0[start:start + _PC_BATCH]
        pvals = _batch_eval(test, [(u, v, ()) for (u, v) in chunk])
        for (u, v), p in zip(chunk, pvals):
            if p > alpha:
                g.remove_edge(u, v)
                sepset.insert((u, v), set(), float(p))
            bar.tick()

    def max_cardinality(limit):
        return all(
            len(_adjacent_pool(g, n)) <= limit for n in g.nodes()
        )

    if g.num_edges() == len(wl) or max_cardinality(1):
        bar.mark_as_completed("Finished PC skeleton")
        return sepset

    # order 1 (pc.cpp:92-144): pools are frozen for the whole order
    # (PC-stable), so every edge's candidate list is fixed up front.
    iters = {}
    for (u, v) in g.edges():
        if frozenset((u, v)) in wl:
            continue
        pool = sorted((_adjacent_pool(g, u) | _adjacent_pool(g, v)) - {u, v})
        iters[(u, v)] = iter([(c,) for c in pool])
    bar.set_text("No. sepset 1")
    bar.set_max_progress(len(iters))
    bar.set_progress(0)
    resolved = _batched_sepset_search(iters, test, alpha, bar)
    for (u, v), (s, p) in resolved.items():
        g.remove_edge(u, v)
        sepset.insert((u, v), s, p)

    # order >= 2 (pc.cpp:148-263)
    limit = 2
    while g.num_edges() > len(wl) and not max_cardinality(limit):
        iters = {}
        for (u, v) in g.edges():
            if frozenset((u, v)) in wl:
                continue
            comb = _multivariate_candidates(g, (u, v), limit)
            if comb is not None:
                iters[(u, v)] = iter(comb)
        bar.set_text(f"No. sepset {limit}")
        bar.set_max_progress(len(iters))
        bar.set_progress(0)
        resolved = _batched_sepset_search(iters, test, alpha, bar)
        for (u, v), (s, p) in resolved.items():
            g.remove_edge(u, v)
            sepset.insert((u, v), s, p)
        limit += 1
    bar.mark_as_completed("Finished PC skeleton")
    return sepset


def _multivariate_candidates(g, edge, sep_size):
    """Candidate sepsets of size ``sep_size`` for ``edge``, in serial order,
    or None if neither endpoint's neighbourhood is large enough
    (reference pc.cpp:169-186: validity is checked against the FULL
    neighbourhood including the other endpoint, the candidate list
    excludes it)."""
    u, v = edge
    set1_valid = len(_adjacent_pool(g, u)) > sep_size
    set2_valid = len(_adjacent_pool(g, v)) > sep_size
    if not set1_valid and not set2_valid:
        return None
    pool1 = sorted(_adjacent_pool(g, u, exclude=v))
    pool2 = sorted(_adjacent_pool(g, v, exclude=u))
    if set1_valid and set2_valid:
        return Combinations2Sets(pool1, pool2, sep_size)
    if set1_valid:
        return itertools.combinations(pool1, sep_size)
    return itertools.combinations(pool2, sep_size)


# ============================================================= v-structures
def _is_unambiguous_vstructure(g, p1, p2, child, test, alpha,
                               ambiguous_threshold):
    """(reference constraint.hpp is_unambiguous_vstructure). The sepset
    vote enumerates EVERY candidate anyway (no early exit except the
    threshold-0 per-size check), so each size's candidates go through one
    ``pvalue_batch`` call."""
    pool1 = _adjacent_pool(g, p1)
    pool2 = _adjacent_pool(g, p2)
    max_sepset = max(len(pool1), len(pool2))

    # marginal + univariate candidates in one batch
    # (constraint.hpp count_univariate_sepsets)
    possible = sorted((pool1 | pool2) - {child, p1, p2})
    triples = [(p1, p2, ()), (p1, p2, (child,))]
    triples += [(p1, p2, (sp,)) for sp in possible]
    pvals = _batch_eval(test, triples)
    indep_sepsets = int(np.sum(pvals > alpha))
    children_in_sepsets = int(pvals[1] > alpha)

    if ambiguous_threshold == 0 and children_in_sepsets > 0:
        return False

    if max_sepset >= 2:
        u1 = sorted(pool1) if len(pool1) >= 2 else []
        u2 = sorted(pool2) if len(pool2) >= 2 else []
        for size in range(2, max_sepset + 1):
            s1 = len(u1) >= size
            s2 = len(u2) >= size
            if s1 and s2:
                comb = Combinations2Sets(u1, u2, size)
            elif s1:
                comb = itertools.combinations(u1, size)
            elif s2:
                comb = itertools.combinations(u2, size)
            else:
                continue
            comb_it = iter(comb)
            while True:
                chunk = [
                    tuple(s)
                    for s in itertools.islice(comb_it, _PC_BATCH)
                ]
                if not chunk:
                    break
                pvals = _batch_eval(
                    test, [(p1, p2, s) for s in chunk]
                )
                for s, p in zip(chunk, pvals):
                    if p > alpha:
                        indep_sepsets += 1
                        if child in s:
                            children_in_sepsets += 1
            if ambiguous_threshold == 0 and children_in_sepsets > 0:
                return False

    if indep_sepsets > 0:
        ratio = children_in_sepsets / indep_sepsets
        return ratio < ambiguous_threshold or ratio == 0
    return False


def _is_vstructure(g, p1, p2, child, test, alpha, sepset, use_sepsets,
                   ambiguous_threshold):
    if g.has_connection(p1, p2):
        return False
    if use_sepsets and sepset is not None and (p1, p2) in sepset:
        s, _ = sepset.sepset((p1, p2))
        return child not in s
    if use_sepsets:
        return _is_unambiguous_vstructure(g, p1, p2, child, test, alpha, 0)
    return _is_unambiguous_vstructure(
        g, p1, p2, child, test, alpha, ambiguous_threshold
    )


def _direct_unshielded_triples(g, test, arc_blacklist, arc_whitelist, alpha,
                               sepset, use_sepsets, ambiguous_threshold,
                               allow_bidirected):
    """(reference constraint.hpp:296-353)."""
    vs = []
    for node in g.nodes():
        nbr = g.neighbors(node)
        parents = g.parents(node)
        if len(nbr) < 1 or len(nbr) + len(parents) < 2:
            continue
        found_here = []
        for p1, p2 in itertools.combinations(sorted(nbr), 2):
            if _is_vstructure(g, p1, p2, node, test, alpha, sepset,
                              use_sepsets, ambiguous_threshold):
                found_here.append((p1, p2, node))
        used = {p for (p1, p2, _) in found_here for p in (p1, p2)}
        remaining = [n for n in nbr if n not in used]
        for neighbor in remaining:
            for parent in parents:
                if _is_vstructure(g, neighbor, parent, node, test, alpha,
                                  sepset, use_sepsets, ambiguous_threshold):
                    found_here.append((neighbor, parent, node))
        vs.extend(found_here)

    bl = set(arc_blacklist)
    wlset = set(arc_whitelist)
    for (p1, p2, child) in vs:
        if (p1, child) in bl or (p2, child) in bl:
            continue
        if not allow_bidirected:
            if (
                g.has_arc(child, p1) and (child, p1) in wlset
            ) or (g.has_arc(child, p2) and (child, p2) in wlset):
                continue
        g.direct(p1, child)
        g.direct(p2, child)
        if not allow_bidirected:
            if g.has_arc(child, p1):
                g.remove_arc(child, p1)
            if g.has_arc(child, p2):
                g.remove_arc(child, p2)


# ===================================================================== PC
class PC:
    """(reference pc.hpp:13, pc.cpp:340-428)."""

    def estimate(
        self,
        hypot_test,
        nodes=None,
        arc_blacklist=None,
        arc_whitelist=None,
        edge_blacklist=None,
        edge_whitelist=None,
        alpha: float = 0.05,
        use_sepsets: bool = False,
        ambiguous_threshold: float = 0.5,
        allow_bidirected: bool = True,
        verbose: int = 0,
    ) -> PartiallyDirectedGraph:
        if nodes is None:
            nodes = hypot_test.variable_names()
        if not hypot_test.has_variables(nodes):
            raise ValueError("Test does not contain all the variables")
        skeleton = PartiallyDirectedGraph.CompleteUndirected(nodes)
        return self._estimate_impl(
            skeleton, hypot_test, arc_blacklist, arc_whitelist,
            edge_blacklist, edge_whitelist, alpha, use_sepsets,
            ambiguous_threshold, allow_bidirected, verbose,
        )

    def estimate_conditional(
        self,
        hypot_test,
        nodes,
        interface_nodes=None,
        arc_blacklist=None,
        arc_whitelist=None,
        edge_blacklist=None,
        edge_whitelist=None,
        alpha: float = 0.05,
        use_sepsets: bool = False,
        ambiguous_threshold: float = 0.5,
        allow_bidirected: bool = True,
        verbose: int = 0,
    ) -> ConditionalPartiallyDirectedGraph:
        interface_nodes = list(interface_nodes or [])
        if not interface_nodes:
            return self.estimate(
                hypot_test, nodes, arc_blacklist, arc_whitelist,
                edge_blacklist, edge_whitelist, alpha, use_sepsets,
                ambiguous_threshold, allow_bidirected, verbose,
            )
        skeleton = ConditionalPartiallyDirectedGraph(nodes, interface_nodes)
        # complete: node-node + node-interface edges
        names = list(nodes)
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                skeleton.add_edge(names[i], names[j])
            for itf in interface_nodes:
                skeleton.add_edge(names[i], itf)
        return self._estimate_impl(
            skeleton, hypot_test, arc_blacklist, arc_whitelist,
            edge_blacklist, edge_whitelist, alpha, use_sepsets,
            ambiguous_threshold, allow_bidirected, verbose,
        )

    def _estimate_impl(self, skeleton, test, arc_blacklist, arc_whitelist,
                       edge_blacklist, edge_whitelist, alpha, use_sepsets,
                       ambiguous_threshold, allow_bidirected, verbose=0):
        from ...utils.validate import validate_restrictions

        # normalize + cross-check the lists (reference pc.cpp:277-278):
        # both-direction arc blacklists become edge removals, conflicting
        # white/blacklists raise.
        r = validate_restrictions(
            skeleton, arc_blacklist, arc_whitelist, edge_blacklist,
            edge_whitelist,
        )

        for e in r.edge_blacklist:
            u, v = tuple(e)
            if skeleton.has_edge(u, v):
                skeleton.remove_edge(u, v)
        for (s, t) in r.arc_whitelist:
            skeleton.direct(s, t)
        # a cycle cannot be generated with fewer arcs (pc.cpp:288-297)
        if len(r.arc_whitelist) > 2:
            try:
                skeleton.to_dag()
            except ValueError:
                raise ValueError(
                    "The selected blacklist/whitelist configuration does "
                    "not allow an acyclic graph."
                )

        sepset = SepSet()
        _find_skeleton(skeleton, test, alpha, r.edge_whitelist, sepset,
                       verbose=verbose)

        if hasattr(skeleton, "is_interface"):
            # conditional graphs: interface edges become interface -> node
            # arcs, then blacklisted interface arcs are dropped
            # (pc.cpp:302-305, constraint.hpp remove_interface_arcs_blacklist)
            for (u, v) in list(skeleton.edges()):
                if skeleton.is_interface(u):
                    skeleton.direct(u, v)
                elif skeleton.is_interface(v):
                    skeleton.direct(v, u)
            for (s, t) in r.arc_blacklist:
                if skeleton.has_arc(s, t):
                    skeleton.remove_arc(s, t)

        # blacklisted arcs: direct the other way if an edge remains
        # (constraint.hpp direct_arc_blacklist)
        for (s, t) in r.arc_blacklist:
            if skeleton.has_edge(s, t):
                skeleton.direct(t, s)

        _direct_unshielded_triples(
            skeleton, test, r.arc_blacklist, r.arc_whitelist, alpha, sepset,
            use_sepsets, ambiguous_threshold, allow_bidirected,
        )
        MeekRules.all_rules_sequential_interactive(skeleton)
        return skeleton
