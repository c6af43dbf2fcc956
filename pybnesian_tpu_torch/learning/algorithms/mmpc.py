"""MMPC: max–min parents-and-children constraint-based discovery.

Rebuild of reference learning/algorithms/mmpc.{hpp,cpp}: forward phase
maximizing the minimum association (tracked as the max p-value over evaluated
sepsets, mmpc.cpp:511-556 + update_min_assoc), backward shrink phase
(mmpc.cpp:562-645), symmetry correction, and the same PC-style v-structure +
Meek-rule orientation on the resulting skeleton (mmpc.cpp:1000-1070).

Copied from ``pybnesian_tpu/learning/algorithms/mmpc.py``.
"""

from __future__ import annotations

import itertools

from ...graph import ConditionalPartiallyDirectedGraph, PartiallyDirectedGraph
from .pc import (
    MeekRules,
    _batched_assoc_sweep,
    _batched_sepset_search,
    _direct_unshielded_triples,
)

__all__ = ["MMPC", "mmpc_all_variables"]

_STOP = None


def _subsets_containing(pool, fixed, min_k, max_k):
    rest = [p for p in pool if p != fixed]
    for k in range(min_k - 1, max_k):
        for comb in itertools.combinations(rest, k):
            yield (fixed, *comb)


def _mmpc_variable(test, names, variable, alpha, whitelisted, blacklisted):
    """CPC of one variable (reference mmpc_variable, mmpc.cpp:647-696).

    Every association sweep — the per-round forward updates over all
    candidates' sepsets, and the backward shrink's early-exit subset
    search — evaluates through the batched round-robin helpers, so
    device-backed tests fuse the whole round into a few launches. The
    decisions are identical to the serial loops (see
    :func:`pybnesian_tpu_torch.learning.algorithms.pc._batched_assoc_sweep`).
    """
    cpc = set(whitelisted)
    to_check = {
        n
        for n in names
        if n != variable and n not in cpc and frozenset((variable, n)) not in blacklisted
    }
    min_assoc = {n: 0.0 for n in to_check}

    def evaluate_round(subsets_for):
        """Batch-update min_assoc for every candidate still in play."""
        iters = {
            (variable, cand): iter(subsets_for(cand))
            for cand in sorted(to_check)
        }
        init = {
            (variable, cand): min_assoc[cand] for cand in sorted(to_check)
        }
        vals = _batched_assoc_sweep(iters, test, alpha, init)
        for (_, cand), val in vals.items():
            min_assoc[cand] = val

    if cpc:
        # whitelisted CPC: compute assoc of current CPC for all candidates
        evaluate_round(lambda cand: [()] + [
            s
            for k in range(1, len(cpc) + 1)
            for s in itertools.combinations(sorted(cpc), k)
        ])
    else:
        evaluate_round(lambda cand: [()])

    while to_check:
        # drop candidates that can no longer enter
        to_check = {c for c in to_check if min_assoc[c] <= alpha}
        if not to_check:
            break
        best = min(to_check, key=lambda c: (min_assoc[c], c))
        if min_assoc[best] > alpha:
            break
        cpc.add(best)
        to_check.discard(best)
        last_added = best
        # update candidates with sepsets containing the new CPC member
        evaluate_round(lambda cand: _subsets_containing(
            sorted(cpc), last_added, 1, len(cpc)
        ))
        to_check = {c for c in to_check if min_assoc[c] <= alpha}

    # backward phase (mmpc.cpp:562-645): early-exit subset search per
    # member, batched; cpc mutates between members so the outer loop stays
    # serial (removal order affects later members' subset pools)
    for x in sorted(cpc):
        if x in whitelisted:
            continue
        others = sorted(cpc - {x})
        cands = itertools.chain.from_iterable(
            itertools.combinations(others, k)
            for k in range(0, len(others) + 1)
        )
        resolved = _batched_sepset_search(
            {(variable, x): iter(cands)}, test, alpha
        )
        if resolved:
            cpc.discard(x)
    return cpc


def mmpc_all_variables(test, names, alpha, arc_whitelist=None,
                       edge_blacklist=None, edge_whitelist=None,
                       interface_nodes=(), verbose: int = 0):
    """CPC sets for every variable, symmetry-corrected. ``verbose`` drives
    a per-variable ProgressBar (reference mmpc.cpp:986-1000 +
    util/progress.hpp:116)."""
    from ...utils.progress import progress_bar

    arc_whitelist = [tuple(a) for a in (arc_whitelist or [])]
    edge_whitelist = [tuple(e) for e in (edge_whitelist or [])]
    blacklisted = {frozenset(e) for e in (edge_blacklist or [])}
    white_pairs: dict[str, set] = {n: set() for n in names}
    for (s, t) in arc_whitelist + edge_whitelist:
        white_pairs.setdefault(s, set()).add(t)
        white_pairs.setdefault(t, set()).add(s)
    interface = set(interface_nodes)
    bar = progress_bar(verbose)
    bar.set_text("MMPC")
    bar.set_max_progress(len(names))
    cpcs = {}
    for v in names:
        if v in interface:
            cpcs[v] = set()
            bar.tick()
            continue
        candidates = [n for n in names if n != v]
        cpcs[v] = _mmpc_variable(
            test, names, v, alpha, white_pairs.get(v, set()) & set(candidates),
            blacklisted,
        )
        bar.tick()
    bar.mark_as_completed("Finished MMPC")
    # interface nodes: their cpc = nodes that selected them
    for i in interface:
        cpcs[i] = {v for v in names if i in cpcs.get(v, set())}
    # symmetry correction (reference remove_asymmetries, mmhc.cpp:12-22)
    sym = {v: set() for v in names}
    for v in names:
        for p in cpcs[v]:
            if v in cpcs[p] or p in interface:
                sym[v].add(p)
    return sym


class MMPC:
    """(reference mmpc.hpp:23-38)."""

    def estimate(
        self,
        hypot_test,
        nodes=None,
        arc_blacklist=None,
        arc_whitelist=None,
        edge_blacklist=None,
        edge_whitelist=None,
        alpha: float = 0.05,
        ambiguous_threshold: float = 0.5,
        allow_bidirected: bool = True,
        verbose: int = 0,
    ) -> PartiallyDirectedGraph:
        if not (0 < alpha < 1):
            raise ValueError("alpha must be a number between 0 and 1.")
        if nodes is None:
            nodes = hypot_test.variable_names()
        if not hypot_test.has_variables(nodes):
            raise ValueError(
                "IndependenceTest do not contain all the variables in nodes "
                "list."
            )
        from ...utils.validate import validate_restrictions

        skeleton = PartiallyDirectedGraph(nodes)
        # normalized restrictions (reference mmpc.cpp:1006-1007): conflicting
        # lists raise, both-direction arc blacklists become edge blacklists
        r = validate_restrictions(
            skeleton, arc_blacklist, arc_whitelist, edge_blacklist,
            edge_whitelist,
        )
        for (s, t) in r.arc_whitelist:
            skeleton.add_arc(s, t)
        cpcs = mmpc_all_variables(
            hypot_test, list(nodes), alpha, r.arc_whitelist,
            r.edge_blacklist, r.edge_whitelist, verbose=verbose,
        )
        for v in nodes:
            for p in cpcs[v]:
                if (
                    not skeleton.has_arc(v, p)
                    and not skeleton.has_arc(p, v)
                    and not skeleton.has_edge(v, p)
                ):
                    skeleton.add_edge(v, p)
        for (s, t) in r.arc_blacklist:
            if skeleton.has_edge(s, t):
                skeleton.direct(t, s)
        _direct_unshielded_triples(
            skeleton, hypot_test, r.arc_blacklist, r.arc_whitelist, alpha,
            None, True, ambiguous_threshold, allow_bidirected,
        )
        MeekRules.all_rules_sequential_interactive(skeleton)
        return skeleton

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
        ambiguous_threshold: float = 0.5,
        allow_bidirected: bool = True,
        verbose: int = 0,
    ) -> ConditionalPartiallyDirectedGraph:
        from ...utils.validate import validate_restrictions

        interface_nodes = list(interface_nodes or [])
        skeleton = ConditionalPartiallyDirectedGraph(nodes, interface_nodes)
        r = validate_restrictions(
            skeleton, arc_blacklist, arc_whitelist, edge_blacklist,
            edge_whitelist,
        )
        for (s, t) in r.arc_whitelist:
            skeleton.add_arc(s, t)
        all_names = list(nodes) + interface_nodes
        cpcs = mmpc_all_variables(
            hypot_test, all_names, alpha, r.arc_whitelist, r.edge_blacklist,
            r.edge_whitelist, interface_nodes=interface_nodes,
            verbose=verbose,
        )
        for v in nodes:
            for p in cpcs[v]:
                if skeleton.has_arc(v, p) or skeleton.has_arc(p, v) or (
                    skeleton.has_edge(v, p)
                ):
                    continue
                if p in set(interface_nodes):
                    skeleton.add_arc(p, v)
                else:
                    skeleton.add_edge(v, p)
        for (s, t) in r.arc_blacklist:
            if skeleton.has_edge(s, t):
                skeleton.direct(t, s)
        _direct_unshielded_triples(
            skeleton, hypot_test, r.arc_blacklist, r.arc_whitelist, alpha,
            None, True, ambiguous_threshold, allow_bidirected,
        )
        MeekRules.all_rules_sequential_interactive(skeleton)
        return skeleton
