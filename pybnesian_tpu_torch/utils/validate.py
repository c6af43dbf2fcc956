"""Arc/edge/type restriction validation (reference
util/validate_whitelists.hpp:72-227): cross-checks black/whitelists against
each other and the graph, producing a consistent restriction set that the
structure-learning algorithms (PC, MMPC/MMHC, hill-climbing operator sets)
apply uniformly.

Normalization rules (validate_whitelists.hpp:83-150, matched exactly):

- every restricted node must exist in the graph (arc sources / edge
  endpoints may be joint nodes of a conditional graph);
- edge in both edge blacklist and edge whitelist -> raise;
- arc whitelisted while its edge is blacklisted -> raise;
- edge whitelist + arc whitelist -> arc whitelist wins;
- arc in both arc blacklist and arc whitelist -> raise;
- edge whitelist + arc blacklist -> arc whitelist in the OPPOSITE direction;
- edge blacklist + arc blacklist -> edge blacklist (arc entry dropped);
- arc blacklisted in BOTH directions -> edge blacklist.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "ListRestrictions",
    "validate_restrictions",
    "validate_arc_restrictions",
    "validate_type_restrictions",
]


@dataclasses.dataclass
class ListRestrictions:
    """Normalized restriction set. Arcs are (source, target) tuples; edges
    are frozensets {a, b} (reference ArcSet / EdgeSet)."""

    arc_blacklist: set
    arc_whitelist: set
    edge_blacklist: set
    edge_whitelist: set


def _contains_source(graph, name: str) -> bool:
    # arc sources / edge endpoints may be interface nodes of a conditional
    # graph (check_arc_list conditional overload, validate_whitelists.hpp:33)
    if hasattr(graph, "contains_joint_node"):
        return graph.contains_joint_node(name)
    return graph.contains_node(name)


def _check_arc_list(graph, arcs, kind: str) -> None:
    for (s, t) in arcs:
        if not _contains_source(graph, s):
            raise ValueError(
                f"Node '{s}' in {kind} not present in the graph."
            )
        if not graph.contains_node(t):
            raise ValueError(
                f"Node '{t}' in {kind} not present in the graph."
            )
        if s == t:
            raise ValueError(f"Self-loop restriction ({s}, {t}) is invalid")


def _check_edge_list(graph, edges, kind: str) -> None:
    for e in edges:
        a, b = e
        for n in (a, b):
            if not _contains_source(graph, n):
                raise ValueError(
                    f"Node '{n}' in {kind} not present in the graph."
                )
        if a == b:
            raise ValueError(f"Self-loop restriction ({a}, {b}) is invalid")


def validate_arc_restrictions(graph, arc_blacklist=None,
                              arc_whitelist=None) -> ListRestrictions:
    """Arc-only variant used by score-based search
    (validate_whitelists.hpp:155-180): node checks plus the
    blacklist-and-whitelist conflict."""
    arc_blacklist = [tuple(a) for a in (arc_blacklist or [])]
    arc_whitelist = [tuple(a) for a in (arc_whitelist or [])]
    _check_arc_list(graph, arc_blacklist, "arc blacklist")
    _check_arc_list(graph, arc_whitelist, "arc whitelist")

    wl = set(arc_whitelist)
    bl = set()
    for arc in arc_blacklist:
        if arc in wl:
            raise ValueError(
                f"Arc {arc[0]} -> {arc[1]} in blacklist and whitelist"
            )
        bl.add(arc)
    return ListRestrictions(bl, wl, set(), set())


def validate_restrictions(graph, arc_blacklist=None, arc_whitelist=None,
                          edge_blacklist=None,
                          edge_whitelist=None) -> ListRestrictions:
    """Full 4-list normalization (validate_whitelists.hpp:72-150)."""
    arc_blacklist = [tuple(a) for a in (arc_blacklist or [])]
    arc_whitelist = [tuple(a) for a in (arc_whitelist or [])]
    edge_blacklist = [tuple(e) for e in (edge_blacklist or [])]
    edge_whitelist = [tuple(e) for e in (edge_whitelist or [])]
    _check_arc_list(graph, arc_blacklist, "arc blacklist")
    _check_arc_list(graph, arc_whitelist, "arc whitelist")
    _check_edge_list(graph, edge_blacklist, "edge blacklist")
    _check_edge_list(graph, edge_whitelist, "edge whitelist")

    r = ListRestrictions(set(), set(), set(), set())

    for e in edge_blacklist:
        r.edge_blacklist.add(frozenset(e))

    for e in edge_whitelist:
        fe = frozenset(e)
        if fe in r.edge_blacklist:
            raise ValueError(
                f"Edge {e[0]} -- {e[1]} in blacklist and whitelist"
            )
        r.edge_whitelist.add(fe)

    for (s, t) in arc_whitelist:
        fe = frozenset((s, t))
        if fe in r.edge_blacklist:
            raise ValueError(
                f"Edge blacklist {s} -- {t} is incompatible with arc "
                f"whitelist {s} -> {t}"
            )
        # edge whitelist + arc whitelist -> arc whitelist wins
        r.edge_whitelist.discard(fe)
        r.arc_whitelist.add((s, t))

    for (s, t) in arc_blacklist:
        if (s, t) in r.arc_whitelist:
            raise ValueError(f"Arc {s} -> {t} in blacklist and whitelist")
        fe = frozenset((s, t))
        # edge whitelist + arc blacklist -> opposite-direction arc whitelist
        if fe in r.edge_whitelist:
            r.arc_whitelist.add((t, s))
            r.edge_whitelist.discard(fe)
        # edge blacklist + arc blacklist -> edge blacklist (drop the arc)
        if fe not in r.edge_blacklist:
            r.arc_blacklist.add((s, t))

    # arc blacklisted in both directions -> edge blacklist
    for (s, t) in list(r.arc_blacklist):
        if (t, s) in r.arc_blacklist and (s, t) in r.arc_blacklist:
            r.edge_blacklist.add(frozenset((s, t)))
            r.arc_blacklist.discard((s, t))
            r.arc_blacklist.discard((t, s))

    return r


def validate_type_restrictions(graph, type_blacklist=None,
                               type_whitelist=None) -> None:
    """Node-type restriction cross-check
    (validate_whitelists.hpp:186-227). Lists are [(node, FactorType)]."""
    type_blacklist = list(type_blacklist or [])
    type_whitelist = list(type_whitelist or [])

    if not type_blacklist or not type_whitelist:
        non_empty = type_whitelist if not type_blacklist else type_blacklist
        name_list = "whitelist" if not type_blacklist else "blacklist"
        for name, _ in non_empty:
            if not graph.contains_node(name):
                raise ValueError(
                    f"Node in the {name_list} ({name}), not present in the "
                    "model."
                )
        return

    whitelist_set = {}
    for name, ftype in type_whitelist:
        if not graph.contains_node(name):
            raise ValueError(
                f"Node in the whitelist ({name}), not present in the model."
            )
        prev = whitelist_set.setdefault(name, ftype)
        if prev != ftype:
            raise ValueError(
                f"Node {name} has two FactorType in the whitelist: "
                f"{prev.ToString()} and {ftype.ToString()}."
            )

    for name, ftype in type_blacklist:
        if not graph.contains_node(name):
            raise ValueError(
                f"Node in the blacklist ({name}), not present in the model."
            )
        if name in whitelist_set and whitelist_set[name] == ftype:
            raise ValueError(
                f"Node {name} has a FactorType {ftype.ToString()} in "
                "blacklist and whitelist."
            )
