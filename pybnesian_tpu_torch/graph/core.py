"""Host-side graph layer: directed / undirected / partially-directed / DAG
graphs plus their conditional variants.

Rebuild of reference graph/generic_graph.hpp:397-2343 and graph/graph_types.hpp.
Graphs are pure combinatorics and stay on host (the reference reached the same
conclusion — its graph layer is plain C++ with no device code). Device-side
adjacency/ancestor masks for batched structure search are produced on demand by
:meth:`DirectedGraph.adjacency_matrix`.

Semantics preserved from the reference:

- *Raw* node indices are stable across removals (free-list reuse,
  graph_types.hpp:39); *collapsed* indices are dense with swap-remove order.
- Conditional graphs: arcs may not point **into** interface nodes
  (generic_graph.hpp:928-934); edges may not join two interface nodes (:941).
- Conditional roots = nodes whose parents are all interface nodes; conditional
  leaves/topological sort cover non-interface nodes only
  (generic_graph.hpp:1185-1249, 2659-2702).
- ``Dag.can_add_arc`` / ``can_flip_arc`` use reachability checks
  (generic_graph.hpp:2711-2743); ``PartiallyDirectedGraph.to_dag`` is the
  Dor–Tarsi (1992) consistent extension (:2278-2343) with
  ``to_approximate_dag`` fallback; ``Dag.to_pdag`` is Chickering (2002).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "NodeLookupError",
    "DirectedGraph",
    "UndirectedGraph",
    "PartiallyDirectedGraph",
    "Dag",
    "ConditionalDirectedGraph",
    "ConditionalUndirectedGraph",
    "ConditionalPartiallyDirectedGraph",
    "ConditionalDag",
]


class NodeLookupError(ValueError, KeyError, IndexError):
    """Lookup of a node name that is not present in the graph.

    The reference raises ``std::invalid_argument`` (mapped to ``ValueError``)
    from generic_graph.hpp index lookups, and ``std::out_of_range`` (mapped
    to ``IndexError``) from arc lookups against explicit node lists
    (SemiparametricBN_test.py expects ``pytest.raises(IndexError)``);
    subclassing all three keeps every caller style working.
    """


class _Node:
    __slots__ = ("name", "parents", "children", "neighbors", "valid")

    def __init__(self, name: str):
        self.name = name
        self.parents: set[int] = set()
        self.children: set[int] = set()
        self.neighbors: set[int] = set()
        self.valid = True


def _is_pair_list(value):
    """True when ``value`` is a non-empty sequence of 2-tuples (an arc/edge
    list rather than a node-name list) — the discriminator the reference's
    pybind11 overloads use (pybindings_graph.cpp:1035-1271)."""
    return (
        isinstance(value, (list, tuple))
        and len(value) > 0
        and isinstance(value[0], (tuple, list))
        and len(value[0]) == 2
    )


class _GraphBase:
    """Name↔index bookkeeping shared by all graph classes."""

    def __init__(self, nodes=None):
        self._nodes: list[_Node] = []
        self._indices: dict[str, int] = {}
        self._free: list[int] = []
        self._collapsed: list[int] = []  # raw indices in collapsed order
        for n in nodes or []:
            self.add_node(n)

    # -------------------------------------------------------------- nodes
    def num_nodes(self) -> int:
        return len(self._collapsed)

    def num_raw_nodes(self) -> int:
        return len(self._nodes)

    def nodes(self) -> list[str]:
        return [self._nodes[i].name for i in self._collapsed]

    def contains_node(self, name: str) -> bool:
        return name in self._indices

    def add_node(self, name: str) -> int:
        if name in self._indices:
            raise ValueError(f"Node '{name}' already exists")
        if self._free:
            idx = self._free.pop()
            self._nodes[idx] = _Node(name)
        else:
            idx = len(self._nodes)
            self._nodes.append(_Node(name))
        self._indices[name] = idx
        self._collapsed.append(idx)
        return idx

    def remove_node(self, node) -> None:
        idx = self.check_index(node)
        slot = self._nodes[idx]
        for p in list(slot.parents):
            self._nodes[p].children.discard(idx)
        for c in list(slot.children):
            self._nodes[c].parents.discard(idx)
        for nb in list(slot.neighbors):
            self._nodes[nb].neighbors.discard(idx)
        self._remove_node_hooks(idx)
        del self._indices[slot.name]
        slot.valid = False
        self._free.append(idx)
        # swap-remove from collapsed order (reference util/vector.hpp)
        pos = self._collapsed.index(idx)
        self._collapsed[pos] = self._collapsed[-1]
        self._collapsed.pop()

    def _remove_node_hooks(self, idx: int) -> None:
        pass

    def name(self, idx: int) -> str:
        slot = self._nodes[idx]
        if not slot.valid:
            raise IndexError(f"Index {idx} is not a valid node")
        return slot.name

    def index(self, name: str) -> int:
        try:
            return self._indices[name]
        except KeyError:
            raise NodeLookupError(
                f"Node '{name}' not present in the graph"
            ) from None

    def check_index(self, node) -> int:
        if isinstance(node, str):
            return self.index(node)
        if not (0 <= node < len(self._nodes)) or not self._nodes[node].valid:
            raise IndexError(f"Index {node} is not a valid node")
        return node

    def is_valid(self, idx: int) -> bool:
        return 0 <= idx < len(self._nodes) and self._nodes[idx].valid

    def collapsed_index(self, name: str) -> int:
        return self._collapsed.index(self.index(name))

    def collapsed_from_index(self, idx: int) -> int:
        return self._collapsed.index(self.check_index(idx))

    def index_from_collapsed(self, cidx: int) -> int:
        return self._collapsed[cidx]

    def collapsed_name(self, cidx: int) -> str:
        return self._nodes[self._collapsed[cidx]].name

    def collapsed_indices(self) -> dict[str, int]:
        return {self._nodes[i].name: c for c, i in enumerate(self._collapsed)}

    def indices(self) -> dict[str, int]:
        """name → raw index for every node (reference graph indices())."""
        return {self._nodes[i].name: i for i in self._collapsed}

    def _structural_copy(self):
        """Fast deep copy of the base graph structure (nodes + adjacency
        sets + index bookkeeping) without ``copy.deepcopy`` dispatch. Only
        valid for classes that add no state beyond ``_GraphBase`` (Dag,
        DirectedGraph); used by the model layer's interned-structure
        templates."""
        new = object.__new__(type(self))
        nodes = []
        for nd in self._nodes:
            n2 = _Node.__new__(_Node)
            n2.name = nd.name
            n2.parents = set(nd.parents)
            n2.children = set(nd.children)
            n2.neighbors = set(nd.neighbors)
            n2.valid = nd.valid
            nodes.append(n2)
        new._nodes = nodes
        new._indices = dict(self._indices)
        new._free = list(self._free)
        new._collapsed = list(self._collapsed)
        return new

    # -------------------------------------------------------------- pickle
    def save(self, filename: str) -> None:
        from ..utils.pickle import save_object

        save_object(self, filename)


# ===================================================================== mixins
class _ArcOps:
    """Directed-arc operations (reference ArcGraph mixin,
    generic_graph.hpp:967-1298)."""

    def num_arcs(self) -> int:
        return sum(len(self._nodes[i].children) for i in self._collapsed)

    def arcs(self) -> list[tuple[str, str]]:
        out = []
        for i in self._collapsed:
            s = self._nodes[i]
            for t in s.children:
                out.append((s.name, self._nodes[t].name))
        return out

    def arc_indices(self) -> list[tuple[int, int]]:
        return [
            (i, t) for i in self._collapsed for t in self._nodes[i].children
        ]

    def parents(self, node) -> list[str]:
        idx = self.check_index(node)
        return [self._nodes[p].name for p in self._nodes[idx].parents]

    def parent_indices(self, node) -> list[int]:
        return list(self._nodes[self.check_index(node)].parents)

    def children(self, node) -> list[str]:
        idx = self.check_index(node)
        return [self._nodes[c].name for c in self._nodes[idx].children]

    def children_indices(self, node) -> list[int]:
        return list(self._nodes[self.check_index(node)].children)

    def num_parents(self, node) -> int:
        return len(self._nodes[self.check_index(node)].parents)

    def num_children(self, node) -> int:
        return len(self._nodes[self.check_index(node)].children)

    def has_arc(self, source, target) -> bool:
        s = self.check_index(source)
        t = self.check_index(target)
        return t in self._nodes[s].children

    def _can_exist_arc(self, s: int, t: int) -> bool:
        return True

    def add_arc(self, source, target) -> None:
        s = self.check_index(source)
        t = self.check_index(target)
        if not self._can_exist_arc(s, t):
            raise ValueError("Interface nodes cannot have parents.")
        self._add_arc_unsafe(s, t)

    def _add_arc_unsafe(self, s: int, t: int) -> None:
        self._nodes[t].parents.add(s)
        self._nodes[s].children.add(t)

    def remove_arc(self, source, target) -> None:
        s = self.check_index(source)
        t = self.check_index(target)
        self._nodes[t].parents.discard(s)
        self._nodes[s].children.discard(t)

    def flip_arc(self, source, target) -> None:
        s = self.check_index(source)
        t = self.check_index(target)
        if not self._can_exist_arc(t, s):
            raise ValueError("Interface nodes cannot have parents.")
        self.remove_arc(s, t)
        self._add_arc_unsafe(t, s)

    def roots(self) -> list[str]:
        return [
            self._nodes[i].name for i in self._collapsed if self._is_root(i)
        ]

    def leaves(self) -> list[str]:
        return [
            self._nodes[i].name for i in self._collapsed if self._is_leaf(i)
        ]

    def _is_root(self, idx: int) -> bool:
        return not self._nodes[idx].parents

    def _is_leaf(self, idx: int) -> bool:
        return not self._nodes[idx].children

    def is_root(self, node) -> bool:
        return self._is_root(self.check_index(node))

    def is_leaf(self, node) -> bool:
        return self._is_leaf(self.check_index(node))

    def has_path(self, source, target) -> bool:
        """Directed reachability source ⇝ target (BFS over children)."""
        s = self.check_index(source)
        t = self.check_index(target)
        if s == t:
            return True
        visited = {s}
        stack = [s]
        while stack:
            cur = stack.pop()
            for c in self._nodes[cur].children:
                if c == t:
                    return True
                if c not in visited:
                    visited.add(c)
                    stack.append(c)
        return False

    def _has_path_no_direct_arc(self, s: int, t: int) -> bool:
        """Reachability s ⇝ t ignoring the direct arc s→t."""
        visited = {s}
        stack = []
        for c in self._nodes[s].children:
            if c != t:
                stack.append(c)
                visited.add(c)
        while stack:
            cur = stack.pop()
            if cur == t:
                return True
            for c in self._nodes[cur].children:
                if c not in visited:
                    visited.add(c)
                    stack.append(c)
        return False

    def adjacency_matrix(self) -> np.ndarray:
        """Dense bool matrix over collapsed indices (device-mask source)."""
        n = self.num_nodes()
        pos = {idx: c for c, idx in enumerate(self._collapsed)}
        adj = np.zeros((n, n), dtype=bool)
        for i in self._collapsed:
            for t in self._nodes[i].children:
                adj[pos[i], pos[t]] = True
        return adj


class _EdgeOps:
    """Undirected-edge operations (reference EdgeGraph mixin,
    generic_graph.hpp:1300+)."""

    def num_edges(self) -> int:
        return sum(len(self._nodes[i].neighbors) for i in self._collapsed) // 2

    def edges(self) -> list[tuple[str, str]]:
        out = []
        for i in self._collapsed:
            for nb in self._nodes[i].neighbors:
                if i < nb:
                    out.append((self._nodes[i].name, self._nodes[nb].name))
        return out

    def edge_indices(self) -> list[tuple[int, int]]:
        return [
            (i, nb)
            for i in self._collapsed
            for nb in self._nodes[i].neighbors
            if i < nb
        ]

    def neighbors(self, node) -> list[str]:
        idx = self.check_index(node)
        return [self._nodes[nb].name for nb in self._nodes[idx].neighbors]

    def neighbor_indices(self, node) -> list[int]:
        return list(self._nodes[self.check_index(node)].neighbors)

    def num_neighbors(self, node) -> int:
        return len(self._nodes[self.check_index(node)].neighbors)

    def has_edge(self, u, v) -> bool:
        ui = self.check_index(u)
        vi = self.check_index(v)
        return vi in self._nodes[ui].neighbors

    def _can_exist_edge(self, u: int, v: int) -> bool:
        return True

    def add_edge(self, u, v) -> None:
        ui = self.check_index(u)
        vi = self.check_index(v)
        if not self._can_exist_edge(ui, vi):
            raise ValueError("An edge cannot exist between interface nodes.")
        self._nodes[ui].neighbors.add(vi)
        self._nodes[vi].neighbors.add(ui)

    def remove_edge(self, u, v) -> None:
        ui = self.check_index(u)
        vi = self.check_index(v)
        self._nodes[ui].neighbors.discard(vi)
        self._nodes[vi].neighbors.discard(ui)


class _ConditionalMixin:
    """Interface-node bookkeeping for conditional graphs
    (reference ConditionalGraphBase, generic_graph.hpp:582-780)."""

    @staticmethod
    def _swap_remove(order: list[int], idx: int) -> None:
        pos = order.index(idx)
        order[pos] = order[-1]
        order.pop()

    def _init_conditional(self, nodes, interface_nodes):
        self._interface: set[int] = set()
        # Each index space has its own order container so mutating one kind
        # of node never perturbs the other space (reference keeps nodes and
        # interface in separate BidirectionalMapIndex, generic_graph.hpp:582).
        self._plain_order: list[int] = list(self._collapsed)
        self._iface_order: list[int] = []
        for n in interface_nodes or []:
            self.add_interface_node(n)

    def num_interface_nodes(self) -> int:
        return len(self._interface)

    def num_joint_nodes(self) -> int:
        return _GraphBase.num_nodes(self)

    def num_nodes(self) -> int:
        return _GraphBase.num_nodes(self) - len(self._interface)

    def nodes(self) -> list[str]:
        return [self._nodes[i].name for i in self._plain_order]

    def interface_nodes(self) -> list[str]:
        return [self._nodes[i].name for i in self._iface_order]

    def joint_nodes(self) -> list[str]:
        return [self._nodes[i].name for i in self._collapsed]

    def is_interface(self, node) -> bool:
        return self.check_index(node) in self._interface

    def contains_interface_node(self, name: str) -> bool:
        return self.contains_node(name) and self.is_interface(name)

    def contains_joint_node(self, name: str) -> bool:
        return self.contains_node(name)

    def add_node(self, name: str) -> int:
        idx = super().add_node(name)
        # During base-class __init__ the order containers do not exist yet;
        # _init_conditional seeds _plain_order from _collapsed afterwards.
        if hasattr(self, "_plain_order"):
            self._plain_order.append(idx)
        return idx

    def add_interface_node(self, name: str) -> int:
        idx = self.add_node(name)
        self._plain_order.pop()  # just appended by add_node
        self._iface_order.append(idx)
        self._interface.add(idx)
        return idx

    def remove_interface_node(self, node) -> None:
        idx = self.check_index(node)
        if idx not in self._interface:
            raise ValueError(f"Node {node!r} is not an interface node")
        self.remove_node(idx)

    def set_interface(self, node) -> None:
        idx = self.check_index(node)
        if idx not in self._interface:
            if self._nodes[idx].parents:
                raise ValueError("Interface nodes cannot have parents.")
            self._swap_remove(self._plain_order, idx)
            self._iface_order.append(idx)
            self._interface.add(idx)

    def set_node(self, node) -> None:
        idx = self.check_index(node)
        if idx in self._interface:
            self._swap_remove(self._iface_order, idx)
            self._plain_order.append(idx)
            self._interface.discard(idx)

    def _remove_node_hooks(self, idx: int) -> None:
        if idx in self._interface:
            self._swap_remove(self._iface_order, idx)
        else:
            self._swap_remove(self._plain_order, idx)
        self._interface.discard(idx)

    # conditional arc/edge legality (generic_graph.hpp:928-946)
    def _can_exist_arc(self, s: int, t: int) -> bool:
        return t not in self._interface

    def _can_exist_edge(self, u: int, v: int) -> bool:
        return not (u in self._interface and v in self._interface)

    # conditional roots/leaves (generic_graph.hpp:1185-1249)
    def _is_root(self, idx: int) -> bool:
        if idx in self._interface:
            return False
        return all(p in self._interface for p in self._nodes[idx].parents)

    def _is_leaf(self, idx: int) -> bool:
        if idx in self._interface:
            return False
        return not self._nodes[idx].children

    # ---- three collapsed index spaces (reference generic_graph.hpp:687-745):
    # "collapsed" covers only non-interface nodes in a conditional graph;
    # "interface_collapsed" covers the interface; "joint_collapsed" covers all.
    def _collapsed_non_interface(self) -> list[int]:
        return self._plain_order

    def _collapsed_interface(self) -> list[int]:
        return self._iface_order

    def collapsed_index(self, name: str) -> int:
        return self._collapsed_non_interface().index(self.index(name))

    def collapsed_from_index(self, idx: int) -> int:
        return self._collapsed_non_interface().index(self.check_index(idx))

    def index_from_collapsed(self, cidx: int) -> int:
        return self._collapsed_non_interface()[cidx]

    def collapsed_name(self, cidx: int) -> str:
        return self._nodes[self._collapsed_non_interface()[cidx]].name

    def collapsed_indices(self) -> dict[str, int]:
        return {
            self._nodes[i].name: c
            for c, i in enumerate(self._collapsed_non_interface())
        }

    def interface_collapsed_index(self, name: str) -> int:
        return self._collapsed_interface().index(self.index(name))

    def interface_collapsed_from_index(self, idx: int) -> int:
        return self._collapsed_interface().index(self.check_index(idx))

    def index_from_interface_collapsed(self, cidx: int) -> int:
        return self._collapsed_interface()[cidx]

    def interface_collapsed_name(self, cidx: int) -> str:
        return self._nodes[self._collapsed_interface()[cidx]].name

    def interface_collapsed_indices(self) -> dict[str, int]:
        return {
            self._nodes[i].name: c
            for c, i in enumerate(self._collapsed_interface())
        }

    def joint_collapsed_index(self, name: str) -> int:
        return self._collapsed.index(self.index(name))

    def joint_collapsed_from_index(self, idx: int) -> int:
        return self._collapsed.index(self.check_index(idx))

    def index_from_joint_collapsed(self, cidx: int) -> int:
        return self._collapsed[cidx]

    def joint_collapsed_name(self, cidx: int) -> str:
        return self._nodes[self._collapsed[cidx]].name

    def joint_collapsed_indices(self) -> dict[str, int]:
        return {self._nodes[i].name: c for c, i in enumerate(self._collapsed)}

    def interface_arcs(self) -> list[tuple[str, str]]:
        return [
            (s, t) for (s, t) in self.arcs() if self.is_interface(s)
        ]

    def interface_edges(self) -> list[tuple[str, str]]:
        return [
            (u, v)
            for (u, v) in self.edges()
            if self.is_interface(u) or self.is_interface(v)
        ]


# ================================================================ concrete
class UndirectedGraph(_GraphBase, _EdgeOps):
    def __init__(self, nodes=None, edges=None):
        if edges is None and _is_pair_list(nodes):
            nodes, edges = None, nodes
        super().__init__(nodes)
        for u, v in edges or []:
            if not self.contains_node(u):
                self.add_node(u)
            if not self.contains_node(v):
                self.add_node(v)
            self.add_edge(u, v)

    @staticmethod
    def Complete(nodes) -> "UndirectedGraph":
        g = UndirectedGraph(nodes)
        names = list(nodes)
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                g.add_edge(names[i], names[j])
        return g

    def conditional_graph(self, nodes=None, interface_nodes=None):
        return _to_conditional(
            self, ConditionalUndirectedGraph, nodes, interface_nodes
        )

    def unconditional_graph(self) -> "UndirectedGraph":
        return UndirectedGraph(self.nodes(), self.edges())

    def __getstate__(self):
        return {"nodes": self.nodes(), "edges": self.edges()}

    def __setstate__(self, state):
        self.__init__(state["nodes"], state["edges"])


class DirectedGraph(_GraphBase, _ArcOps):
    def __init__(self, nodes=None, arcs=None):
        if arcs is None and _is_pair_list(nodes):
            nodes, arcs = None, nodes
        super().__init__(nodes)
        for s, t in arcs or []:
            if not self.contains_node(s):
                self.add_node(s)
            if not self.contains_node(t):
                self.add_node(t)
            self.add_arc(s, t)

    def conditional_graph(self, nodes=None, interface_nodes=None):
        return _to_conditional(
            self, ConditionalDirectedGraph, nodes, interface_nodes
        )

    def unconditional_graph(self) -> "DirectedGraph":
        return DirectedGraph(self.nodes(), self.arcs())

    def __getstate__(self):
        return {"nodes": self.nodes(), "arcs": self.arcs()}

    def __setstate__(self, state):
        self.__init__(state["nodes"], state["arcs"])


class Dag(DirectedGraph):
    """Directed acyclic graph with cycle-safe mutation
    (reference DagImpl, generic_graph.hpp:1835-2197)."""

    def add_arc(self, source, target) -> None:
        s = self.check_index(source)
        t = self.check_index(target)
        if not self.can_add_arc(s, t):
            raise ValueError(
                f"Arc {self.name(s)} -> {self.name(t)} is not valid: "
                "the graph must be a DAG."
            )
        self._add_arc_unsafe(s, t)

    def add_arc_unsafe(self, source, target) -> None:
        self._add_arc_unsafe(self.check_index(source), self.check_index(target))

    def can_add_arc(self, source, target) -> bool:
        s = self.check_index(source)
        t = self.check_index(target)
        if s == t or not self._can_exist_arc(s, t):
            return False
        if (
            not self._nodes[s].parents
            or not self._nodes[t].children
            or not self.has_path(t, s)
        ):
            return True
        return False

    def can_flip_arc(self, source, target) -> bool:
        s = self.check_index(source)
        t = self.check_index(target)
        if s == t or not self._can_exist_arc(t, s):
            return False
        if self.has_arc(s, t):
            if (
                len(self._nodes[t].parents) == 1
                or len(self._nodes[s].children) == 1
            ):
                return True
            return not self._has_path_no_direct_arc(s, t)
        else:
            if not self._nodes[t].parents or not self._nodes[s].children:
                return True
            return not self.has_path(s, t)

    def flip_arc(self, source, target) -> None:
        s = self.check_index(source)
        t = self.check_index(target)
        if not self.can_flip_arc(s, t):
            raise ValueError(
                f"Flipping arc {self.name(s)} -> {self.name(t)} would break "
                "the DAG."
            )
        self.remove_arc(s, t)
        self._add_arc_unsafe(t, s)

    def is_dag(self) -> bool:
        try:
            self.topological_sort()
            return True
        except ValueError:
            return False

    def topological_sort(self) -> list[str]:
        """Kahn's algorithm seeded from roots (generic_graph.hpp:2659-2702).
        Conditional graphs: non-interface nodes only, interface parents
        ignored."""
        incoming = {}
        for i in self._collapsed:
            if self._node_in_sort(i):
                incoming[i] = sum(
                    1 for p in self._nodes[i].parents if self._node_in_sort(p)
                )
        stack = [i for i in self._collapsed if self._is_root(i)]
        order: list[str] = []
        while stack:
            cur = stack.pop()
            order.append(self._nodes[cur].name)
            for c in self._nodes[cur].children:
                incoming[c] -= 1
                if incoming[c] == 0:
                    stack.append(c)
        if any(v > 0 for v in incoming.values()):
            raise ValueError("Graph must be a DAG to obtain a topological sort.")
        return order

    def _node_in_sort(self, idx: int) -> bool:
        return True

    def to_pdag(self) -> "PartiallyDirectedGraph":
        """DAG → CPDAG, Chickering (2002) label-compelled algorithm
        (reference generic_graph.hpp to_pdag)."""
        order = self.topological_sort()
        rank = {n: i for i, n in enumerate(order)}
        # arcs sorted: by topological rank of target, then decreasing rank of
        # source (reference sort_arcs, generic_graph.hpp:2745)
        sorted_arcs: list[tuple[str, str]] = []
        for y in order:
            ps = sorted(self.parents(y), key=lambda p: rank[p], reverse=True)
            for x in ps:
                if self._arc_in_pdag(x, y):
                    sorted_arcs.append((x, y))
        COMPELLED, REVERSIBLE, UNKNOWN = 1, 2, 0
        label = {a: UNKNOWN for a in sorted_arcs}

        def arc_label(w, x):
            # interface arcs are compelled by definition (not in the pdag)
            if not self._arc_in_pdag(w, x):
                return COMPELLED
            return label.get((w, x), UNKNOWN)

        for (x, y) in sorted_arcs:
            if label[(x, y)] != UNKNOWN:
                continue
            done = False
            for w in self.parents(x):
                if arc_label(w, x) == COMPELLED:
                    if not self.has_arc(w, y):
                        # w -> x -> y with w ∉ pa(y): every arc into y compelled
                        for z in self.parents(y):
                            if self._arc_in_pdag(z, y):
                                label[(z, y)] = COMPELLED
                        done = True
                        break
                    else:
                        if self._arc_in_pdag(w, y):
                            label[(w, y)] = COMPELLED
            if done:
                continue
            exists_z = any(
                z != x and not self.has_arc(z, x) for z in self.parents(y)
            )
            target_label = COMPELLED if exists_z else REVERSIBLE
            for z in self.parents(y):
                if self._arc_in_pdag(z, y) and label[(z, y)] == UNKNOWN:
                    label[(z, y)] = target_label
        pdag = self._new_pdag()
        for (x, y), lab in label.items():
            if lab == COMPELLED:
                pdag.add_arc(x, y)
            else:
                pdag.add_edge(x, y)
        if isinstance(self, _ConditionalMixin):
            for (x, y) in self.interface_arcs():
                pdag.add_arc(x, y)
        return pdag

    def _arc_in_pdag(self, x, y) -> bool:
        if isinstance(self, _ConditionalMixin):
            return not self.is_interface(x)
        return True

    def _new_pdag(self):
        if isinstance(self, _ConditionalMixin):
            return ConditionalPartiallyDirectedGraph(
                self.nodes(), self.interface_nodes()
            )
        return PartiallyDirectedGraph(self.nodes())

    def conditional_graph(self, nodes=None, interface_nodes=None):
        return _to_conditional(self, ConditionalDag, nodes, interface_nodes)

    def unconditional_graph(self) -> "Dag":
        return Dag(self.nodes(), self.arcs())


class PartiallyDirectedGraph(_GraphBase, _ArcOps, _EdgeOps):
    """PDAG with both arcs and edges (reference generic_graph.hpp:1716)."""

    def __init__(self, nodes=None, arcs=None, edges=None):
        # 2-arg reference overload: (arcs, edges) (pybindings_graph.cpp:1239)
        if edges is None and arcs is not None and _is_pair_list(nodes):
            nodes, arcs, edges = None, nodes, arcs
        super().__init__(nodes)
        for s, t in arcs or []:
            if not self.contains_node(s):
                self.add_node(s)
            if not self.contains_node(t):
                self.add_node(t)
            self.add_arc(s, t)
        for u, v in edges or []:
            if not self.contains_node(u):
                self.add_node(u)
            if not self.contains_node(v):
                self.add_node(v)
            self.add_edge(u, v)

    @staticmethod
    def CompleteUndirected(nodes) -> "PartiallyDirectedGraph":
        g = PartiallyDirectedGraph(nodes)
        names = list(nodes)
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                g.add_edge(names[i], names[j])
        return g

    def add_arc(self, source, target) -> None:
        s = self.check_index(source)
        t = self.check_index(target)
        if self.has_edge(s, t):
            self.remove_edge(s, t)
        super().add_arc(s, t)

    def add_edge(self, u, v) -> None:
        ui = self.check_index(u)
        vi = self.check_index(v)
        if self.has_arc(ui, vi) or self.has_arc(vi, ui):
            raise ValueError("Cannot add an edge between nodes joined by an arc")
        super().add_edge(ui, vi)

    def direct(self, source, target) -> None:
        """Edge u—v → arc u→v (reference generic_graph.hpp:1436)."""
        s = self.check_index(source)
        t = self.check_index(target)
        if self.has_edge(s, t):
            self.remove_edge(s, t)
            self._add_arc_unsafe(s, t)
        elif self.has_arc(t, s):
            self.remove_arc(t, s)
            self._add_arc_unsafe(s, t)

    def undirect(self, source, target) -> None:
        s = self.check_index(source)
        t = self.check_index(target)
        if self.has_arc(s, t):
            self.remove_arc(s, t)
        if not self.has_arc(t, s):
            _EdgeOps.add_edge(self, s, t)

    def has_connection(self, u, v) -> bool:
        ui = self.check_index(u)
        vi = self.check_index(v)
        return (
            self.has_edge(ui, vi)
            or self.has_arc(ui, vi)
            or self.has_arc(vi, ui)
        )

    # ------------------------------------------------------------ to_dag
    def to_dag(self) -> "Dag":
        """Dor–Tarsi (1992) consistent extension
        (reference generic_graph.hpp:2278-2343). Raises ValueError when no
        extension exists."""
        work = self._copy_pdag()
        dag = self._new_dag()
        for (s, t) in self.arc_indices():
            dag.add_arc_unsafe(self._nodes[s].name, self._nodes[t].name)

        remaining = set(work._collapsed)
        progress = True
        while remaining and progress:
            progress = False
            for idx in list(remaining):
                node = work._nodes[idx]
                if node.children:
                    continue
                # sink with no undirected edges, or every neighbor adjacent to
                # all other adjacents of idx
                adjacent = node.parents | node.neighbors
                ok = True
                for nb in node.neighbors:
                    others = adjacent - {nb}
                    nb_adj = (
                        work._nodes[nb].parents
                        | work._nodes[nb].children
                        | work._nodes[nb].neighbors
                    )
                    if not others <= nb_adj:
                        ok = False
                        break
                if not ok:
                    continue
                for nb in list(node.neighbors):
                    dag.add_arc_unsafe(
                        work._nodes[nb].name, work._nodes[idx].name
                    )
                work.remove_node(idx)
                remaining.discard(idx)
                progress = True
        if remaining:
            raise ValueError(
                "PDAG do not allow a valid DAG extension (Dor & Tarsi)."
            )
        if not dag.is_dag():
            raise ValueError(
                "PDAG do not allow a valid DAG extension (cycle in arcs)."
            )
        return dag

    def to_approximate_dag(self) -> "Dag":
        """Fallback extension: topo-order by arc-direction votes, orient
        edges along the order (reference generic_graph.hpp:2345+)."""
        names = self.joint_nodes() if isinstance(self, _ConditionalMixin) else self.nodes()
        votes = {n: 0 for n in names}
        for (s, t) in self.arcs():
            votes[t] += 1
            votes[s] -= 1
        order = sorted(names, key=lambda n: votes[n])
        rank = {n: i for i, n in enumerate(order)}
        dag = self._new_dag()
        for (s, t) in self.arcs():
            if rank[s] < rank[t]:
                dag.add_arc_unsafe(s, t)
            else:
                dag.add_arc_unsafe(t, s)
        for (u, v) in self.edges():
            if rank[u] < rank[v]:
                dag.add_arc_unsafe(u, v)
            else:
                dag.add_arc_unsafe(v, u)
        if not dag.is_dag():
            # last resort: drop arcs that close cycles
            dag2 = self._new_dag()
            for (s, t) in dag.arcs():
                if dag2.can_add_arc(s, t):
                    dag2.add_arc_unsafe(s, t)
            return dag2
        return dag

    def _copy_pdag(self) -> "PartiallyDirectedGraph":
        g = PartiallyDirectedGraph(
            self.joint_nodes()
            if isinstance(self, _ConditionalMixin)
            else self.nodes()
        )
        for (s, t) in self.arcs():
            g.add_arc(s, t)
        for (u, v) in self.edges():
            g.add_edge(u, v)
        return g

    def _new_dag(self) -> "Dag":
        if isinstance(self, _ConditionalMixin):
            return ConditionalDag(self.nodes(), self.interface_nodes())
        return Dag(self.nodes())

    def conditional_graph(self, nodes=None, interface_nodes=None):
        return _to_conditional(
            self, ConditionalPartiallyDirectedGraph, nodes, interface_nodes
        )

    def unconditional_graph(self) -> "PartiallyDirectedGraph":
        return PartiallyDirectedGraph(self.nodes(), self.arcs(), self.edges())

    def __getstate__(self):
        return {
            "nodes": self.nodes(),
            "arcs": self.arcs(),
            "edges": self.edges(),
        }

    def __setstate__(self, state):
        self.__init__(state["nodes"], state["arcs"], state["edges"])


# ====================================================== conditional concrete
class ConditionalDirectedGraph(_ConditionalMixin, DirectedGraph):
    def __init__(self, nodes=None, interface_nodes=None, arcs=None):
        DirectedGraph.__init__(self, nodes)
        self._init_conditional(nodes, interface_nodes)
        for s, t in arcs or []:
            self.add_arc(s, t)

    def unconditional_graph(self) -> DirectedGraph:
        return DirectedGraph(self.joint_nodes(), self.arcs())

    def __getstate__(self):
        return {
            "nodes": self.nodes(),
            "interface_nodes": self.interface_nodes(),
            "arcs": self.arcs(),
        }

    def __setstate__(self, state):
        self.__init__(state["nodes"], state["interface_nodes"], state["arcs"])


class ConditionalUndirectedGraph(_ConditionalMixin, UndirectedGraph):
    def __init__(self, nodes=None, interface_nodes=None, edges=None):
        UndirectedGraph.__init__(self, nodes)
        self._init_conditional(nodes, interface_nodes)
        for u, v in edges or []:
            self.add_edge(u, v)

    @staticmethod
    def Complete(nodes, interface_nodes) -> "ConditionalUndirectedGraph":
        """Complete over node-node and node-interface pairs (no
        interface-interface edges), reference generic_graph.cpp:6-40."""
        g = ConditionalUndirectedGraph(nodes, interface_nodes)
        names = list(nodes)
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                g.add_edge(names[i], names[j])
            for itf in interface_nodes:
                g.add_edge(names[i], itf)
        return g

    def unconditional_graph(self) -> UndirectedGraph:
        return UndirectedGraph(self.joint_nodes(), self.edges())

    def __getstate__(self):
        return {
            "nodes": self.nodes(),
            "interface_nodes": self.interface_nodes(),
            "edges": self.edges(),
        }

    def __setstate__(self, state):
        self.__init__(state["nodes"], state["interface_nodes"], state["edges"])


class ConditionalPartiallyDirectedGraph(_ConditionalMixin, PartiallyDirectedGraph):
    def __init__(self, nodes=None, interface_nodes=None, arcs=None, edges=None):
        PartiallyDirectedGraph.__init__(self, nodes)
        self._init_conditional(nodes, interface_nodes)
        for s, t in arcs or []:
            self.add_arc(s, t)
        for u, v in edges or []:
            self.add_edge(u, v)

    def unconditional_graph(self) -> PartiallyDirectedGraph:
        return PartiallyDirectedGraph(
            self.joint_nodes(), self.arcs(), self.edges()
        )

    def __getstate__(self):
        return {
            "nodes": self.nodes(),
            "interface_nodes": self.interface_nodes(),
            "arcs": self.arcs(),
            "edges": self.edges(),
        }

    def __setstate__(self, state):
        self.__init__(
            state["nodes"],
            state["interface_nodes"],
            state["arcs"],
            state["edges"],
        )


class ConditionalDag(_ConditionalMixin, Dag):
    def __init__(self, nodes=None, interface_nodes=None, arcs=None):
        Dag.__init__(self, nodes)
        self._init_conditional(nodes, interface_nodes)
        for s, t in arcs or []:
            self.add_arc(s, t)

    def _node_in_sort(self, idx: int) -> bool:
        return idx not in self._interface

    def unconditional_graph(self) -> Dag:
        return Dag(self.joint_nodes(), self.arcs())

    def __getstate__(self):
        return {
            "nodes": self.nodes(),
            "interface_nodes": self.interface_nodes(),
            "arcs": self.arcs(),
        }

    def __setstate__(self, state):
        self.__init__(state["nodes"], state["interface_nodes"], state["arcs"])


def _to_conditional(g, cls, nodes, interface_nodes):
    """Build a conditional variant of ``g`` (reference
    generic_graph.hpp:112-194)."""
    if nodes is None:
        nodes = g.nodes()
        interface_nodes = []
    interface_nodes = list(interface_nodes or [])
    cg = (
        cls(nodes, interface_nodes)
        if not isinstance(g, PartiallyDirectedGraph)
        else cls(nodes, interface_nodes)
    )
    total = set(nodes) | set(interface_nodes)
    if hasattr(g, "arcs"):
        for (s, t) in g.arcs():
            if s in total and t in total:
                cg.add_arc(s, t)
    if hasattr(g, "edges"):
        for (u, v) in g.edges():
            if u in total and v in total:
                cg.add_edge(u, v)
    return cg
