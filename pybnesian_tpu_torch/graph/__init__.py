from .core import (
    ConditionalDag,
    NodeLookupError,
    ConditionalDirectedGraph,
    ConditionalPartiallyDirectedGraph,
    ConditionalUndirectedGraph,
    Dag,
    DirectedGraph,
    PartiallyDirectedGraph,
    UndirectedGraph,
)

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
