"""Graph reachability backends: native C++ bitset core with numpy fallback.

The C++ library (pybnesian_tpu/_native/graphcore.cpp) is compiled on first use with the
system toolchain and loaded through ctypes (no pybind11 dependency, per the
build constraints). All entry points accept a dense bool adjacency matrix
over collapsed node indices.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

__all__ = ["transitive_closure", "has_path", "topological_order",
           "add_arc_legality", "native_available"]

_LIB = None
_TRIED = False


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(pkg_dir, "_native", "graphcore.cpp")
    try:
        from .._native import build_and_load

        lib = build_and_load(src)
        lib.gc_transitive_closure.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.gc_has_path.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.gc_has_path.restype = ctypes.c_int
        lib.gc_topological_sort.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.gc_topological_sort.restype = ctypes.c_int
        lib.gc_add_arc_legality.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _build_and_load() is not None


def _to_bitset(adj: np.ndarray):
    n = adj.shape[0]
    words = max(1, -(-n // 64))
    packed = np.zeros((n, words), np.uint64)
    rows, cols = np.nonzero(adj)
    np.bitwise_or.at(
        packed, (rows, cols // 64), np.uint64(1) << (cols % 64).astype(np.uint64)
    )
    return packed, n, words


def transitive_closure(adj: np.ndarray) -> np.ndarray:
    """Reachability matrix: out[i, j] = path i ⇝ j (length ≥ 1)."""
    lib = _build_and_load()
    n = adj.shape[0]
    if lib is not None and n > 0:
        packed, n, words = _to_bitset(adj)
        out = np.zeros_like(packed)
        lib.gc_transitive_closure(
            n, words,
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        bits = (
            out[:, :, None] >> np.arange(64, dtype=np.uint64)[None, None, :]
        ) & np.uint64(1)
        return bits.reshape(n, -1)[:, :n].astype(bool)
    # numpy fallback: boolean closure by repeated squaring
    reach = adj.astype(bool).copy()
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))))):
        new = reach | (reach @ reach)
        if np.array_equal(new, reach):
            break
        reach = new
    return reach


def has_path(adj: np.ndarray, src: int, dst: int) -> bool:
    lib = _build_and_load()
    if lib is not None:
        packed, n, words = _to_bitset(adj)
        return bool(
            lib.gc_has_path(
                n, words,
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                int(src), int(dst),
            )
        )
    if src == dst:
        return True
    return transitive_closure(adj)[src, dst]


def topological_order(adj: np.ndarray):
    """List of node indices in topological order, or None on a cycle."""
    lib = _build_and_load()
    n = adj.shape[0]
    if lib is not None:
        packed, n, words = _to_bitset(adj)
        order = np.zeros(n, np.int32)
        rc = lib.gc_topological_sort(
            n, words,
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return order.tolist() if rc == 0 else None
    indeg = adj.sum(axis=0)
    stack = [i for i in range(n - 1, -1, -1) if indeg[i] == 0]
    order = []
    indeg = indeg.copy()
    while stack:
        i = stack.pop()
        order.append(i)
        for j in np.nonzero(adj[i])[0]:
            indeg[j] -= 1
            if indeg[j] == 0:
                stack.append(int(j))
    return order if len(order) == n else None


def add_arc_legality(adj: np.ndarray) -> np.ndarray:
    """(n, n) bool: legal[s, t] ⇔ adding s→t keeps acyclicity. One closure
    amortizes all n² candidate checks of a hill-climbing iteration."""
    lib = _build_and_load()
    n = adj.shape[0]
    if lib is not None and n > 0:
        packed, n, words = _to_bitset(adj)
        legal = np.zeros(n * n, np.uint8)
        lib.gc_add_arc_legality(
            n, words,
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            legal.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return legal.reshape(n, n).astype(bool)
    closure = transitive_closure(adj)
    legal = ~closure.T
    np.fill_diagonal(legal, False)
    return legal
