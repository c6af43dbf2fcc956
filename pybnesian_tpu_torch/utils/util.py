"""Host-side constants and combinatorics.

Mirrors the capability of reference util/math_constants.hpp,
util/temporal.hpp:9-15 and util/combinations.hpp:12-284, re-written as plain
Python (these run on host only; they never touch the device).
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator, Sequence, TypeVar

T = TypeVar("T")

#: Machine tolerance used for singularity guards (reference util/math_constants.hpp).
MACHINE_TOL = 2.220446049250313e-16 * 4


def temporal_name(name: str, slice_index: int) -> str:
    """DBN column naming scheme ``"name_t_k"`` (reference util/temporal.hpp:9)."""
    return f"{name}_t_{slice_index}"


def temporal_names(names: Sequence[str], start: int, stop: int) -> list[str]:
    """All temporal names for slices ``start..stop`` inclusive."""
    return [temporal_name(v, s) for s in range(start, stop + 1) for v in names]


def temporal_slice_names(names: Sequence[str], slice_index: int) -> list[str]:
    return [temporal_name(v, slice_index) for v in names]


class Combinations:
    """Lazy k-subsets of a sequence (reference util/combinations.hpp:12)."""

    def __init__(self, elements: Sequence[T], k: int):
        self.elements = list(elements)
        self.k = k

    def __iter__(self) -> Iterator[tuple[T, ...]]:
        return itertools.combinations(self.elements, self.k)

    def num_combinations(self) -> int:
        import math

        n = len(self.elements)
        if self.k > n:
            return 0
        return math.comb(n, self.k)


class Combinations2Sets:
    """k-subsets drawn from the union of two candidate pools, deduplicated
    (reference util/combinations.hpp:168). Used by PC to enumerate sepsets from
    neighbourhoods of both arc endpoints."""

    def __init__(self, set1: Iterable[T], set2: Iterable[T], k: int):
        self.set1 = list(set1)
        self.set2 = list(set2)
        self.k = k

    def __iter__(self) -> Iterator[tuple[T, ...]]:
        seen = set()
        for pool in (self.set1, self.set2):
            for comb in itertools.combinations(pool, self.k):
                key = frozenset(comb)
                if key not in seen:
                    seen.add(key)
                    yield comb


class AllSubsets:
    """All subsets of sizes ``min_k..max_k`` (reference util/combinations.hpp:284)."""

    def __init__(self, elements: Sequence[T], min_k: int, max_k: int):
        self.elements = list(elements)
        self.min_k = min_k
        self.max_k = max_k

    def __iter__(self) -> Iterator[tuple[T, ...]]:
        for k in range(self.min_k, self.max_k + 1):
            yield from itertools.combinations(self.elements, k)
