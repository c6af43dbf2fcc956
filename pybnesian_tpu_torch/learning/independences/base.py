"""Independence test interfaces
(reference learning/independences/independence.hpp:15-49).

Copied from ``pybnesian_tpu/learning/independences/base.py``.

`pvalue_batch` is the batched extension the reference lacks: constraint
searches (PC orders, v-structure votes) collect every candidate test of a
sweep and evaluate them in one call, so a test can vectorise a whole sweep
instead of paying the per-test overhead. The default implementation is the
serial loop, so user-defined Python tests keep working unchanged.
"""

from __future__ import annotations

import numpy as np

__all__ = ["IndependenceTest", "DynamicIndependenceTest"]


class IndependenceTest:
    """pvalue(x, y, *z): null hypothesis is x ⫫ y | z."""

    def pvalue(self, x: str, y: str, *z: str) -> float:
        raise NotImplementedError

    def pvalue_batch(self, triples) -> np.ndarray:
        """Evaluate many tests at once.

        ``triples`` is a sequence of ``(x, y, zs)`` with ``zs`` a tuple of
        conditioning names (possibly empty, sizes may be mixed). Returns an
        array of p-values aligned with ``triples``. Subclasses with
        device-backed batch kernels override this; the base implementation
        is the serial loop.
        """
        return np.array(
            [self.pvalue(x, y, *zs) for (x, y, zs) in triples],
            dtype=np.float64,
        )

    def num_variables(self) -> int:
        return len(self.variable_names())

    def variable_names(self) -> list[str]:
        raise NotImplementedError

    def name(self, index: int) -> str:
        """Variable name at position ``index``
        (reference pybindings_independences.cpp:163)."""
        return self.variable_names()[index]

    def has_variables(self, variables) -> bool:
        if isinstance(variables, str):
            variables = [variables]
        names = set(self.variable_names())
        return all(v in names for v in variables)


class DynamicIndependenceTest:
    """Static + transition test pair (reference independence.hpp:33-49)."""

    test_cls = None

    def __init__(self, ddf, *args, **kwargs):
        from ...data.dynamic import DynamicDataFrame

        if not isinstance(ddf, DynamicDataFrame):
            raise TypeError(
                "Dynamic independence tests require a DynamicDataFrame"
            )
        self.ddf = ddf
        self._static = self.test_cls(ddf.static_df(), *args, **kwargs)
        self._transition = self.test_cls(ddf.transition_df(), *args, **kwargs)

    def static_tests(self) -> IndependenceTest:
        return self._static

    def transition_tests(self) -> IndependenceTest:
        return self._transition

    def variable_names(self) -> list[str]:
        return self.ddf.variables()

    def name(self, index: int) -> str:
        """Variable name at position ``index``
        (reference pybindings_independences.cpp:405)."""
        return self.variable_names()[index]

    def num_variables(self) -> int:
        return len(self.variable_names())

    def has_variables(self, variables) -> bool:
        if isinstance(variables, str):
            variables = [variables]
        names = set(self.variable_names())
        return all(v in names for v in variables)

    def markovian_order(self) -> int:
        return self.ddf.markovian_order()
