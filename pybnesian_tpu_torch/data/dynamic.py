"""Dynamic (time-series) data views for DBN learning.

Rebuild of reference dataset/dynamic_dataset.{hpp,cpp}:
``DynamicDataFrame`` materialises ``markovian_order + 1`` shifted temporal
slices with columns renamed ``v_t_k`` (k = 0 is the present, k = m the
furthest past), a ``static_df`` over slices 1..m, and a ``transition_df``
joining slices 0..m (dynamic_dataset.cpp:16-95). Time is handled by data
layout, not by device control flow — the shifted views are plain column
renames over strided row windows, so every downstream kernel sees ordinary
static-shape columns.

Copied from ``pybnesian_tpu/data/dynamic.py``.
"""

from __future__ import annotations

import numpy as np

from ..utils import temporal_name
from .dataframe import Column, DataFrame

__all__ = ["DynamicVariable", "DynamicDataFrame", "create_static_df",
           "create_temporal_slices", "create_transition_df"]


class DynamicVariable:
    """(variable, temporal_slice) index pair (reference dynamic_dataset.hpp:25)."""

    def __init__(self, variable: str, temporal_slice: int):
        self.variable = str(variable)
        self.temporal_slice = int(temporal_slice)

    def temporal_name(self) -> str:
        return temporal_name(self.variable, self.temporal_slice)

    def __repr__(self) -> str:
        return f"DynamicVariable({self.variable}, {self.temporal_slice})"

    def __eq__(self, other):
        return (
            isinstance(other, DynamicVariable)
            and self.variable == other.variable
            and self.temporal_slice == other.temporal_slice
        )

    def __hash__(self):
        return hash((self.variable, self.temporal_slice))


def _temporal_slice(df: DataFrame, slice_index: int, slice_offset: int,
                    markovian_order: int) -> DataFrame:
    """Rows [m - i, m - i + T - m) renamed ``v_t_{i + offset}``
    (reference dynamic_dataset.cpp:16-33)."""
    new_length = df.num_rows - markovian_order
    offset = markovian_order - slice_index
    rows = np.arange(offset, offset + new_length)
    cols = []
    for name in df.column_names():
        c = df.col(name)
        cols.append(
            Column(
                temporal_name(name, slice_index + slice_offset),
                c.values[rows],
                c.categories,
            )
        )
    return DataFrame(cols)


def create_temporal_slices(df: DataFrame, markovian_order: int) -> list[DataFrame]:
    return [
        _temporal_slice(df, i, 0, markovian_order)
        for i in range(markovian_order + 1)
    ]


def create_static_df(df: DataFrame, markovian_order: int) -> DataFrame:
    """(reference dynamic_dataset.cpp:45-71)."""
    if markovian_order == 1:
        return df.rename(
            {n: temporal_name(n, 1) for n in df.column_names()}
        )
    slices = [
        _temporal_slice(df, i, 1, markovian_order - 1)
        for i in range(markovian_order)
    ]
    return DataFrame.concat_columns(*slices)


def create_transition_df(slices: list[DataFrame]) -> DataFrame:
    return DataFrame.concat_columns(*slices)


class DynamicDataFrame:
    def __init__(self, df, markovian_order: int):
        if markovian_order < 1:
            raise ValueError("Markovian order must be at least 1.")
        self.origin = DataFrame.wrap(df)
        self._markovian_order = int(markovian_order)
        self._slices = create_temporal_slices(self.origin, markovian_order)
        self._static = create_static_df(self.origin, markovian_order)
        self._transition = create_transition_df(self._slices)

    def markovian_order(self) -> int:
        return self._markovian_order

    @property
    def num_rows(self) -> int:
        return self._transition.num_rows

    @property
    def num_columns(self) -> int:
        return self._transition.num_columns

    def num_variables(self) -> int:
        return self.origin.num_columns

    def variables(self) -> list[str]:
        return self.origin.column_names()

    def static_df(self) -> DataFrame:
        return self._static

    def transition_df(self) -> DataFrame:
        return self._transition

    def origin_df(self) -> DataFrame:
        return self.origin

    def temporal_slice(self, *slice_indices) -> DataFrame:
        out = []
        for s in slice_indices:
            if not (0 <= s <= self._markovian_order):
                raise ValueError(
                    f"slice_index must be an index between 0 and "
                    f"{self._markovian_order}"
                )
            out.append(self._slices[s])
        if len(out) == 1:
            return out[0]
        return DataFrame.concat_columns(*out)

    def loc(self, indices) -> DataFrame:
        """Column selection by DynamicVariable / (var, slice) tuples."""
        if isinstance(indices, (DynamicVariable, tuple)):
            indices = [indices]
        names = []
        for idx in indices:
            if isinstance(idx, tuple):
                idx = DynamicVariable(idx[0], idx[1])
            names.append(idx.temporal_name())
        return self._transition.loc(names)
