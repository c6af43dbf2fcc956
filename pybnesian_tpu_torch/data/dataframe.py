"""Column-store DataFrame: the data substrate of the framework.

Rebuild of the reference's Arrow-``RecordBatch`` wrapper
(reference dataset/dataset.hpp:784-1953). Design differences, deliberate:

- Host numpy is the source of truth; device (torch) tensors are materialised
  lazily per (columns, dtype, device) request and cached — the analogue of
  the reference's ``to_eigen`` extraction (dataset/dataset.hpp:238-335).
- pandas and pyarrow are optional: they are imported only when the input is
  one of their objects (or an object-typed column needs categorical
  encoding), so a dict of float arrays needs neither.
- Null semantics: continuous nulls are NaN, discrete nulls are code ``-1``
  (the reference uses Arrow validity bitmaps; a combined bitmap over a column
  subset maps here to :meth:`combined_mask`). All device kernels receive a
  static-shape tensor plus a 0/1 validity mask so null handling needs no
  dynamic shapes.
- Discrete columns are dictionary-encoded: int32 codes + category labels,
  exactly the reference's dictionary-array representation.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Iterable, Sequence

import numpy as np

from ..runtime.device import host_to_device, resolve_device

__all__ = ["Column", "DataFrame"]

_FLOAT_DTYPES = (np.float32, np.float64)


@dataclasses.dataclass(frozen=True, slots=True)
class Column:
    """One immutable column. ``categories is None`` ⇔ continuous."""

    name: str
    values: np.ndarray  # float (nan=null) if continuous; int32 codes (-1=null) if discrete
    categories: tuple | None = None

    @property
    def is_discrete(self) -> bool:
        return self.categories is not None

    @property
    def is_continuous(self) -> bool:
        return self.categories is None and np.issubdtype(self.values.dtype, np.floating)

    def null_mask(self) -> np.ndarray:
        """Boolean mask, True where the entry is null."""
        if self.is_discrete:
            return self.values < 0
        if np.issubdtype(self.values.dtype, np.floating):
            return np.isnan(self.values)
        return np.zeros(len(self.values), dtype=bool)

    def null_count(self) -> int:
        return int(self.null_mask().sum())

    def rename(self, name: str) -> "Column":
        return Column(name, self.values, self.categories)


def _loaded(module: str):
    """The module if some caller already imported it, else None: an object
    of pandas' or pyarrow's types can only exist once its module is loaded,
    so inputs of other types never pay for (or require) those packages."""
    return sys.modules.get(module)


def _column_from_series(name: str, data) -> Column:
    import pandas as pd

    if isinstance(data.dtype, pd.CategoricalDtype):
        codes = np.asarray(data.cat.codes, dtype=np.int32)
        return Column(name, codes, tuple(str(c) for c in data.cat.categories))
    if data.dtype == object or pd.api.types.is_string_dtype(data.dtype):
        cat = data.astype("category")
        codes = np.asarray(cat.cat.codes, dtype=np.int32)
        return Column(name, codes, tuple(str(c) for c in cat.cat.categories))
    if pd.api.types.is_bool_dtype(data.dtype):
        cat = data.astype("category")
        codes = np.asarray(cat.cat.codes, dtype=np.int32)
        return Column(name, codes, tuple(str(c) for c in cat.cat.categories))
    return _column_from_array(name, data.to_numpy())


def _column_from_array(name: str, arr: np.ndarray) -> Column:
    if np.issubdtype(arr.dtype, np.integer):
        # Integer columns stay integral (the reference keeps Arrow int types;
        # they are neither "continuous" nor "discrete" for model purposes).
        return Column(name, arr.astype(np.int64))
    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    if arr.dtype not in _FLOAT_DTYPES:
        arr = arr.astype(np.float64)
    return Column(name, arr)


def _column_from_object(name: str, data) -> Column:
    """Build a Column from a pandas Series / pyarrow array / numpy array /
    python list."""
    if isinstance(data, Column):
        return data.rename(name)
    pa = _loaded("pyarrow")
    if pa is not None and isinstance(data, (pa.Array, pa.ChunkedArray)):
        data = data.to_pandas()
    pd = _loaded("pandas")
    if pd is not None and isinstance(data, pd.Series):
        return _column_from_series(name, data)
    arr = np.asarray(data)
    if arr.dtype == object:
        import pandas as pd

        return _column_from_series(name, pd.Series(data))
    return _column_from_array(name, arr)


class DataFrame:
    """Immutable named-column table (reference dataset/dataset.hpp:1953)."""

    __slots__ = ("_columns", "_names", "_num_rows", "_dev_cache")

    def __init__(self, columns: Sequence[Column]):
        names = [c.name for c in columns]
        if len(set(names)) != len(names):
            raise ValueError("Duplicate column names in DataFrame")
        nrows = {len(c.values) for c in columns}
        if len(nrows) > 1:
            raise ValueError(f"Columns have inconsistent lengths: {nrows}")
        object.__setattr__(self, "_columns", {c.name: c for c in columns})
        object.__setattr__(self, "_names", list(names))
        object.__setattr__(self, "_num_rows", nrows.pop() if nrows else 0)
        object.__setattr__(self, "_dev_cache", {})

    @classmethod
    def _from_float_arrays(cls, names, arrays, nrows) -> "DataFrame":
        """Internal unchecked constructor: float64 1-D arrays, unique names.
        Used by hot sampling paths where the generic ctor's validation is
        measurable (the arrays come from our own kernels)."""
        self = object.__new__(cls)
        object.__setattr__(
            self,
            "_columns",
            {n: Column(n, a) for n, a in zip(names, arrays)},
        )
        object.__setattr__(self, "_names", list(names))
        object.__setattr__(self, "_num_rows", nrows)
        object.__setattr__(self, "_dev_cache", {})
        return self

    # ------------------------------------------------------------------ build
    @staticmethod
    def wrap(obj) -> "DataFrame":
        """Accept our DataFrame, a pandas DataFrame, a pyarrow RecordBatch/Table,
        or a dict of columns (reference accepts pandas/pyarrow via the Arrow
        PyCapsule interface, util/arrow_types.cpp)."""
        if isinstance(obj, DataFrame):
            return obj
        pd = _loaded("pandas")
        if pd is not None and isinstance(obj, pd.DataFrame):
            return DataFrame.from_pandas(obj)
        if isinstance(obj, dict):
            return DataFrame([_column_from_object(k, v) for k, v in obj.items()])
        # anything speaking the Arrow PyCapsule C data interface — pyarrow
        # RecordBatch/Table, polars, duckdb results, ... (reference
        # util/arrow_types.cpp, CHANGELOG v0.5.0)
        if hasattr(obj, "__arrow_c_stream__") or hasattr(
            obj, "__arrow_c_array__"
        ):
            return DataFrame.from_arrow(obj)
        if hasattr(obj, "to_pandas"):
            return DataFrame.from_pandas(obj.to_pandas())
        raise TypeError(f"Cannot interpret {type(obj)!r} as DataFrame")

    @staticmethod
    def from_arrow(obj) -> "DataFrame":
        """Ingest via the Arrow PyCapsule interface without a pandas round
        trip; null-free numeric columns are zero-copy views of the Arrow
        buffers (reference util/arrow_types.cpp)."""
        from .arrow_interop import column_from_pa, pa

        if isinstance(obj, pa.RecordBatch):
            table = pa.Table.from_batches([obj])
        elif isinstance(obj, pa.Table):
            table = obj
        elif hasattr(obj, "__arrow_c_stream__"):
            table = pa.table(obj)
        else:  # __arrow_c_array__
            table = pa.Table.from_batches([pa.record_batch(obj)])
        return DataFrame(
            [
                column_from_pa(str(name), table.column(i))
                for i, name in enumerate(table.column_names)
            ]
        )

    @staticmethod
    def from_pandas(df) -> "DataFrame":
        # bulk fast path: homogeneous float frames convert with ONE
        # to_numpy instead of per-column pandas item access (the per-call
        # conversion cost dominates small fit/logl pipelines). Block-level
        # dtype probing avoids materializing the df.dtypes Series, which
        # alone costs more than the whole conversion for small frames.
        mgr = getattr(df, "_mgr", None)
        blocks = getattr(mgr, "blocks", None)
        if blocks is not None:
            dtypes = [b.dtype for b in blocks]
        else:
            dtypes = df.dtypes.to_numpy()
        if len(dtypes) and all(d == np.float64 for d in dtypes):
            vals = df.to_numpy()
            return DataFrame(
                [
                    Column(str(c), vals[:, i])
                    for i, c in enumerate(df.columns)
                ]
            )
        return DataFrame([_column_from_object(str(c), df[c]) for c in df.columns])

    def to_pandas(self):
        import pandas as pd

        out = {}
        for name in self._names:
            col = self._columns[name]
            if col.is_discrete:
                out[name] = pd.Categorical.from_codes(
                    col.values, categories=list(col.categories)
                )
            else:
                out[name] = col.values
        return pd.DataFrame(out)

    # ------------------------------------------------------------------ basic
    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    @property
    def num_columns(self) -> int:
        return len(self._names)

    def column_names(self) -> list[str]:
        return list(self._names)

    names = column_names

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def col(self, name: str) -> Column:
        try:
            return self._columns[name]
        except KeyError:
            raise KeyError(f"Column '{name}' not present in DataFrame") from None

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.col(key)
        return self.loc(key)

    def loc(self, cols) -> "DataFrame":
        """Column selection by name / index / list thereof
        (reference dataset/dataset.hpp:854-875)."""
        if isinstance(cols, (str, int)):
            cols = [cols]
        selected = []
        for c in cols:
            if isinstance(c, int):
                selected.append(self._columns[self._names[c]])
            else:
                selected.append(self.col(c))
        return DataFrame(selected)

    # ------------------------------------------------------------------ types
    def is_discrete(self, *names: str) -> bool:
        return all(self.col(n).is_discrete for n in self._expand(names))

    def is_continuous(self, *names: str) -> bool:
        return all(self.col(n).is_continuous for n in self._expand(names))

    def continuous_columns(self) -> list[str]:
        return [n for n in self._names if self._columns[n].is_continuous]

    def discrete_columns(self) -> list[str]:
        return [n for n in self._names if self._columns[n].is_discrete]

    def col_dtype(self, name: str):
        col = self.col(name)
        if col.is_discrete:
            return "categorical"
        return col.values.dtype

    def same_type(self, *names: str):
        """Enforce a single dtype across the given continuous columns and
        return it (reference dataset/dataset.hpp:878-905)."""
        names = self._expand(names)
        dtypes = {self.col_dtype(n) for n in names} if names else set()
        if len(dtypes) > 1:
            raise ValueError(
                f"Columns {list(names)} have different types: {sorted(map(str, dtypes))}"
            )
        return dtypes.pop() if dtypes else np.dtype(np.float64)

    def _expand(self, names) -> list[str]:
        out: list[str] = []
        for n in names:
            if isinstance(n, str):
                out.append(n)
            elif isinstance(n, Iterable):
                out.extend(n)
            else:
                out.append(n)
        return out

    # ------------------------------------------------------------------ nulls
    def combined_mask(self, *names: str) -> np.ndarray:
        """Boolean validity mask: True where *all* given columns are non-null
        (reference ``combined_bitmap``, dataset/dataset.hpp:79). Per-column
        validity is cached (columns are immutable): constraint searches
        call this thousands of times over the same columns."""
        names = self._expand(names)
        if not names:
            names = self._names
        cache = self._dev_cache
        mask = np.ones(self._num_rows, dtype=bool)
        for n in names:
            key = ("validmask", n)
            vm = cache.get(key)
            if vm is None:
                vm = ~self.col(n).null_mask()
                cache[key] = vm
            mask &= vm
        return mask

    def null_count(self, *names: str) -> int:
        return self._num_rows - int(self.combined_mask(*names).sum())

    def valid_rows(self, *names: str) -> int:
        """Number of rows where all given columns are non-null
        (reference dataset/dataset.hpp:80)."""
        return int(self.combined_mask(*names).sum())

    # ------------------------------------------------------------------ rows
    def take(self, indices) -> "DataFrame":
        indices = np.asarray(indices)
        cols = []
        for n in self._names:
            c = self._columns[n]
            cols.append(Column(n, c.values[indices], c.categories))
        return DataFrame(cols)

    def head(self, n: int) -> "DataFrame":
        return self.take(np.arange(min(n, self._num_rows)))

    def tail(self, n: int) -> "DataFrame":
        n = min(n, self._num_rows)
        return self.take(np.arange(self._num_rows - n, self._num_rows))

    def filter_valid(self, *names: str) -> "DataFrame":
        """Drop rows that are null in any of the given columns."""
        mask = self.combined_mask(*names)
        return self.take(np.nonzero(mask)[0])

    def rename(self, mapping: dict) -> "DataFrame":
        return DataFrame(
            [self._columns[n].rename(mapping.get(n, n)) for n in self._names]
        )

    @staticmethod
    def concat_columns(*dfs: "DataFrame") -> "DataFrame":
        cols = []
        for df in dfs:
            for n in df._names:
                cols.append(df._columns[n])
        return DataFrame(cols)

    # ------------------------------------------------------------------ numeric
    def to_numpy(
        self,
        cols: Sequence[str] | None = None,
        *,
        add_ones: bool = False,
        drop_null: bool = True,
        dtype=None,
    ) -> np.ndarray:
        """Dense float matrix (rows × cols) — reference ``to_eigen``
        (dataset/dataset.hpp:238-335). ``drop_null`` removes rows with a null in
        any selected column (pairwise deletion); ``add_ones`` prepends an
        intercept column for regression."""
        if cols is None:
            cols = self.continuous_columns()
        arrays = []
        for n in cols:
            c = self.col(n)
            if c.is_discrete:
                raise ValueError(f"Column '{n}' is discrete; expected continuous")
            arrays.append(c.values)
        if dtype is None:
            dtype = self.same_type(*cols) if cols else np.float64
            if dtype == "categorical":
                raise ValueError("categorical columns in to_numpy")
        mat = (
            np.column_stack([a.astype(dtype, copy=False) for a in arrays])
            if arrays
            else np.empty((self._num_rows, 0), dtype=dtype)
        )
        if drop_null and arrays:
            mask = self.combined_mask(*cols)
            mat = mat[mask]
        if add_ones:
            mat = np.column_stack([np.ones(len(mat), dtype=dtype), mat])
        return mat

    def codes(self, name: str) -> np.ndarray:
        c = self.col(name)
        if not c.is_discrete:
            raise ValueError(f"Column '{name}' is not discrete")
        return c.values

    def categories(self, name: str) -> tuple:
        c = self.col(name)
        if not c.is_discrete:
            raise ValueError(f"Column '{name}' is not discrete")
        return c.categories

    def cardinality(self, name: str) -> int:
        return len(self.categories(name))

    def min(self, name: str):
        """Null-skipping column minimum (reference dataset.hpp:111-129:
        +inf when every row is null)."""
        c = self.col(name)
        if c.is_discrete:
            raise ValueError(f"Column '{name}' is discrete; min is undefined")
        vals = c.values
        if np.issubdtype(vals.dtype, np.floating):
            out = np.fmin.reduce(vals, initial=np.inf)
            return vals.dtype.type(out)
        return vals.min()

    def max(self, name: str):
        """Null-skipping column maximum (reference dataset.hpp:137-155:
        -inf when every row is null)."""
        c = self.col(name)
        if c.is_discrete:
            raise ValueError(f"Column '{name}' is discrete; max is undefined")
        vals = c.values
        if np.issubdtype(vals.dtype, np.floating):
            out = np.fmax.reduce(vals, initial=-np.inf)
            return vals.dtype.type(out)
        return vals.max()

    # statistics used by BGe / LinearCorrelation (reference dataset.hpp:167-495)
    def means(self, cols: Sequence[str] | None = None) -> np.ndarray:
        mat = self.to_numpy(cols, drop_null=True, dtype=np.float64)
        return mat.mean(axis=0)

    def cov(self, cols: Sequence[str] | None = None) -> np.ndarray:
        """Unbiased covariance over jointly-valid rows (reference dataset.hpp:342)."""
        mat = self.to_numpy(cols, drop_null=True, dtype=np.float64)
        return np.cov(mat, rowvar=False, ddof=1).reshape(mat.shape[1], mat.shape[1])

    def sse(self, cols: Sequence[str] | None = None) -> np.ndarray:
        mat = self.to_numpy(cols, drop_null=True, dtype=np.float64)
        centred = mat - mat.mean(axis=0, keepdims=True)
        return centred.T @ centred

    # ------------------------------------------------------------------ device
    def device_matrix(self, cols: Sequence[str], dtype=None, device=None):
        """(values, valid_mask) as torch tensors of shape num_rows × k on
        ``device`` (default: :func:`default_device`).

        Nulls are *kept* (NaN replaced by 0.0 in values) and reported through
        ``valid_mask``; device kernels apply the mask in their reductions. This
        replaces the reference's null-row dropping with a static-shape scheme.
        Cached per (cols, dtype, device).
        """
        cols = tuple(cols)
        device = resolve_device(device)
        if dtype is None:
            dt = self.same_type(*cols) if cols else np.float64
            dtype = np.float64 if dt == "categorical" else dt
        key = (cols, np.dtype(dtype).name, str(device))
        cached = self._dev_cache.get(key)
        if cached is not None:
            return cached
        mat = self.to_numpy(cols, drop_null=False, dtype=dtype)
        values = host_to_device(np.nan_to_num(mat, nan=0.0), dtype, device)
        valid = host_to_device(
            np.column_stack([~self.col(c).null_mask() for c in cols])
            if cols
            else np.ones((self._num_rows, 0)),
            dtype,
            device,
        )
        out = (values, valid)
        self._dev_cache[key] = out
        return out

    def device_codes(self, cols: Sequence[str], device=None):
        """Discrete codes as an int32 tensor on ``device`` (null = -1)."""
        cols = tuple(cols)
        device = resolve_device(device)
        key = (cols, "codes", str(device))
        cached = self._dev_cache.get(key)
        if cached is not None:
            return cached
        mat = (
            np.column_stack([self.codes(c) for c in cols])
            if cols
            else np.empty((self._num_rows, 0), np.int32)
        )
        out = host_to_device(mat, np.int32, device)
        self._dev_cache[key] = out
        return out

    # ------------------------------------------------------------------ arrow
    @property
    def schema(self):
        """pyarrow Schema of the table (reference exposes the RecordBatch
        schema directly, dataset/dataset.hpp:1953)."""
        from .arrow_interop import column_pa_type, pa

        return pa.schema(
            [pa.field(n, column_pa_type(self._columns[n])) for n in self._names]
        )

    def column(self, i):
        """i-th column as a pyarrow Array (RecordBatch.column parity)."""
        if isinstance(i, str):
            name = i
        else:
            name = self._names[i]
        from .arrow_interop import column_to_pa

        return column_to_pa(self._columns[name])

    @property
    def columns(self):
        return [self.column(i) for i in range(len(self._names))]

    def record_batch(self):
        """Whole table as a pyarrow RecordBatch."""
        from .arrow_interop import pa

        return pa.RecordBatch.from_arrays(self.columns, schema=self.schema)

    def __arrow_c_stream__(self, requested_schema=None):
        """Arrow PyCapsule export — lets any Arrow consumer (pyarrow, polars,
        duckdb) read this table without copies of the column buffers."""
        return self.record_batch().__arrow_c_stream__(requested_schema)

    def __arrow_c_array__(self, requested_schema=None):
        return self.record_batch().__arrow_c_array__(requested_schema)

    def equals(self, other) -> bool:
        """Structural equality: same names, types, categories and values, with
        nulls comparing equal (Arrow RecordBatch.equals semantics)."""
        other = DataFrame.wrap(other)
        if self._names != other._names or self._num_rows != other._num_rows:
            return False
        for n in self._names:
            a, b = self._columns[n], other._columns[n]
            if a.is_discrete != b.is_discrete:
                return False
            if a.is_discrete:
                if a.categories != b.categories or not np.array_equal(a.values, b.values):
                    return False
            elif a.values.dtype != b.values.dtype or not np.array_equal(
                a.values, b.values, equal_nan=np.issubdtype(a.values.dtype, np.floating)
            ):
                return False
        return True

    # ------------------------------------------------------------------ misc
    def __repr__(self) -> str:
        parts = []
        for n in self._names:
            c = self._columns[n]
            kind = "categorical" if c.is_discrete else str(c.values.dtype)
            parts.append(f"{n}: {kind}")
        return f"DataFrame({self._num_rows} rows; " + ", ".join(parts) + ")"
