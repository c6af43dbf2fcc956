"""pyarrow interop: DataType mapping and Array construction.

The reference exposes Arrow types throughout its API (``Factor.data_type()``
returns an ``arrow::DataType``, ``sample()`` returns Arrow arrays — reference
factors/factors.hpp:118-198, dataset/dataset.hpp:28-66). We keep numpy as the
host substrate but speak real pyarrow types at the API boundary.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "pa",
    "np_to_pa_type",
    "dictionary_type",
    "column_pa_type",
    "column_to_pa",
    "column_from_pa",
]

import pyarrow as pa


def np_to_pa_type(dtype) -> "pa.DataType":
    """numpy dtype → pyarrow DataType."""
    return pa.from_numpy_dtype(np.dtype(dtype))


def dictionary_type(cardinality: int) -> "pa.DataType":
    """Dictionary type with the smallest index width that can hold
    ``cardinality`` categories (reference DiscreteFactor.hpp:77-88: indices
    0..card-1, so int8 up to 128 categories, int16 up to 32768)."""
    if cardinality <= 128:
        index = pa.int8()
    elif cardinality <= 32768:
        index = pa.int16()
    else:
        index = pa.int32()
    return pa.dictionary(index, pa.string())


def column_pa_type(col) -> "pa.DataType":
    """pyarrow DataType of a data.Column."""
    if col.is_discrete:
        return dictionary_type(len(col.categories))
    return np_to_pa_type(col.values.dtype)


def column_from_pa(name: str, arr):
    """pyarrow Array/ChunkedArray → data.Column without a pandas round trip
    (the reference imports Arrow data through the PyCapsule C data interface,
    util/arrow_types.cpp; this is the numpy-substrate analogue). Null-free
    numeric arrays are ZERO-COPY views of the Arrow buffers."""
    from .dataframe import Column

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    ty = arr.type
    if pa.types.is_dictionary(ty):
        indices = arr.indices
        codes = np.asarray(
            indices.fill_null(-1).to_numpy(zero_copy_only=False),
            dtype=np.int32,
        )
        cats = tuple(str(c) for c in arr.dictionary.to_pylist())
        return Column(name, codes, cats)
    if pa.types.is_string(ty) or pa.types.is_large_string(ty):
        return column_from_pa(name, arr.dictionary_encode())
    if pa.types.is_boolean(ty):
        return column_from_pa(
            name, arr.cast(pa.string()).dictionary_encode()
        )
    if pa.types.is_floating(ty):
        if arr.null_count == 0:
            vals = arr.to_numpy(zero_copy_only=True)
        else:
            vals = arr.to_numpy(zero_copy_only=False)  # nulls -> NaN
        if vals.dtype == np.float16:
            vals = vals.astype(np.float32)
        return Column(name, vals)
    if pa.types.is_integer(ty):
        if arr.null_count == 0:
            return Column(
                name, arr.to_numpy(zero_copy_only=True).astype(np.int64)
            )
        # nullable ints cannot stay integral on the numpy substrate
        return Column(
            name, arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
        )
    raise TypeError(f"Unsupported Arrow type {ty} for column '{name}'")


def column_to_pa(col) -> "pa.Array":
    """data.Column → pyarrow Array (DictionaryArray for categoricals, with
    nulls mapped from NaN / code -1)."""
    if col.is_discrete:
        ty = dictionary_type(len(col.categories))
        codes = col.values
        mask = codes < 0
        indices = pa.array(
            codes.astype(np.dtype(ty.index_type.to_pandas_dtype())),
            mask=mask if mask.any() else None,
        )
        return pa.DictionaryArray.from_arrays(indices, pa.array(list(col.categories)))
    vals = col.values
    if np.issubdtype(vals.dtype, np.floating):
        mask = np.isnan(vals)
        return pa.array(vals, mask=mask if mask.any() else None)
    return pa.array(vals)
