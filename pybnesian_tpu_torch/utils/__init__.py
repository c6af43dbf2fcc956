"""Small host-side utilities shared across the framework.

TPU-native rebuild of the reference's ``pybnesian/util/`` layer
(reference: util/math_constants.hpp, util/temporal.hpp, util/combinations.hpp).
Only host-side combinatorics and constants live here; all numeric kernels are
in :mod:`pybnesian_tpu.ops`.
"""

from .util import (
    MACHINE_TOL,
    temporal_name,
    temporal_names,
    temporal_slice_names,
    Combinations,
    Combinations2Sets,
    AllSubsets,
)

__all__ = [
    "MACHINE_TOL",
    "temporal_name",
    "temporal_names",
    "temporal_slice_names",
    "Combinations",
    "Combinations2Sets",
    "AllSubsets",
]
