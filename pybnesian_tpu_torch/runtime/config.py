"""Runtime configuration of the torch port: the dtype policy, device
discovery and the default mesh.

Counterpart of ``pybnesian_tpu/runtime/config.py`` (which replaced the
reference's ``OpenCLConfig`` singleton, opencl/opencl_config.hpp:120-292).
The device itself is chosen in :mod:`.device` (the card, unless the caller
asks for the CPU); this module reports it. The profiling hook, ``trace``,
lives in :mod:`.tracing` with the port's spans and counters, and is
exported here under the JAX package's name.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .device import default_device, visible_devices
from .distributed import rank_and_size
from .tracing import trace

__all__ = [
    "RuntimeConfig",
    "device_info",
    "default_mesh",
    "dtype_policy",
    "set_dtype_policy",
    "trace",
]


@dataclasses.dataclass
class RuntimeConfig:
    compute_dtype: np.dtype = np.dtype(np.float32)
    #: kept for parity with the JAX package; ``default_mesh`` reads it not
    mesh_axes: dict | None = None


_CONFIG = RuntimeConfig()


def dtype_policy() -> np.dtype:
    """Default compute dtype: float32. The port's kernels and torch ops
    follow the data's dtype, so this is the fallback only."""
    return _CONFIG.compute_dtype


def set_dtype_policy(dtype) -> None:
    _CONFIG.compute_dtype = np.dtype(dtype)


def device_info() -> dict:
    """Platform and device summary, with the JAX package's keys:
    ``backend`` is ``"cuda"`` on the card, ``"cpu"`` under
    ``use_device("cpu")``; ``devices`` are the ones a default mesh spans;
    the process index and count are the ``torch.distributed`` group's
    (0 and 1 without one)."""
    devices = visible_devices()
    rank, world = rank_and_size()
    return {
        "backend": default_device().type,
        "num_devices": len(devices),
        "devices": [str(d) for d in devices],
        "process_index": rank,
        "num_processes": world,
    }


def default_mesh():
    """1-D data mesh over every visible device."""
    from ..parallel import make_mesh

    return make_mesh({"data": len(visible_devices())})
