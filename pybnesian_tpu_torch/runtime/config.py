"""Runtime configuration of the torch port: the dtype policy, device
discovery, the default mesh and the profiling hook.

Counterpart of ``pybnesian_tpu/runtime/config.py`` (which replaced the
reference's ``OpenCLConfig`` singleton, opencl/opencl_config.hpp:120-292).
The device itself is chosen in :mod:`.device` (the card, unless the caller
asks for the CPU); this module reports it. ``trace`` annotates a region
with ``torch.profiler.record_function`` and, given a directory, writes a
Chrome trace of the region there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from .device import default_device, visible_devices
from .distributed import rank_and_size

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


@contextlib.contextmanager
def trace(name: str, log_dir: str | None = None):
    """Annotates the region as ``name`` (``torch.profiler.record_function``);
    with ``log_dir``, also profiles it (CPU activity, and CUDA activity when
    a card is visible) and writes its Chrome trace to
    ``log_dir/<name>.pt.trace.json``."""
    if log_dir is None:
        with torch.profiler.record_function(name):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))
