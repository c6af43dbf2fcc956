"""Device and dtype policy of the torch port.

Replaces ``pybnesian_tpu/runtime/config.py``. The port runs on an NVIDIA
GPU: with no device chosen, every entry point places its tensors on
``cuda``, and raises when no GPU is visible. The CPU is used only when the
caller asks for it, with a ``device=`` argument where an entry point takes
one, or process-wide with :func:`use_device` (which also covers the paths
that take no ``device``: fitted factors, ``model.logl``,
``DataFrame.device_matrix``). Data keep their own float dtype (float32 or
float64, the reference's float/double template split); this module only
maps numpy dtypes to torch ones.

Float32 matrix products stay in full FP32: the pairwise-distance identity
``‖a‖² + ‖b‖² − 2a·b`` and the small covariance / whitening products lose
the small distances that dominate a logsumexp when a product runs in TF32
(the same trap the JAX package avoids with ``Precision.HIGHEST``,
pybnesian_tpu/ops/kde.py ``_dot``). Importing this module switches TF32 off
for the process.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["default_device", "resolve_device", "visible_devices",
           "use_device", "torch_dtype", "numpy_dtype", "host_to_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}

# the device chosen through use_device; None: the card
_chosen: torch.device | None = None


class use_device:
    """Choose the device of every entry point that is given none, for the
    whole process: ``use_device("cpu")``. As a context manager the choice
    lasts for the ``with`` block and the previous one comes back after it:
    ``with use_device("cpu"): ...``. ``use_device(None)`` drops the
    choice (back to the card)."""

    def __init__(self, device):
        global _chosen
        self._previous = _chosen
        _chosen = torch.device(device) if device is not None else None

    def __enter__(self):
        return _chosen

    def __exit__(self, *exc):
        global _chosen
        _chosen = self._previous
        return False


def default_device() -> torch.device:
    """The device chosen with :func:`use_device`, else ``cuda``. Raises
    ``RuntimeError`` when nothing was chosen and no GPU is visible: the
    port never moves to the CPU on its own."""
    if _chosen is not None:
        return _chosen
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pybnesian_tpu_torch runs on an NVIDIA GPU and none is visible; "
            "to run on the CPU, ask for it: pass device='cpu' to the entry "
            "point, or call pybnesian_tpu_torch.use_device('cpu') first"
        )
    return torch.device("cuda")


def visible_devices() -> list[torch.device]:
    """The devices a mesh spans by default: every visible GPU, or the one
    device chosen with :func:`use_device` when that is not a GPU (the CPU).
    Raises as :func:`default_device` does."""
    device = default_device()
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; :func:`default_device` when None."""
    return torch.device(device) if device is not None else default_device()


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy dtype (float32/float64/int32/int64)."""
    return _TORCH_DTYPES[np.dtype(dtype)]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy dtype of a torch dtype (float32/float64/int32/int64)."""
    return next(k for k, v in _TORCH_DTYPES.items() if v == dtype)


def host_to_device(array, dtype, device=None) -> torch.Tensor:
    """A host array as a tensor of numpy dtype ``dtype`` on ``device`` (the
    default device): numpy casts it, torch only copies it. Letting
    ``torch.as_tensor`` cast float64 to float32 on the way cost ~50 ms of
    CPU per ``model.slogl`` at 10,000 rows on the H100 machine's host,
    where numpy's cast takes well under a millisecond."""
    return torch.from_numpy(np.ascontiguousarray(array, dtype=dtype)).to(
        resolve_device(device))
