"""Device and dtype policy of the torch port.

Replaces ``pybnesian_tpu/runtime/config.py``: there is one accelerator, an
NVIDIA GPU when present, else the CPU. Data keep their own float dtype
(float32 or float64, the reference's float/double template split); this
module only maps numpy dtypes to torch ones.

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

__all__ = ["default_device", "torch_dtype", "host_to_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def default_device() -> torch.device:
    """``cuda`` when a GPU is visible, ``cpu`` otherwise."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy dtype (float32/float64/int32/int64)."""
    return _TORCH_DTYPES[np.dtype(dtype)]


def host_to_device(array, dtype, device=None) -> torch.Tensor:
    """A host array as a tensor of numpy dtype ``dtype`` on ``device`` (the
    default device): numpy casts it, torch only copies it. Letting
    ``torch.as_tensor`` cast float64 to float32 on the way cost ~50 ms of
    CPU per ``model.slogl`` at 10,000 rows on the H100 machine's host,
    where numpy's cast takes well under a millisecond."""
    return torch.from_numpy(np.ascontiguousarray(array, dtype=dtype)).to(
        device if device is not None else default_device())
