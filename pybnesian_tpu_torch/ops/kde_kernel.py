"""Streaming KDE log-likelihood of G programs in one launch.

Replaces the Pallas TPU kernel ``_kde_kernel`` of
``pybnesian_tpu/ops/pallas_kde.py`` (launched by ``pallas_kde_logl``). For
each program g and test row i it computes

    LSE_j(−½‖test[g, i] − train[g, j]‖²  over j with valid[g, j] > 0)
      + lognorm[g]

where LSE is logsumexp over the program's train rows. A fitted KDE is one
program; a CKDE factor's joint and marginal are two, the marginal's columns
zero-padded to the joint's width (zero columns add nothing to a distance).

- :func:`kde_logl_reference`, the plain torch version;
- :func:`kde_logl`, the wrapper: plain version for CPU tensors, the CUDA
  kernel (``kde_logl_f32`` in ``pybnesian_tpu_torch/csrc/ckde_cv.cu``) for
  CUDA tensors, with a launch counter ``kde_logl.launches``.

Unlike the Pallas kernel, whose running max starts at −inf, an all-invalid
first train block gives no NaN here: both versions give the logsumexp over
the valid rows (−inf where there is none).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

__all__ = ["kde_logl", "kde_logl_reference", "MAX_D"]

#: widest program the kernel takes (templated up to 16, runtime width above)
MAX_D = 256
_MAX_PROGRAMS = 65535
# elements of one (programs, test chunk, train rows) block of the plain
# version: 2**25 float32 elements keep its few live temporaries under 1 GB
_REFERENCE_BLOCK = 1 << 25


def kde_logl_reference(train, valid, test, lognorm):
    """Plain torch version of the kernel, same arguments and result as
    :func:`kde_logl`, on any device. Distances are direct per-column
    differences, as in the kernel; test rows go in chunks so that no more
    than about 1 GB is live at once."""
    G, ntr, d = train.shape
    nte = test.shape[1]
    neg = torch.where(valid > 0, 0.0, -torch.inf).to(train.dtype)
    chunk = max(1, _REFERENCE_BLOCK // max(G * ntr, 1))
    out = torch.empty((G, nte), dtype=train.dtype, device=train.device)
    for s in range(0, nte, chunk):
        te = test[:, s: s + chunk]
        d2 = torch.zeros((G, te.shape[1], ntr), dtype=train.dtype,
                         device=train.device)
        for k in range(d):
            diff = te[:, :, k, None] - train[:, None, :, k]
            d2 += diff * diff
        out[:, s: s + chunk] = torch.logsumexp(-0.5 * d2 + neg[:, None, :],
                                               dim=2)
    return out + lognorm[:, None]


def _check_args(train, valid, test, lognorm):
    tensors = {"train": train, "valid": valid, "test": test,
               "lognorm": lognorm}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != train.device:
            raise ValueError(f"{name} is on {t.device}, train on {train.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if train.dim() != 3 or test.dim() != 3:
        raise ValueError("train and test must be (G, rows, d)")
    G, ntr, d = train.shape
    nte = test.shape[1]
    expected = {"valid": (G, ntr), "test": (G, nte, d), "lognorm": (G,)}
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(tensors[name].shape)}, "
                f"expected {shape}"
            )
    if not 1 <= d <= MAX_D:
        raise ValueError(f"d {d} outside 1..{MAX_D}")
    return G, ntr, nte, d


def kde_logl(train, valid, test, lognorm):
    """(G, nte) per-test-row KDE log-likelihood of G programs.

    train: (G, ntr, d) whitened train rows; valid: (G, ntr), > 0 for a row
    that counts; test: (G, nte, d) whitened test rows; lognorm: (G,). All
    float32 and contiguous, 1 ≤ d ≤ :data:`MAX_D`; ntr and nte are free.

    CPU tensors take :func:`kde_logl_reference`. CUDA tensors launch the
    kernel, counted in ``kde_logl.launches``, or raise."""
    G, ntr, nte, d = _check_args(train, valid, test, lognorm)
    if train.device.type == "cpu":
        return kde_logl_reference(train, valid, test, lognorm)
    if train.device.type != "cuda":
        raise ValueError(f"no kde_logl kernel for {train.device}")
    if G > _MAX_PROGRAMS:
        raise ValueError(f"{G} programs exceed the grid's {_MAX_PROGRAMS}")
    if max(ntr, nte) * d >= 2**31:
        raise ValueError("ntr and nte must fit 32-bit row offsets")
    out = torch.empty((G, nte), dtype=torch.float32, device=train.device)
    if G == 0 or nte == 0:
        return out
    lib = _load_library()
    with torch.cuda.device(train.device):
        stream = torch.cuda.current_stream(train.device).cuda_stream
        err = lib.kde_logl_f32(
            train.data_ptr(), valid.data_ptr(), test.data_ptr(),
            lognorm.data_ptr(), out.data_ptr(), G, ntr, nte, d, stream,
        )
    if err != 0:
        raise RuntimeError(f"kde_logl kernel launch failed: CUDA error {err}")
    kde_logl.launches += 1
    return out


kde_logl.launches = 0


@functools.cache
def _load_library():
    lib = cuda_build.load("ckde_cv.cu")
    fn = lib.kde_logl_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib
