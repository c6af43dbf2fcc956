"""Streaming joint-and-marginal logsumexp of CV-CKDE (family, fold) programs.

Replaces the Pallas TPU kernel ``_ckde_cv_kernel`` of
``pybnesian_tpu/ops/pallas_kde.py`` (launched by ``pallas_ckde_cv_pairs``).
For each of G = F·K (family, fold) programs and each test row i it computes

    LSE_j(−½‖te_i − tr_j‖² + neg_j)
      − LSE_j(−½‖te_i − tr_j‖² + ½(zte_i − ztr_j)² + neg_j)

where LSE is logsumexp over the program's train rows, ``neg_j`` is 0 or
−inf (padding / null rows), and the marginal term is the constant
``lm_const[g]`` (= log n_eff) for evidence-free programs (``no_ev[g]``).

Three things live here:

- :func:`ckde_cv_pairs_reference`, the plain torch version;
- :func:`ckde_cv_pairs`, the wrapper: plain version for CPU tensors, the
  CUDA kernel (``pybnesian_tpu_torch/csrc/ckde_cv.cu``) for CUDA tensors,
  with a launch counter ``ckde_cv_pairs.launches``;
- the ctypes binding of that kernel (built at first use by
  :mod:`.cuda_build`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

__all__ = [
    "ckde_cv_pairs",
    "ckde_cv_pairs_reference",
    "MAX_DPAD",
]

#: widest family (columns per program) the kernel is instantiated for
MAX_DPAD = 16
#: the grid's y axis holds the programs
_MAX_PROGRAMS = 65535
# elements of one (programs, test chunk, train rows) block of the plain
# version: 2**25 float32 elements keep its five live temporaries under 1 GB
_REFERENCE_BLOCK = 1 << 25


def ckde_cv_pairs_reference(jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const):
    """Plain torch version of the kernel, same arguments and result as
    :func:`ckde_cv_pairs`, on any device. Distances are direct per-column
    differences, as in the kernel; test rows go in chunks so that no more
    than about 1 GB is live at once."""
    G, ntr, dpad = jtr.shape
    nte = jte.shape[1]
    chunk = max(1, _REFERENCE_BLOCK // max(G * ntr, 1))
    out = torch.empty((G, nte), dtype=jtr.dtype, device=jtr.device)
    for s in range(0, nte, chunk):
        te = jte[:, s: s + chunk]
        d2 = torch.zeros((G, te.shape[1], ntr), dtype=jtr.dtype,
                         device=jtr.device)
        for k in range(dpad):
            diff = te[:, :, k, None] - jtr[:, None, :, k]
            d2 += diff * diff
        lj = -0.5 * d2 + neg[:, None, :]
        vd = zv_te[:, s: s + chunk, None] - zv_tr[:, None, :]
        lm = lj + 0.5 * vd * vd
        lse_j = torch.logsumexp(lj, dim=2)
        lse_m = torch.where(
            no_ev[:, None] > 0.5, lm_const[:, None],
            torch.logsumexp(lm, dim=2),
        )
        out[:, s: s + chunk] = lse_j - lse_m
    return out


def _check_args(jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const):
    tensors = {"jtr": jtr, "neg": neg, "zv_tr": zv_tr, "jte": jte,
               "zv_te": zv_te, "no_ev": no_ev, "lm_const": lm_const}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != jtr.device:
            raise ValueError(
                f"{name} is on {t.device}, jtr on {jtr.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if jtr.dim() != 3 or jte.dim() != 3:
        raise ValueError("jtr and jte must be (G, rows, dpad)")
    G, ntr, dpad = jtr.shape
    nte = jte.shape[1]
    expected = {"neg": (G, ntr), "zv_tr": (G, ntr), "jte": (G, nte, dpad),
                "zv_te": (G, nte), "no_ev": (G,), "lm_const": (G,)}
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(tensors[name].shape)}, "
                f"expected {shape}"
            )
    if not 1 <= dpad <= MAX_DPAD:
        raise ValueError(f"dpad {dpad} outside 1..{MAX_DPAD}")
    return G, ntr, nte, dpad


def ckde_cv_pairs(jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const):
    """(G, nte) per-test-row ``logsumexp_joint − logsumexp_marg`` (without
    lognorm constants) for G (family, fold) programs.

    jtr: (G, ntr, dpad) whitened train rows, evidence first, variable last;
    neg, zv_tr: (G, ntr) 0/−inf row mask and whitened variable coordinate;
    jte: (G, nte, dpad); zv_te: (G, nte); no_ev: (G,) 1.0 for evidence-free
    programs, whose marginal term is ``lm_const`` (G,). All float32 and
    contiguous, 1 ≤ dpad ≤ :data:`MAX_DPAD`; ntr and nte are free.

    CPU tensors take :func:`ckde_cv_pairs_reference`. CUDA tensors launch
    the kernel, counted in ``ckde_cv_pairs.launches``, or raise."""
    G, ntr, nte, dpad = _check_args(jtr, neg, zv_tr, jte, zv_te, no_ev,
                                    lm_const)
    if jtr.device.type == "cpu":
        return ckde_cv_pairs_reference(jtr, neg, zv_tr, jte, zv_te, no_ev,
                                       lm_const)
    if jtr.device.type != "cuda":
        raise ValueError(f"no ckde_cv_pairs kernel for {jtr.device}")
    if G > _MAX_PROGRAMS:
        raise ValueError(f"{G} programs exceed the grid's {_MAX_PROGRAMS}")
    if max(ntr, nte) * dpad >= 2**31:
        raise ValueError("ntr and nte must fit 32-bit row offsets")
    out = torch.empty((G, nte), dtype=torch.float32, device=jtr.device)
    if G == 0 or nte == 0:
        return out
    lib = _load_library()
    with torch.cuda.device(jtr.device):
        stream = torch.cuda.current_stream(jtr.device).cuda_stream
        err = lib.ckde_cv_pairs_f32(
            jtr.data_ptr(), neg.data_ptr(), zv_tr.data_ptr(),
            jte.data_ptr(), zv_te.data_ptr(), no_ev.data_ptr(),
            lm_const.data_ptr(), out.data_ptr(), G, ntr, nte, dpad, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ckde_cv_pairs kernel launch failed: CUDA error {err}"
        )
    ckde_cv_pairs.launches += 1
    return out


ckde_cv_pairs.launches = 0


@functools.cache
def _load_library():
    lib = cuda_build.load("ckde_cv.cu")
    fn = lib.ckde_cv_pairs_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib
