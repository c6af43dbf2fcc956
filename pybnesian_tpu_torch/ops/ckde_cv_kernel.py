"""Streaming joint-and-marginal logsumexp of CV-CKDE (family, fold) programs.

Replaces the Pallas TPU kernel ``_ckde_cv_kernel`` of
``pybnesian_tpu/ops/pallas_kde.py`` (launched by ``pallas_ckde_cv_pairs``).
For each of G = F·K (family, fold) programs and each test row i it computes

    LSE_j(−½‖te_i − tr_j‖² + neg_j)
      − LSE_j(−½‖te_i − tr_j‖² + ½(zte_i − ztr_j)² + neg_j)

where LSE is logsumexp over the program's train rows, ``neg_j`` is 0 or
−inf (padding / null rows), and the marginal term is the constant
``lm_const[g]`` (= log n_eff) for evidence-free programs (``no_ev[g]``).

What lives here:

- :func:`ckde_cv_pairs_reference`, the plain torch version;
- :func:`ckde_cv_pairs`, the wrapper: plain version for CPU tensors, the
  CUDA kernel (``pybnesian_tpu_torch/csrc/ckde_cv.cu``) for CUDA tensors,
  with a launch counter ``ckde_cv_pairs.launches``;
- :func:`_launch_plan`, the launch plan of both kernels of that source
  (this one and ``kde_logl``'s): test rows per thread, train rows per
  group, and the split of the train axis across a thread-block cluster;
  :func:`reduction_leaves`, the fixed leaves of the train axis
  (:func:`~.cuda_build.leaf_count`) that the split spreads over the
  cluster;
- the ctypes binding of that kernel (built at first use by
  :mod:`.cuda_build`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .cuda_build import MAX_SPLIT, check_tensors, cluster_split, leaf_count

__all__ = [
    "ckde_cv_pairs",
    "ckde_cv_pairs_reference",
    "MAX_DPAD",
]

#: widest family (columns per program) the kernel is instantiated for
MAX_DPAD = 16
# The launch plan's limits; each mirrors a constant of csrc/ckde_cv.cu (the
# cluster's, MAX_SPLIT, is csrc/common.cuh's, imported above).
#: threads per block (kThreads)
THREADS = 128
#: R, test rows per thread of the templated widths (kRowsPerThread)
ROWS_PER_THREAD = 2
#: T, train rows per group of the templated widths (kGroup)
GROUP = 16
#: T of the KDE kernel's runtime-width variant (kWideGroup)
WIDE_GROUP = 32
#: train rows per shared-memory tile (kTile)
TILE = 256
#: blocks per SM that the plan aims for, splitting the train axis to get
#: them. Measured on the H100 (chip_smoke.py's split sweep, PERF.md): the
#: grids of 40 to 600 blocks ran fastest split 8 ways, the CV path's 6,000
#: blocks at 100k rows 2 ways, 2% faster than unsplit and 5% faster than
#: split 8 ways; 64 per SM picks each of those
TARGET_BLOCKS_PER_SM = 64
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


def reduction_leaves(ntr, d):
    """P, the leaves of one program's train rows in the kernels of
    ``csrc/ckde_cv.cu``: each leaf is swept from a fresh logsumexp pair, and
    a test row's P leaf pairs merge in a balanced binary tree. Widths up to
    :data:`MAX_DPAD` take :func:`~.cuda_build.leaf_count` (ntr) leaves;
    wider programs (the KDE kernel's runtime-width variant) one. A function
    of (ntr, d) alone: the reduction order of a (program, test row), and so
    its float32 result, does not depend on G, on the other programs of the
    launch, or on the split."""
    return 1 if d > MAX_DPAD else leaf_count(ntr)


def _launch_plan(G, ntr, nte, d, sm_count):
    """``(R, T, S)`` for one launch of a kernel of ``csrc/ckde_cv.cu`` on G
    programs of ntr train and nte test rows of width d, on a card with
    ``sm_count`` SMs: R test rows per thread, T train rows per group, and
    S blocks of a thread-block cluster sharing each test tile's
    :func:`reduction_leaves` (S = 1: no split).

    Widths up to :data:`MAX_DPAD` take R = :data:`ROWS_PER_THREAD` and
    T = :data:`GROUP`; S is :func:`~.cuda_build.cluster_split`'s for
    :data:`TARGET_BLOCKS_PER_SM` blocks per SM. Wider programs (the KDE
    kernel's runtime-width variant) take one row per thread, T =
    :data:`WIDE_GROUP` and no split."""
    if d > MAX_DPAD:
        return 1, WIDE_GROUP, 1
    tiles = max(1, G * -(-nte // (THREADS * ROWS_PER_THREAD)))
    split = cluster_split(tiles, TARGET_BLOCKS_PER_SM * sm_count,
                          reduction_leaves(ntr, d))
    return ROWS_PER_THREAD, GROUP, split


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_args(jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const):
    if not (isinstance(jtr, torch.Tensor) and isinstance(jte, torch.Tensor)):
        raise TypeError("jtr and jte must be torch.Tensors")
    if jtr.dim() != 3 or jte.dim() != 3:
        raise ValueError("jtr and jte must be (G, rows, dpad)")
    G, ntr, dpad = jtr.shape
    nte = jte.shape[1]
    check_tensors(
        {"jtr": jtr, "neg": neg, "zv_tr": zv_tr, "jte": jte, "zv_te": zv_te,
         "no_ev": no_ev, "lm_const": lm_const}, torch.float32,
        {"jtr": (G, ntr, dpad), "neg": (G, ntr), "zv_tr": (G, ntr),
         "jte": (G, nte, dpad), "zv_te": (G, nte), "no_ev": (G,),
         "lm_const": (G,)}, jtr.device)
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
    if G == 0 or nte == 0:
        return torch.empty((G, nte), dtype=torch.float32, device=jtr.device)
    out = _launch(jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const,
                  _launch_plan(G, ntr, nte, dpad, _sm_count(jtr.device)))
    ckde_cv_pairs.launches += 1
    return out


ckde_cv_pairs.launches = 0


def _launch(jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const, plan):
    """One launch of the kernel with launch plan ``plan`` on checked CUDA
    arguments with G, nte >= 1; returns ``out``. Counts nothing: the
    wrapper counts its own launches."""
    G, ntr, dpad = jtr.shape
    nte = jte.shape[1]
    out = torch.empty((G, nte), dtype=torch.float32, device=jtr.device)
    with torch.cuda.device(jtr.device):
        stream = torch.cuda.current_stream(jtr.device).cuda_stream
        err = _load_library().ckde_cv_pairs_f32(
            jtr.data_ptr(), neg.data_ptr(), zv_tr.data_ptr(),
            jte.data_ptr(), zv_te.data_ptr(), no_ev.data_ptr(),
            lm_const.data_ptr(), out.data_ptr(), G, ntr, nte, dpad, *plan,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ckde_cv_pairs kernel launch failed (plan {plan}): "
            f"CUDA error {err}"
        )
    return out


@functools.cache
def _load_library():
    lib = cuda_build.load("ckde_cv.cu")
    fn = lib.ckde_cv_pairs_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib
