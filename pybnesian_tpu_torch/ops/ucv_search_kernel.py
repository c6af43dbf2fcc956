"""The UCV bandwidth search of B problems, on the card in one launch.

Replaces ``_device_minimize`` and ``ucv_minimize_batch`` of
``pybnesian_tpu/kde/ucv.py`` (:106, :171), which the JAX package runs as
one jitted program: ``nelder_mead_batch`` (``pybnesian_tpu/ops/
nelder_mead.py:24``, a ``lax.while_loop``) over the guarded UCV objective,
every evaluation of it inside the loop (no Pallas kernel). Each problem b
has training rows ``X[b]`` (N, d) with a validity mask and its row count,
and a start ``x0[b]``: vech(L) of the lower-triangular factor of the
bandwidth (``diagonal``: the d square roots of a diagonal one). Nelder–Mead
minimizes

    score(L) = e(l₂ₕ) + 2·s2h·e(l₂ₕ)/N − 4·sh·e(lₕ)/(N − 1)

over L, s2h and sh the pair sums of the rows whitened by L⁻¹ (the same as
:func:`~.kde.ucv_pair_sums_batch`), lₕ = −Σ log|Lᵢᵢ| − d/2·log 2π, l₂ₕ = lₕ
− d/2·log 2; a bad point (determinant or score off the guard rails, NaN)
scores ``f_start + 1e-7``.

- :func:`ucv_search_reference`, the plain version: the host loop of
  :func:`~.nelder_mead.nelder_mead_batch`, whose evaluations call
  ``ucv_pair_sums_batch`` (on the card in float32 the pair-sums kernel, a
  launch an evaluation, two device reads an iteration);
- :func:`ucv_search_cuda`, the wrapper: the plain version for CPU tensors,
  the kernel ``ucv_search_f32`` of ``pybnesian_tpu_torch/csrc/ucv_pairs.cu``
  for CUDA tensors, with a launch counter ``ucv_search_cuda.launches``;
- :func:`ucv_search_evaluate` and :func:`ucv_objective_reference`: the
  kernel's objective (and its pair sums and whitened rows) at given
  points, and the plain objective there, to hold one against the other.

Both searches return a :class:`UcvSearchResult` on the inputs' device.
A problem whose start scores NaN is done before the first iteration, in
both. On the card a problem's result is the same bits alone and in any
batch, and the host reads nothing until the search has ended.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import MACHINE_TOL
from . import cuda_build
from .kde import ucv_pair_sums_batch
from .nelder_mead import nelder_mead_batch_counted

__all__ = ["UcvSearchResult", "ucv_search_cuda", "ucv_search_reference",
           "ucv_search_evaluate", "ucv_objective_reference", "vech_indices"]

_LOG_2PI = math.log(2 * math.pi)
_LOG_2 = math.log(2.0)


class UcvSearchResult(NamedTuple):
    """``x`` (B, nv) the best vertex of each problem, ``f`` (B,) its
    guarded objective, ``start`` (B,) the start's score, ``iterations``
    (B,) int32, ``evaluations`` a 0-d int32 tensor: the batched objective
    calls, counted as the plain loop makes them (1 for the starts, nv + 1
    for the simplex, 2 an iteration, nv more when some problem shrinks),
    ``lane_evaluations`` (B,) int32: the evaluations each problem's own
    search needed (nv + 1 for the simplex, then per iteration the
    reflection, the second point unless the reflection was kept, and nv
    when it shrank)."""

    x: torch.Tensor
    f: torch.Tensor
    start: torch.Tensor
    iterations: torch.Tensor
    evaluations: torch.Tensor
    lane_evaluations: torch.Tensor


def vech_indices(d: int):
    """(rows, cols) scattering a vech vector back into the lower triangle
    in vech's COLUMN-major order (column by column) — NOT np.tril_indices,
    whose row-major order would permute entries for d >= 3."""
    rows = np.concatenate([np.arange(j, d) for j in range(d)])
    cols = np.concatenate([np.full(d - j, j) for j in range(d)])
    return rows, cols


def _factor(xs, d, diagonal):
    """L (B, d, d) of the points ``xs`` (B, nv)."""
    if diagonal:
        return torch.diag_embed(xs)
    rows, cols = (torch.as_tensor(i, device=xs.device)
                  for i in vech_indices(d))
    L = torch.zeros((xs.shape[0], d, d), dtype=xs.dtype, device=xs.device)
    L[:, rows, cols] = xs
    return L


def _whiten(X, L):
    """L⁻¹x of every row of ``X`` (B, N, d) by forward substitution: w_k =
    (x_k − L_k0·w_0 − L_k1·w_1 − ...) / L_kk, each product rounded before
    it is subtracted, in order of j — the kernel's operations in the
    kernel's order, so that a float32 search on the card takes the same
    steps by either route."""
    cols = []
    for k in range(X.shape[2]):
        s = X[..., k]
        for j in range(k):
            s = s - L[:, k, j, None] * cols[j]
        cols.append(s / L[:, k, k, None])
    return torch.stack(cols, dim=-1)


def _raw(X, valid, Ns, xs, d, diagonal):
    """(score, det) of the points ``xs`` (B, nv), one per problem."""
    L = _factor(xs, d, diagonal)
    logdiag = torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))
                        + 1e-300)
    sumlog = logdiag[:, 0]
    for k in range(1, d):
        sumlog = sumlog + logdiag[:, k]
    det = torch.exp(2.0 * sumlog)
    s2h, sh = ucv_pair_sums_batch(_whiten(X, L), valid)
    lognorm_h = -sumlog - 0.5 * d * _LOG_2PI
    lognorm_2h = lognorm_h - 0.5 * d * _LOG_2
    score = (
        torch.exp(lognorm_2h)
        + 2.0 * s2h * torch.exp(lognorm_2h) / Ns
        - 4.0 * sh * torch.exp(lognorm_h) / (Ns - 1.0)
    )
    return score, det


def _guarded(score, det, ss, sd):
    bad = (
        (det <= MACHINE_TOL)
        | (det < 1e-3 * sd)
        | (det > 1e3 * sd)
        | torch.isnan(det)
        | torch.isnan(score)
        | (torch.abs(score) > 1e3 * torch.abs(ss))
    )
    return torch.where(bad, ss + 1e-7, score)


def ucv_search_reference(X, valid, Ns, x0s, d: int, diagonal: bool,
                         max_iter: int) -> UcvSearchResult:
    """The plain search: B problems on the tensors' device in their dtype.
    ``X`` (B, N, d) training rows, ``valid`` (B, N) 1.0 on the rows that
    count or None, ``Ns`` (B,) row counts, ``x0s`` (B, nv) starts; at most
    ``max_iter`` iterations a problem. Scipy's Nelder–Mead coefficients and
    initial simplex, ``fatol = 1e-4·|f_start| + 1e-12``, ``xatol = 1e-4·
    max|x0| + 1e-12`` (:func:`~.nelder_mead.nelder_mead_batch`)."""
    evaluations = 0

    def raw(xs):
        nonlocal evaluations
        evaluations += 1
        return _raw(X, valid, Ns, xs, d, diagonal)

    ss, sd = raw(x0s)
    fatol = 1e-4 * torch.abs(ss) + 1e-12
    xatol = 1e-4 * torch.amax(torch.abs(x0s), dim=1) + 1e-12
    xb, fb, iters, needed = nelder_mead_batch_counted(
        lambda xs: _guarded(*raw(xs), ss, sd), x0s, fatol, xatol,
        max_iter=max_iter)
    return UcvSearchResult(xb, fb, ss, iters,
                           torch.tensor(evaluations, dtype=torch.int32,
                                        device=X.device), needed)


def ucv_objective_reference(X, valid, Ns, x0s, points, d: int,
                            diagonal: bool):
    """The plain guarded objective at ``points`` (B, P, nv): (B, P), each
    problem's guard rails set by its start ``x0s``."""
    ss, sd = _raw(X, valid, Ns, x0s, d, diagonal)
    return torch.stack([
        _guarded(*_raw(X, valid, Ns, points[:, p], d, diagonal), ss, sd)
        for p in range(points.shape[1])], dim=1)


def _check_args(X, valid, Ns, x0s, d, diagonal, points=None):
    tensors = {"X": X, "Ns": Ns, "x0s": x0s}
    for name, t in [*tensors.items(), ("valid", valid), ("points", points)]:
        if t is not None and not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if X.dim() != 3 or X.shape[2] != d or d < 1:
        raise ValueError(f"X must be (B, N, {d}), got {tuple(X.shape)}")
    B, N, _ = X.shape
    nv = d if diagonal else d * (d + 1) // 2
    want = {"Ns": (B,), "x0s": (B, nv)}
    if valid is not None:
        tensors["valid"] = valid
        want["valid"] = (B, N)
    if points is not None:
        tensors["points"] = points
        P = points.shape[1] if points.dim() == 3 else -1
        want["points"] = (B, P, nv)
    for name, t in tensors.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ucv_search kernel for {X.device}")
    return B, N, nv


def ucv_search_cuda(X, valid, Ns, x0s, d: int, diagonal: bool,
                    max_iter: int) -> UcvSearchResult:
    """The UCV search of :func:`ucv_search_reference` on float32,
    contiguous tensors of one device: CPU tensors take the plain version;
    CUDA tensors launch the kernel once, counted in
    ``ucv_search_cuda.launches``, or raise. The launch reads nothing back:
    the result's tensors are ready when the stream reaches them."""
    B, N, nv = _check_args(X, valid, Ns, x0s, d, diagonal)
    if X.device.type == "cpu":
        return ucv_search_reference(X, valid, Ns, x0s, d, diagonal, max_iter)
    out = _launch(X, valid, Ns, x0s, d, diagonal, max_iter)
    ucv_search_cuda.launches += 1
    return out


ucv_search_cuda.launches = 0


def ucv_search_evaluate(X, valid, Ns, x0s, points, d: int, diagonal: bool,
                        white: bool = False):
    """The kernel's objective at ``points`` (B, P, nv), the guard rails
    set by the starts ``x0s``: ``(f (B, P), sums (B, P, 2) (s2h, sh),
    whitened rows (B, P, N, d) or None)``, the same code as the search's
    evaluations, in one launch (not in the search's count). CPU tensors take
    the plain objective and pair sums."""
    B, N, nv = _check_args(X, valid, Ns, x0s, d, diagonal, points)
    P = points.shape[1]
    if X.device.type == "cpu":
        f = ucv_objective_reference(X, valid, Ns, x0s, points, d, diagonal)
        W = torch.stack([_whiten(X, _factor(points[:, p], d, diagonal))
                         for p in range(P)], dim=1)
        s2h, sh = ucv_pair_sums_batch(W.reshape(B * P, N, d),
                                      None if valid is None
                                      else valid.repeat_interleave(P, 0))
        sums = torch.stack([s2h, sh], -1).reshape(B, P, 2)
        return f, sums, W if white else None
    if P < 1:
        raise ValueError("points must hold at least one point a problem")
    return _launch(X, valid, Ns, x0s, d, diagonal, 0, points, white)


def _launch(X, valid, Ns, x0s, d, diagonal, max_iter, points=None,
            white=False):
    """One launch on checked CUDA arguments; the search's
    :class:`UcvSearchResult`, or with ``points`` the evaluation's (f, sums,
    white). Counts nothing: the search's wrapper counts its own launches."""
    B, N, _ = X.shape
    nv = x0s.shape[1]
    P = 0 if points is None else points.shape[1]
    if B < 1:
        raise ValueError("a search needs at least one problem")
    if N >= 2**31 or B * N >= 2**31:
        raise ValueError("rows must fit 32-bit indices")
    lib = _load_library()
    sizes = (ctypes.c_longlong * 3)()
    if lib.ucv_search_scratch(B, N, d, int(diagonal), P, int(max_iter),
                              sizes) != 0:
        raise ValueError(f"a UCV search of B {B}, N {N}, d {d} is out of "
                         "the kernel's range")
    device = X.device
    fscratch = torch.empty(sizes[0], dtype=torch.float32, device=device)
    iscratch = torch.empty(sizes[1], dtype=torch.int32, device=device)
    partials = torch.empty(sizes[2], dtype=torch.float64, device=device)
    # the results in one buffer, so that a caller reads them at once
    floats = torch.empty(B * nv + 2 * B if P == 0 else B * P + B,
                         dtype=torch.float32, device=device)
    # iterations (B,), evaluations (1,), lane evaluations (B,)
    ints = torch.empty(2 * B + 1, dtype=torch.int32, device=device)
    sums = (torch.empty((B, P, 2), dtype=torch.float32, device=device)
            if P else None)
    rows = (torch.empty((B, P, N, d), dtype=torch.float32, device=device)
            if P and white else None)
    if P == 0:
        x_best, f_out, f_start = (floats[: B * nv], floats[B * nv: B * nv + B],
                                  floats[B * nv + B:])
    else:
        x_best, f_out, f_start = None, floats[: B * P], floats[B * P:]

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ucv_search_f32(
            ptr(X), ptr(valid), ptr(Ns), ptr(x0s), ptr(points), B, N, d,
            int(diagonal), int(max_iter), P, ptr(fscratch), ptr(iscratch),
            ptr(partials), ptr(x_best), ptr(f_out), ptr(f_start),
            ptr(ints[:B]), ptr(ints[B:B + 1]), ptr(ints[B + 1:]), ptr(sums),
            ptr(rows), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ucv_search kernel launch failed (B {B}, N {N}, d {d}, "
            f"diagonal {bool(diagonal)}): CUDA error {err}")
    if P:
        return f_out.view(B, P), sums, rows
    return UcvSearchResult(x_best.view(B, nv), f_out, f_start, ints[:B],
                           ints[B], ints[B + 1:])


@functools.cache
def _load_library():
    lib = cuda_build.load("ucv_pairs.cu")
    fn = lib.ucv_search_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 12)
    fn.restype = ctypes.c_int
    lib.ucv_search_scratch.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.ucv_search_scratch.restype = ctypes.c_int
    return lib
