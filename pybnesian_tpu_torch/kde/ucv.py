"""UCV (unbiased cross-validation) bandwidth selection.

Rebuild of reference kde/UCV.{hpp,cpp}, ported from
``pybnesian_tpu/kde/ucv.py``: the leave-one-out UCV objective over the
N(N−1)/2 pair triangle (:func:`pybnesian_tpu_torch.ops.kde.ucv_pair_sums`),
minimized with Nelder–Mead over vech(chol(H)) (full) or the square roots of
the diagonal (diagonal) — the reference uses NLopt LN_NELDERMEAD
(UCV.cpp:469, 505). The same guard rails are kept: determinant bounded
within 1e±3 of the normal-reference start, scores bounded within 1e3 of the
start score (UCV.cpp:400-460), and a search never returns a worse point
than its start.

The search runs on tensors: B problems at once
(:func:`ucv_minimize_batch`; one problem is a batch of one), on
:func:`default_device` unless the caller names a device (a score passes
its own), in the dtype of the data frame (float32 data → float32 search,
float64 → float64).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..data import DataFrame
from ..ops.kde import kernel_route, ucv_pair_sums
from ..ops.ucv_search_kernel import ucv_search_cuda, ucv_search_reference
from ..ops.ucv_search_kernel import vech_indices as _vech_indices
from ..runtime.device import host_to_device, resolve_device
from .bandwidth import BandwidthSelector, NormalReferenceRule

__all__ = ["UCV", "UCVScorer", "UCVSearch", "vech", "invvech_triangular",
           "ucv_search_batch", "ucv_minimize_batch"]

_LOG_2PI = math.log(2 * math.pi)


def vech(m: np.ndarray) -> np.ndarray:
    """Half-vectorization: stack the lower triangle column by column
    (reference util/vech_ops.cpp)."""
    d = m.shape[0]
    return np.concatenate([m[j:, j] for j in range(d)])


def invvech_triangular(v: np.ndarray) -> np.ndarray:
    """Inverse of vech producing a lower-triangular matrix."""
    d = int((math.sqrt(8 * len(v) + 1) - 1) / 2)
    out = np.zeros((d, d))
    pos = 0
    for j in range(d):
        out[j:, j] = v[pos: pos + d - j]
        pos += d - j
    return out


class UCVScorer:
    """(reference kde/UCV.hpp:12-47). The training rows live on ``device``
    (default :func:`default_device`) in the data's dtype; the scores come
    back as Python floats."""

    def __init__(self, df, variables, device=None):
        df = DataFrame.wrap(df)
        self.variables = list(variables)
        self.training = df.to_numpy(self.variables, drop_null=True,
                                    dtype=np.float64)
        self.N = len(self.training)
        self.d = len(self.variables)
        dt = df.same_type(*self.variables)
        self.dtype = (np.dtype(np.float32) if np.dtype(dt) == np.float32
                      else np.dtype(np.float64))
        self.device = resolve_device(device)

    def _pair_sums(self, chol: np.ndarray):
        from scipy.linalg import solve_triangular

        white = solve_triangular(chol, self.training.T, lower=True).T
        w = host_to_device(white, self.dtype, self.device)
        s2h, sh = ucv_pair_sums(w)
        return float(s2h), float(sh)

    def score_unconstrained(self, bandwidth: np.ndarray) -> float:
        """N-scaled UCV score (reference UCV.cpp:297-358)."""
        bandwidth = np.asarray(bandwidth, dtype=np.float64)
        try:
            chol = np.linalg.cholesky(bandwidth)
        except np.linalg.LinAlgError:
            return math.inf
        lognorm_h = (
            -np.sum(np.log(np.diag(chol))) - 0.5 * self.d * _LOG_2PI
        )
        lognorm_2h = lognorm_h - 0.5 * self.d * math.log(2.0)
        s2h_raw, sh_raw = self._pair_sums(chol)
        s2h = s2h_raw * math.exp(lognorm_2h)
        sh = sh_raw * math.exp(lognorm_h)
        return (
            math.exp(lognorm_2h) + 2.0 * s2h / self.N - 4.0 * sh / (self.N - 1)
        )

    def score_diagonal(self, diag_bandwidth: np.ndarray) -> float:
        return self.score_unconstrained(np.diag(np.asarray(diag_bandwidth)))


class UCVSearch(NamedTuple):
    """What a batched UCV search found and what it cost: ``x`` the host
    float64 (B, nv) optima (a problem whose search did not improve on its
    start keeps the start), ``iterations`` the (B,) Nelder–Mead iterations
    of each problem, ``evaluations`` the batched objective calls (each
    evaluates all B problems), ``dtype`` the name of the search's dtype,
    ``lane_evaluations`` the (B,) evaluations each problem's own search
    needed, ``x0`` the host float64 (B, nv) starts it began from (read
    back with the result where they were on the device)."""

    x: np.ndarray
    iterations: np.ndarray
    evaluations: int
    dtype: str
    lane_evaluations: np.ndarray
    x0: np.ndarray


def _minimize(X, valid, Ns, starts, d: int, diagonal: bool) -> UCVSearch:
    """B UCV searches at once, on the tensors' device and in their dtype.
    X: (B, N, d) training rows; valid: (B, N) 1.0 on real rows, or None
    when every row is real; Ns: (B,) row counts; starts: the float64 (B, nv)
    starts — vech(chol(H_start)), or with ``diagonal`` the d square roots of
    a diagonal start — as a host array, or as a tensor on X's device (read
    back with the result). A bad point (determinant or score off the guard
    rails, NaN) scores ``f_start + 1e-7``.

    Routed by :func:`~..ops.kde.kernel_route`: a float32 search on a GPU is
    one launch of the search kernel (:func:`~..ops.ucv_search_kernel.
    ucv_search_cuda`), every other search the plain host loop
    (:func:`~..ops.ucv_search_kernel.ucv_search_reference`). Either way the
    host reads the result once, after the search."""
    parts = []
    if isinstance(starts, torch.Tensor):
        x0s = starts.to(X.dtype)
        parts.append(starts.reshape(-1).double())
    else:
        starts = np.asarray(starts, np.float64)
        x0s = torch.as_tensor(starts, dtype=X.dtype, device=X.device)
    B, nv = x0s.shape
    search = ucv_search_cuda if kernel_route(X) else ucv_search_reference
    res = search(X, valid, Ns, x0s, d, diagonal, 200 * nv)
    host = torch.cat([res.x.reshape(-1).double(), res.f.double(),
                      res.start.double(), res.iterations.double(),
                      res.lane_evaluations.double(),
                      res.evaluations.reshape(1).double(),
                      *parts]).cpu().numpy()
    if parts:
        starts = host[-B * nv:].reshape(B, nv)
        host = host[: -B * nv]
    x = host[: B * nv].reshape(B, nv).copy()
    f, ss = host[B * nv: B * nv + B], host[B * nv + B: B * nv + 2 * B]
    # a search that did not improve on its start (a float32 plateau) keeps
    # the start
    worse = f > ss
    x[worse] = starts[worse]
    counts = host[B * nv + 2 * B: -1].astype(np.int32)
    return UCVSearch(x, counts[:B], int(host[-1]),
                     str(X.dtype).replace("torch.", ""), counts[B:], starts)


def _device_minimize(scorer: UCVScorer, x0, diagonal: bool) -> UCVSearch:
    """One Nelder–Mead UCV minimization on the scorer's device: a batch of
    one problem. The reference launches one OpenCL pair-sum pipeline per
    NLopt evaluation (kde/UCV.cpp:469-505); here too every evaluation is a
    handful of device calls, with no copy of the rows per evaluation."""
    X = host_to_device(scorer.training, scorer.dtype, scorer.device)[None]
    return _minimize(
        X, None,
        torch.full((1,), float(scorer.N), dtype=X.dtype, device=X.device),
        np.asarray(x0, np.float64)[None], scorer.d, diagonal,
    )


def ucv_search_batch(Xpad, valid, Ns, x0s, d: int, dtype=np.float64,
                     device=None) -> UCVSearch:
    """Batched UCV bandwidth selection: B independent problems — each an
    (npad, d) training block padded with rows that its validity mask rules
    out, with its own row count and vech(chol(H_start)) start — minimized by
    ONE batched Nelder–Mead on ``device`` (default :func:`default_device`)
    in ``dtype``. This is the structure-search form: a CV score over F
    families × K folds has F·K bandwidth problems, and every step of the
    search evaluates all of them in one set of device calls (reference
    kde/UCV.cpp:469-505 runs one NLopt loop per factor fit).

    Arguments are host arrays. Returns the :class:`UCVSearch`: the optimal
    vech factors, with the iterations and evaluations they took."""
    device = resolve_device(device)

    def dev(a):
        return host_to_device(a, dtype, device)

    # equal-sized problems (folds of one size, no nulls) need no mask
    valid = None if np.all(np.asarray(valid) > 0) else dev(valid)
    return _minimize(dev(Xpad), valid, dev(Ns), x0s, d, diagonal=False)


def ucv_minimize_batch(Xpad, valid, Ns, x0s, d: int, dtype=np.float64,
                       device=None) -> np.ndarray:
    """The host float64 ``(B, nv)`` optima of :func:`ucv_search_batch`."""
    return ucv_search_batch(Xpad, valid, Ns, x0s, d, dtype, device).x


class UCV(BandwidthSelector):
    """UCV bandwidths, full and diagonal. The search runs on
    :func:`default_device` (the card, or what ``use_device`` chose; a score
    fits its factors under its own device). ``last_search`` is the
    :class:`UCVSearch` of the selector's latest call."""

    def __init__(self):
        self._nr = NormalReferenceRule()
        self.last_search: UCVSearch | None = None

    def bandwidth(self, df, variables) -> np.ndarray:
        variables = list(variables)
        if not variables:
            return np.zeros((0, 0))
        start_h = self._nr.bandwidth(df, variables)
        scorer = UCVScorer(df, variables)
        x0 = vech(np.linalg.cholesky(start_h))
        self.last_search = _device_minimize(scorer, x0, False)
        sqrt = invvech_triangular(self.last_search.x[0])
        return sqrt @ sqrt.T

    def diag_bandwidth(self, df, variables) -> np.ndarray:
        variables = list(variables)
        if not variables:
            return np.zeros(0)
        start_diag = self._nr.diag_bandwidth(df, variables)
        scorer = UCVScorer(df, variables)
        self.last_search = _device_minimize(scorer, np.sqrt(start_diag), True)
        return np.square(self.last_search.x[0])

    def ToString(self) -> str:
        return "UCV"
