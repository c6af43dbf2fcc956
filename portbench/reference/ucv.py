"""UCV bandwidth selection of the reference: PyBNesian's unbiased
cross-validation objective over the full bandwidth H = L L^T, minimized by
Nelder-Mead over vech(L) from the normal-reference start, with its guard
rails (the determinant within 1e3 of the start's either way, the score
within 1e3 times the start's); and the test of a bandwidth another search
selected, :func:`descent`."""

from __future__ import annotations

import math

import numpy as np
import scipy.optimize
import torch

from .kde import BLOCK, LOG_2PI, algebra_dtype, normal_reference, whiten


def vech(L):
    """L's lower triangle column by column."""
    d = L.shape[0]
    return np.concatenate([np.asarray(L)[j:, j] for j in range(d)])


def invvech(x):
    d = int((math.sqrt(8 * len(x) + 1) - 1) / 2)
    L = np.zeros((d, d))
    pos = 0
    for j in range(d):
        L[j:, j] = x[pos: pos + d - j]
        pos += d - j
    return L


def pair_sums(white, dtype):
    """(sum over i < j of exp(-|w_i - w_j|^2 / 4), the same of
    exp(-|w_i - w_j|^2 / 2)) of the rows ``white`` (N, d), the pair terms
    in ``dtype``, each block's sum in float64."""
    w = white.to(dtype)
    N, d = w.shape
    rows = max(1, BLOCK // max(N, 1))
    s2h = sh = 0.0
    for s in range(0, N, rows):
        blk = w[s: s + rows]
        d2 = torch.zeros((blk.shape[0], N), dtype=dtype, device=w.device)
        for c in range(d):
            diff = blk[:, c, None] - w[None, :, c]
            d2 += diff * diff
        s2h += float(torch.exp(-0.25 * d2).double().sum())
        sh += float(torch.exp(-0.5 * d2).double().sum())
    # every row pairs with itself once at distance 0; each other pair twice
    return (s2h - N) / 2, (sh - N) / 2


def objective(X, x, dtype=torch.float64):
    """(score, det(H)) of vech(L) = ``x`` on the rows ``X`` (N, d)."""
    N, d = X.shape
    L = invvech(np.asarray(x, np.float64))
    diag = np.abs(np.diag(L))
    if np.any(diag <= 0):
        return math.nan, 0.0
    sumlog = float(np.sum(np.log(diag)))
    la = algebra_dtype(dtype)
    Lt = torch.as_tensor(L, dtype=la, device=X.device)
    s2h, sh = pair_sums(whiten(X.to(la), Lt), dtype)
    lognorm_h = -sumlog - 0.5 * d * LOG_2PI
    lognorm_2h = lognorm_h - 0.5 * d * math.log(2.0)
    score = (math.exp(lognorm_2h) + 2.0 * s2h * math.exp(lognorm_2h) / N
             - 4.0 * sh * math.exp(lognorm_h) / (N - 1))
    return score, math.exp(2.0 * sumlog)


# a coordinate's step in :func:`descent`, over its row's diagonal entry
STEP = 1e-2


def descent(X, x, step=STEP):
    """How far a bandwidth vech(L) = ``x`` of the rows ``X`` lies above a
    local minimum of the objective, over the objective's magnitude: the
    largest decrease that a move of one entry L_ij finds, each the minimum
    of the parabola through steps of ``step`` times L_ii either way (or
    the better step, where the parabola opens downwards). 0 at a local
    minimum; on a quadratic, a lower bound on the excess over the
    minimum."""
    x = np.asarray(x, np.float64)
    d = invvech(x).shape[0]
    rows = np.concatenate([np.arange(j, d) for j in range(d)])
    diag = np.abs(np.diag(invvech(x)))
    f0 = objective(X, x)[0]
    worst = 0.0
    for i in range(len(x)):
        e = np.zeros_like(x)
        e[i] = step * diag[rows[i]]
        fp, fm = objective(X, x + e)[0], objective(X, x - e)[0]
        curve = fp + fm - 2.0 * f0
        if curve > 0:
            gain = (fp - fm) ** 2 / (8.0 * curve)
        else:
            steps = [v for v in (fp, fm) if math.isfinite(v)]
            gain = f0 - min(steps) if steps else 0.0
        worst = max(worst, gain)
    return worst / abs(f0)


def start(X):
    """vech(L) of the normal-reference bandwidth of ``X``."""
    H = normal_reference(X.double()).cpu().numpy()
    return vech(np.linalg.cholesky(H))


def guarded(X, x0, dtype=torch.float64):
    """The objective with the guard rails of the start ``x0``: a point off
    them scores the start's score plus 1e-7."""
    ss, sd = objective(X, x0, dtype)

    def f(x):
        score, det = objective(X, x, dtype)
        bad = (det <= 8.9e-16 or det < 1e-3 * sd or det > 1e3 * sd
               or not math.isfinite(score) or abs(score) > 1e3 * abs(ss))
        return ss + 1e-7 if bad else score
    return f, ss


def minimize(X, dtype=torch.float64):
    """The UCV bandwidth of ``X`` (N, d) as vech(L): Nelder-Mead from the
    normal-reference start, to the search's own tolerances, 1e-4 of the
    start's score and of its largest entry, with at most 200 iterations a
    coordinate. A search that ends worse than its start keeps the start."""
    x0 = start(X)
    f, ss = guarded(X, x0, dtype)
    res = scipy.optimize.minimize(
        f, x0, method="Nelder-Mead",
        options={"xatol": 1e-4 * float(np.max(np.abs(x0))) + 1e-12,
                 "fatol": 1e-4 * abs(ss) + 1e-12,
                 "maxiter": 200 * len(x0)})
    return res.x if res.fun <= ss else x0
