"""CDF approximations for weighted sums of χ²₁ random variables.

Rebuild of reference util/chisquaresum.hpp (308 LoC): the Lindsay–Pilla–Basak
four-moment gamma-mixture approximation (``lpb4``) and the
Hall–Buckley–Eagleson approximation (``hbe``), used by RCoT p-values.
The reference's Jenkins–Traub polynomial solver (util/rpoly.cpp) is replaced
by numpy's companion-matrix eigenvalue roots; the Brent root bracketing
(util/uniroot.hpp) by scipy.optimize.brentq.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import comb
from scipy.special import gammainc as _gammainc, gammaincc as _gammaincc

__all__ = ["lpb4_complement", "hbe_complement", "lpb4", "hbe"]


def _moments(coeffs: np.ndarray, p: int) -> np.ndarray:
    """First 2p moments from the cumulants of Σ λ_i χ²₁
    (reference chisquaresum.hpp:18-45)."""
    n = 2 * p
    cumulants = np.empty(n)
    cumulants[0] = coeffs.sum()
    cumulants[1] = 2 * np.sum(coeffs**2)
    fact = 8.0
    for i in range(2, n):
        cumulants[i] = fact * np.sum(coeffs ** (i + 1))
        fact *= 2 * (i + 1)
    moments = cumulants.copy()
    moments[1] += moments[0] * moments[0]
    for i in range(2, n):
        offset = cumulants[0] * moments[i - 1] + i * cumulants[1] * moments[i - 2]
        for j in range(2, i):
            offset += comb(i, j, exact=True) * cumulants[j] * moments[i - j - 1]
        moments[i] += offset
    return moments


def _delta_matrix(moments: np.ndarray, size: int) -> np.ndarray:
    """(reference delta_matrix_template, chisquaresum.hpp:47-75)."""
    t = np.empty((size, size))
    t[0, 0] = 1
    t[0, 1] = t[1, 0] = moments[0]
    for i in range(2, size):
        t[i, 0] = moments[i - 1]
    for i in range(1, size):
        t[i, 1] = moments[i]
    for j in range(2, size):
        for i in range(size):
            t[i, j] = moments[i + j - 1]
    return t


def _mult_coefficients(alpha: float, size: int) -> np.ndarray:
    max_r = 2 * size - 2
    mult = np.empty(max_r - 1)
    mult[0] = 1 + alpha
    for i in range(1, max_r - 1):
        mult[i] = mult[i - 1] * (1 + (i + 1) * alpha)
    return 1.0 / mult


def _apply_mult(delta: np.ndarray, mult: np.ndarray) -> np.ndarray:
    p = delta.shape[0]
    out = delta.copy()
    for i in range(2, p):
        out[i, 0] *= mult[i - 2]
    for i in range(1, p):
        out[i, 1] *= mult[i - 1]
    for j in range(2, p):
        for i in range(p):
            out[i, j] *= mult[i + j - 2]
    return out


def _lambda_tilde(moments: np.ndarray, p: int) -> float:
    """(reference chisquaresum.hpp:126-138)."""
    from scipy.optimize import brentq  # cached after first import

    last_lambda = moments[1] / (moments[0] * moments[0]) - 1
    for i in range(2, p + 1):
        matrix = _delta_matrix(moments, i + 1)

        def det_fn(alpha):
            return np.linalg.det(_apply_mult(matrix, _mult_coefficients(alpha, i + 1)))

        last_lambda = brentq(det_fn, 0.0, last_lambda, xtol=1e-9, maxiter=1000)
    return last_lambda


def _mu_roots(moments: np.ndarray, lam: float, p: int) -> np.ndarray:
    """(reference chisquaresum.hpp:140-168)."""
    M = _apply_mult(_delta_matrix(moments, p + 1), _mult_coefficients(lam, p + 1))
    M = M.copy()
    M[:, p] = 0.0
    poly = np.empty(p + 1)
    for i in range(p, -1, -1):
        M[i, p] = 1.0
        poly[p - i] = np.linalg.det(M)
        M[i, p] = 0.0
    roots = np.roots(poly)
    real = roots[np.abs(roots.imag) < 1e-8].real
    if len(real) < p:
        raise RuntimeError("Complex roots in LPB4 mixture support")
    return np.sort(real)[:p]


def _mixture_proportions(mu: np.ndarray, moments: np.ndarray, lam: float, p: int) -> np.ndarray:
    """(reference chisquaresum.hpp:170-202)."""
    vander = np.vstack([mu**i for i in range(p)])
    delta_vec = np.empty(p)
    delta_vec[0] = 1
    delta_vec[1] = moments[0]
    delta_vec[2] = moments[1] / (1 + lam)
    delta_vec[3] = moments[2] / ((1 + lam) * (1 + 2 * lam))
    mult = (1 + lam) * (1 + 2 * lam)
    for i in range(4, p):
        mult *= 1 + (i - 1) * lam
        delta_vec[i] = moments[i - 1] / mult
    return np.linalg.lstsq(vander, delta_vec, rcond=None)[0]


def _lpb4_parts(coeffs: np.ndarray):
    coeffs = np.asarray(coeffs, dtype=np.float64)
    if len(coeffs) < 4:
        raise ValueError("lpb4 requires at least 4 coefficients.")
    p = 4
    moments = _moments(coeffs, p)
    lam = _lambda_tilde(moments, p)
    mu = _mu_roots(moments, lam, p)
    prop = _mixture_proportions(mu, moments, lam, p)
    return prop, mu, lam


def lpb4(coeffs, quantile: float) -> float:
    prop, mu, lam = _lpb4_parts(coeffs)
    k = 1.0 / lam
    theta = mu * lam
    if np.any(theta <= 0):
        raise RuntimeError("Wrong theta parameter.")
    return float(np.sum(prop * _gammainc(k, np.maximum(quantile, 0.0) / theta)))


def lpb4_complement(coeffs, quantile: float) -> float:
    prop, mu, lam = _lpb4_parts(coeffs)
    k = 1.0 / lam
    theta = mu * lam
    if np.any(theta <= 0):
        raise RuntimeError("Wrong theta parameter.")
    return float(np.sum(prop * _gammaincc(k, np.maximum(quantile, 0.0) / theta)))


def _hbe_parts(coeffs):
    coeffs = np.asarray(coeffs, dtype=np.float64)
    k1 = coeffs.sum()
    sq = coeffs**2
    k2 = 2 * sq.sum()
    k3 = 8 * float(coeffs @ sq)
    nu = 8 * (k2**3) / (k3 * k3)
    return k1, k2, nu


def hbe(coeffs, quantile: float) -> float:
    """(reference chisquaresum.hpp:274-289)."""
    k1, k2, nu = _hbe_parts(coeffs)
    statistic = math.sqrt(2 * nu / k2) * (quantile - k1) + nu
    # the moment-matched statistic can go negative for small quantiles;
    # gamma.cdf treated that as 0 (gammainc would return nan)
    return float(_gammainc(nu / 2.0, max(statistic, 0.0) / 2.0))


def hbe_complement(coeffs, quantile: float) -> float:
    k1, k2, nu = _hbe_parts(coeffs)
    statistic = math.sqrt(2 * nu / k2) * (quantile - k1) + nu
    return float(_gammaincc(nu / 2.0, max(statistic, 0.0) / 2.0))


# ===================================================== batched (lane-wise)
def _moments_batch(lam: np.ndarray, mask: np.ndarray, p: int) -> np.ndarray:
    """(B, 2p) moments with per-lane positive-coefficient masks — the
    vectorized form of :func:`_moments`."""
    n = 2 * p
    B = lam.shape[0]
    lamm = np.where(mask, lam, 0.0)
    cumulants = np.empty((B, n))
    cumulants[:, 0] = lamm.sum(axis=1)
    cumulants[:, 1] = 2 * np.sum(lamm**2, axis=1)
    fact = 8.0
    power = lamm**2
    for i in range(2, n):
        power = power * lamm
        cumulants[:, i] = fact * power.sum(axis=1)
        fact *= 2 * (i + 1)
    moments = cumulants.copy()
    moments[:, 1] += moments[:, 0] * moments[:, 0]
    for i in range(2, n):
        offset = (
            cumulants[:, 0] * moments[:, i - 1]
            + i * cumulants[:, 1] * moments[:, i - 2]
        )
        for j in range(2, i):
            offset += (
                comb(i, j, exact=True)
                * cumulants[:, j]
                * moments[:, i - j - 1]
            )
        moments[:, i] += offset
    return moments


def _delta_matrix_batch(moments: np.ndarray, size: int) -> np.ndarray:
    B = moments.shape[0]
    t = np.empty((B, size, size))
    t[:, 0, 0] = 1
    t[:, 0, 1] = t[:, 1, 0] = moments[:, 0]
    for i in range(2, size):
        t[:, i, 0] = moments[:, i - 1]
    for i in range(1, size):
        t[:, i, 1] = moments[:, i]
    for j in range(2, size):
        for i in range(size):
            t[:, i, j] = moments[:, i + j - 1]
    return t


def _mult_apply_batch(delta: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Batched :func:`_apply_mult` with per-lane alpha."""
    size = delta.shape[1]
    max_r = 2 * size - 2
    B = delta.shape[0]
    mult = np.empty((B, max_r - 1))
    mult[:, 0] = 1 + alpha
    for i in range(1, max_r - 1):
        mult[:, i] = mult[:, i - 1] * (1 + (i + 1) * alpha)
    inv = 1.0 / mult
    out = delta.copy()
    for i in range(2, size):
        out[:, i, 0] *= inv[:, i - 2]
    for i in range(1, size):
        out[:, i, 1] *= inv[:, i - 1]
    for j in range(2, size):
        for i in range(size):
            out[:, i, j] *= inv[:, i + j - 2]
    return out


def _lambda_tilde_batch(moments: np.ndarray, p: int, ok: np.ndarray,
                        iters: int = 64):
    """Vectorized bisection replacement for the per-lane brentq ladder
    (xtol well under brentq's 1e-9 after 64 halvings). Lanes whose bracket
    carries no sign change are marked failed (serial brentq would raise →
    hbe fallback)."""
    last_lambda = moments[:, 1] / (moments[:, 0] * moments[:, 0]) - 1
    ok = ok & np.isfinite(last_lambda) & (last_lambda > 0)
    for i in range(2, p + 1):
        matrix = _delta_matrix_batch(moments, i + 1)

        def det_at(alpha):
            return np.linalg.det(_mult_apply_batch(matrix, alpha))

        lo = np.zeros(len(moments))
        hi = np.where(ok, last_lambda, 1.0)
        flo = det_at(lo)
        fhi = det_at(hi)
        ok = ok & (np.sign(flo) != np.sign(fhi)) & np.isfinite(flo) \
            & np.isfinite(fhi)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            fmid = det_at(mid)
            go_lo = np.sign(fmid) == np.sign(flo)
            lo = np.where(go_lo, mid, lo)
            flo = np.where(go_lo, fmid, flo)
            hi = np.where(go_lo, hi, mid)
        last_lambda = np.where(ok, 0.5 * (lo + hi), last_lambda)
    return last_lambda, ok


def _mu_roots_batch(moments: np.ndarray, lam: np.ndarray, p: int,
                    ok: np.ndarray):
    """Batched :func:`_mu_roots`: polynomial coefficients via batched
    determinants, roots via companion-matrix eigenvalues."""
    B = moments.shape[0]
    M = _mult_apply_batch(_delta_matrix_batch(moments, p + 1), lam)
    M[:, :, p] = 0.0
    poly = np.empty((B, p + 1))
    for i in range(p, -1, -1):
        M[:, i, p] = 1.0
        poly[:, p - i] = np.linalg.det(M)
        M[:, i, p] = 0.0
    lead = poly[:, 0]
    ok = ok & (np.abs(lead) > 0) & np.isfinite(poly).all(axis=1)
    safe_lead = np.where(ok, lead, 1.0)
    monic = poly / safe_lead[:, None]
    companion = np.zeros((B, p, p))
    companion[:, 1:, :-1] = np.eye(p - 1)
    companion[:, :, -1] = -monic[:, 1:][:, ::-1]
    # np.roots uses the transposed convention; either orientation has the
    # same eigenvalues
    roots = np.linalg.eigvals(np.where(ok[:, None, None], companion, np.eye(p)))
    real_mask = np.abs(roots.imag) < 1e-8
    ok = ok & (real_mask.sum(axis=1) >= p)
    real = np.where(real_mask, roots.real, np.inf)
    mu = np.sort(real, axis=1)[:, :p]
    return mu, ok


def chisq_sum_pvalues_batch(eigs: np.ndarray, stats: np.ndarray,
                            force_hbe: bool = False) -> np.ndarray:
    """Batched complement CDF of Σ λᵢ χ²₁ at ``stats``: LPB4 per lane with
    the serial ladder's failure semantics (any lane where LPB4 is not
    applicable — fewer than 4 positive coefficients, no bisection bracket,
    complex mixture support, bad theta — falls back to HBE, exactly as
    :func:`lpb4_complement` falling back to :func:`hbe_complement`).
    Clamped to [0, 1]."""
    eigs = np.asarray(eigs, np.float64)
    stats = np.asarray(stats, np.float64)
    B = eigs.shape[0]
    mask = eigs > 0
    q = np.maximum(stats, 0.0)

    # ---- HBE for every lane (cheap; the universal fallback)
    lamm = np.where(mask, eigs, 0.0)
    k1 = lamm.sum(axis=1)
    sq = lamm**2
    k2 = 2 * sq.sum(axis=1)
    k3 = 8 * np.einsum("bi,bi->b", lamm, sq)
    with np.errstate(divide="ignore", invalid="ignore"):
        nu = 8 * (k2**3) / (k3 * k3)
        hbe_stat = np.sqrt(2 * nu / k2) * (q - k1) + nu
        out = _gammaincc(nu / 2.0, np.maximum(hbe_stat, 0.0) / 2.0)
    out = np.where(np.isfinite(out), out, 1.0)

    if force_hbe:
        return np.clip(out, 0.0, 1.0)

    p = 4
    ok = mask.sum(axis=1) >= p
    if not ok.any():
        return np.clip(out, 0.0, 1.0)
    moments = _moments_batch(eigs, mask, p)
    lam, ok = _lambda_tilde_batch(moments, p, ok)
    lam_safe = np.where(ok & (lam > 0), lam, 1.0)
    mu, ok = _mu_roots_batch(moments, lam_safe, p, ok)

    # mixture proportions: Vandermonde solve (serial used lstsq on the
    # same square system)
    vander = np.stack([mu**i for i in range(p)], axis=1)  # (B, p, p)
    delta_vec = np.empty((B, p))
    delta_vec[:, 0] = 1
    delta_vec[:, 1] = moments[:, 0]
    delta_vec[:, 2] = moments[:, 1] / (1 + lam_safe)
    delta_vec[:, 3] = moments[:, 2] / ((1 + lam_safe) * (1 + 2 * lam_safe))
    dets = np.abs(np.linalg.det(vander))
    ok = ok & (dets > 1e-300) & np.isfinite(dets)
    safe_vander = np.where(ok[:, None, None], vander, np.eye(p))
    prop = np.linalg.solve(safe_vander, delta_vec[:, :, None])[:, :, 0]

    k = 1.0 / lam_safe
    theta = mu * lam_safe[:, None]
    ok = ok & (theta > 0).all(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        lpb = np.sum(
            prop * _gammaincc(k[:, None], q[:, None]
                              / np.where(theta > 0, theta, 1.0)),
            axis=1,
        )
    ok = ok & np.isfinite(lpb)
    return np.clip(np.where(ok, lpb, out), 0.0, 1.0)
