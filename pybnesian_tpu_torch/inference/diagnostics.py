"""MCMC convergence diagnostics: split R-hat and effective sample size.

Net-new vs the reference (which has no inference engine). Implementations
follow Vehtari et al. (2021) "Rank-normalization, folding, and localization:
An improved R-hat": split-chain potential scale reduction and ESS via
Geyer's initial-monotone-sequence truncated autocorrelation sum. Pure numpy
on host — diagnostics run once per fit, not in the sampling hot loop.

Copied from ``pybnesian_tpu/inference/diagnostics.py``; samples may also be
tensors (on any device), which are copied to the host first.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["potential_scale_reduction", "effective_sample_size", "summarize"]


def _to_chains(samples) -> np.ndarray:
    """Normalize input to (n_chains, n_draws) for one scalar parameter."""
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    a = np.asarray(samples, dtype=np.float64)
    if a.ndim == 1:
        a = a[None, :]
    return a


def potential_scale_reduction(samples) -> float:
    """Split R-hat. samples: (n_chains, n_draws) or (n_draws,). Values near
    1.0 indicate convergence; > 1.01 is suspect (Vehtari et al. 2021)."""
    a = _to_chains(samples)
    n = a.shape[1] // 2
    if n < 2:
        return np.nan
    halves = np.concatenate([a[:, :n], a[:, n : 2 * n]], axis=0)
    m = halves.shape[0]
    chain_means = halves.mean(axis=1)
    chain_vars = halves.var(axis=1, ddof=1)
    w = chain_vars.mean()
    b = n * chain_means.var(ddof=1)
    if w <= 0:
        return np.nan
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def _autocovariance(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance of a 1-D series via FFT."""
    n = len(x)
    xc = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real / n
    return acov


def effective_sample_size(samples) -> float:
    """ESS across chains (Geyer initial monotone sequence over the
    chain-averaged autocorrelation, as in Stan / Vehtari et al. 2021)."""
    a = _to_chains(samples)
    m, n = a.shape
    if n < 4:
        return np.nan
    acovs = np.stack([_autocovariance(a[i]) for i in range(m)])
    chain_var = acovs[:, 0] * n / (n - 1.0)
    w = chain_var.mean()
    mean_acov = acovs.mean(axis=0)
    if m > 1:
        var_plus = (n - 1) / n * w + a.mean(axis=1).var(ddof=1)
    else:
        var_plus = (n - 1) / n * w
    if var_plus <= 0:
        return np.nan
    rho = 1.0 - (w - mean_acov) / var_plus
    # Geyer: sum consecutive pairs while positive, enforce monotone decrease
    max_pairs = (n - 1) // 2
    tau = 1.0
    prev_pair = np.inf
    for t in range(max_pairs):
        pair = rho[2 * t + 1] + rho[2 * t + 2]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        prev_pair = pair
        tau += 2.0 * pair
    return float(m * n / tau)


def summarize(samples_dict: dict) -> dict:
    """Per-parameter {mean, sd, ess, rhat} for a dict of sample arrays
    shaped (n_chains, n_draws) or (n_draws,)."""
    out = {}
    for name, s in samples_dict.items():
        a = _to_chains(s)
        out[name] = {
            "mean": float(a.mean()),
            "sd": float(a.std(ddof=1)),
            "ess": effective_sample_size(a),
            "rhat": potential_scale_reduction(a),
        }
    return out
