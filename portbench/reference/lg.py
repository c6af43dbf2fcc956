"""Linear-Gaussian factors of the reference: least squares and the
Gaussian log-likelihood."""

from __future__ import annotations

import math

import torch

from .kde import LOG_2PI, algebra_dtype


def lg_fit(y, X, dtype=torch.float64):
    """(beta, variance) of y on [1, X] by least squares, the variance the
    residual sum of squares over (N - k - 1). ``dtype`` rounds the rows
    first (the control); the solve runs in the matching algebra dtype."""
    la = algebra_dtype(dtype)
    y = y.to(dtype).to(la)
    X = X.to(dtype).to(la)
    N, k = X.shape
    design = torch.cat([torch.ones((N, 1), dtype=la, device=y.device), X],
                       dim=1)
    beta = torch.linalg.lstsq(design, y[:, None]).solution[:, 0]
    resid = y - design @ beta
    dof = N - k - 1
    variance = float((resid * resid).sum()) / dof if dof > 0 else math.inf
    return beta.double(), variance


def lg_logl(y, X, beta, variance, dtype=torch.float64):
    """(M,) float64 log N(y | beta0 + X beta[1:], variance)."""
    la = algebra_dtype(dtype)
    mean = beta[0].to(la) + X.to(dtype).to(la) @ beta[1:].to(la)
    r = (y.to(dtype).to(la) - mean).double()
    return -0.5 * r * r / variance - 0.5 * math.log(variance) - 0.5 * LOG_2PI
