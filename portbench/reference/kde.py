"""Kernel densities of the reference: normal-reference bandwidths and the
conditional KDE log-likelihood, by direct per-column differences (no
matrix product, so no TF32 anywhere)."""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
# elements of one (test block x train rows) distance block
BLOCK = 1 << 25


def algebra_dtype(dtype):
    """The dtype of the small linear algebra for pair sums in ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def normal_reference(train):
    """Normal-reference bandwidth of ``train`` (N, d): the sample
    covariance (ddof 1) times (4 / (N (d + 2)))^(2 / (d + 4))."""
    N, d = train.shape
    centred = train - train.mean(dim=0)
    cov = centred.T @ centred / (N - 1) if d > 1 else (
        (centred * centred).sum(dim=0, keepdim=True) / (N - 1))
    k = (4.0 / (N * (d + 2.0))) ** (2.0 / (d + 4.0))
    return k * cov.reshape(d, d)


def whiten(rows, chol):
    """``rows`` (N, d) times the inverse transpose of ``chol``."""
    return torch.linalg.solve_triangular(chol, rows.T, upper=False).T


def logsumexp_rows(test_w, train_w, dtype):
    """(M,) float64 ``logsumexp_j -1/2 |test_i - train_j|^2`` computed in
    ``dtype``, block by block of test rows."""
    tr = train_w.to(dtype)
    te = test_w.to(dtype)
    N, d = tr.shape
    rows = max(1, BLOCK // max(N, 1))
    out = torch.empty(te.shape[0], dtype=torch.float64, device=te.device)
    for s in range(0, te.shape[0], rows):
        blk = te[s: s + rows]
        d2 = torch.zeros((blk.shape[0], N), dtype=dtype, device=te.device)
        for c in range(d):
            diff = blk[:, c, None] - tr[None, :, c]
            d2 += diff * diff
        out[s: s + rows] = torch.logsumexp(-0.5 * d2, dim=1).double()
    return out


def kde_logl(train, test, H, dtype=torch.float64):
    """(M,) float64 log-density of ``test`` under the Gaussian KDE of
    ``train`` with bandwidth matrix ``H``; pair sums in ``dtype``."""
    la = algebra_dtype(dtype)
    L = torch.linalg.cholesky(H.to(la))
    N, d = train.shape
    lognorm = (-torch.log(torch.diagonal(L)).sum().double()
               - 0.5 * d * LOG_2PI - math.log(N))
    lse = logsumexp_rows(whiten(test.to(la), L), whiten(train.to(la), L),
                         dtype)
    return lse + lognorm


def ckde_logl(train, test, H, dtype=torch.float64):
    """(M,) float64 conditional log-density of column 0 given the other
    columns: the joint KDE of ``train`` with bandwidth ``H`` over the
    marginal KDE of its evidence columns with ``H``'s evidence block."""
    joint = kde_logl(train, test, H, dtype)
    if train.shape[1] == 1:
        return joint
    return joint - kde_logl(train[:, 1:], test[:, 1:], H[1:, 1:], dtype)


def positive_definite(H) -> bool:
    return bool(torch.linalg.cholesky_ex(H.double()).info == 0)
