"""Batched Cholesky with the JAX package's failure semantics."""

from __future__ import annotations

import math

import torch

__all__ = ["cholesky_or_nan"]


def cholesky_or_nan(A):
    """Lower Cholesky factors of a batch of matrices (..., d, d). A matrix
    that is not positive definite gets a factor whose lower triangle is NaN,
    as ``jnp.linalg.cholesky`` returns it, where ``torch.linalg.cholesky``
    would raise: a degenerate CV fold must carry NaN into its score (which
    the score maps to −inf) and must not stop the batch. A factor with an
    entry that is not finite (a NaN in ``A``, which LAPACK refuses as a
    pivot and a GPU solver may carry through) counts as a failure too, so
    every backend gives the whole NaN factor. Never synchronises with the
    device."""
    L, info = torch.linalg.cholesky_ex(A)
    good = (info == 0) & torch.isfinite(L).all(dim=-1).all(dim=-1)
    return torch.where(good[..., None, None], L, math.nan).tril()
