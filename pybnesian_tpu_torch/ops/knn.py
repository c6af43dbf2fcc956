"""The CMIknn (Runge 2018) conditional-independence estimates on tensors.

Counterpart of ``pybnesian_tpu/ops/knn.py``, with the same functions.
Pairwise Chebyshev distances are built per permutation; the k-NN radius is
the (k+1)-th smallest entry of a row (self included); all permutations of a
shuffle test run in chunks of ``(S_chunk, N, N)`` sized to
:data:`ELEM_BUDGET`, reusing the fixed y (and z) distances — only the x
distances change per permutation.

The inputs are ranks: integers, which float32 holds exactly up to 2²⁴, so
the distances, radii and neighbour counts are exact in either float dtype.
The digamma of the counts is taken in float64 and summed per row in fixed
point (int64, :func:`_exact_row_sum`): the sum is then the same whatever
the reduction order, so a row's estimate does not depend on the chunk, the
batch or the device's reduction plan it ran in, and a shuffled estimate
that ties the observed one in exact arithmetic ties it here too.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cmi_knn_pair", "cmi_knn_conditional", "cmi_knn_pair_batch",
           "cmi_knn_conditional_batch", "cmi_knn_pair_tests",
           "cmi_knn_conditional_tests"]

# elements of one (S_chunk, N, N) distance block; a chunk holds a few such
# blocks (the joint distances and the comparisons) at once
ELEM_BUDGET = 1 << 27
# bits a row sum of fixed-point terms may fill, one short of int64's sign bit
_INT64_BITS = 62


def _pairwise_abs(a):
    """(..., N, N) |a_i - a_j| for (..., N) vectors."""
    return (a[..., :, None] - a[..., None, :]).abs()


def _exact_row_sum(terms):
    """Row sums of float64 ``terms`` (..., N) in fixed point: each term
    rounded to a multiple of 2^-b (b as large as int64 allows for N terms),
    summed as integers. Integer addition is associative, so the result does
    not depend on the order of the reduction."""
    n = terms.shape[-1]
    # a term is at most three digammas of counts ≤ N, each below log2(N) + 1
    bound = 3.0 * (math.log2(max(n, 2)) + 1.0) * n
    bits = min(44, _INT64_BITS - math.ceil(math.log2(bound)))
    scale = float(2 ** bits)
    fixed = torch.round(terms * scale).to(torch.int64)
    return fixed.sum(-1).to(torch.float64) / scale


def _digamma(counts):
    return torch.special.digamma(counts.to(torch.float64))


def _digamma_of(v: float) -> float:
    return float(torch.special.digamma(torch.tensor(v, dtype=torch.float64)))


def _radius(joint, k):
    """Distance to the k-th neighbour, self excluded: the self-distance 0 is
    the smallest entry, so the (k+1)-th smallest of the row."""
    return torch.topk(joint, k + 1, dim=-1, largest=False).values[..., k]


def _pair_rows(xs, y_dist, k):
    """Kraskov MI of each row of ``xs`` (S, N) against the fixed y."""
    n = xs.shape[-1]
    dx = _pairwise_abs(xs)
    eps = _radius(torch.maximum(dx, y_dist), k)[..., None]
    n_x = (dx < eps).sum(-1)
    n_y = (y_dist < eps).sum(-1)
    total = _exact_row_sum(_digamma(n_x) + _digamma(n_y))
    return -total / n + _digamma_of(float(k)) + _digamma_of(float(n))


def _conditional_rows(xs, y_dist, dz, k):
    """CMI of each row of ``xs`` (S, N) against the fixed y given z, whose
    pairwise Chebyshev distances are ``dz`` (N, N)."""
    n = xs.shape[-1]
    dx = _pairwise_abs(xs)
    eps = _radius(torch.maximum(torch.maximum(dx, y_dist), dz), k)[..., None]
    within_z = dz < eps
    n_z = within_z.sum(-1)
    n_xz = (within_z & (dx < eps)).sum(-1)
    n_yz = (within_z & (y_dist < eps)).sum(-1)
    total = _exact_row_sum(_digamma(n_z) - _digamma(n_xz) - _digamma(n_yz))
    return total / n + _digamma_of(float(k))


def _chunked(rows_fn, xs, *fixed):
    """``rows_fn`` over the rows of ``xs`` (S, N), ``S_chunk`` rows at a
    time; returns the (S,) float64 estimates."""
    n = xs.shape[-1]
    step = max(1, ELEM_BUDGET // (n * n))
    return torch.cat([rows_fn(xs[s:s + step], *fixed)
                      for s in range(0, xs.shape[0], step)])


def cmi_knn_pair(x, y, k):
    """Kraskov MI estimate for ranked 1-D x, y (reference mi_pair,
    mutual_information.cpp:9-42). A float64 scalar tensor."""
    return _pair_rows(x[None], _pairwise_abs(y), k)[0]


def cmi_knn_conditional(x, y, dz, k):
    """CMI estimate for ranked x, y given z with precomputed pairwise
    Chebyshev z-distances (reference mi_triple/mi_general,
    mutual_information.cpp:44-135). A float64 scalar tensor."""
    return _conditional_rows(x[None], _pairwise_abs(y), dz, k)[0]


def cmi_knn_pair_batch(xs, y, k):
    """MI for S permutations of x against fixed y. xs: (S, N); (S,)."""
    return _chunked(lambda c, dy: _pair_rows(c, dy, k), xs, _pairwise_abs(y))


def cmi_knn_conditional_batch(xs, y, dz, k):
    """CMI for S locally-shuffled x vectors against fixed y, z. xs: (S, N);
    (S,)."""
    return _chunked(lambda c, dy, d: _conditional_rows(c, dy, d, k), xs,
                    _pairwise_abs(y), dz)


def cmi_knn_pair_tests(xs_t, ys_t, k):
    """MI for T tests × S permutations: xs_t (T, S, N) against per-test
    ys_t (T, N). Returns (T, S)."""
    return torch.stack([cmi_knn_pair_batch(xs, y, k)
                        for xs, y in zip(xs_t, ys_t)])


def cmi_knn_conditional_tests(xs_t, ys_t, dz_t, k):
    """CMI for T tests × S draws: xs_t (T, S, N), ys_t (T, N), dz_t
    (T, N, N). Returns (T, S)."""
    return torch.stack([cmi_knn_conditional_batch(xs, y, dz, k)
                        for xs, y, dz in zip(xs_t, ys_t, dz_t)])
