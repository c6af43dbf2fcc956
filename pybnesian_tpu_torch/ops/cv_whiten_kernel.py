"""Stages 1 and 3 of the CV-CKDE score: the per-(family, fold) whitening
before the pairs kernel, and the per-fold sums after it; and the inputs of
the UCV bandwidth searches of a CV score, from the same gather and sums.

Replaces ``ckde_cv_whitened_parts`` and ``_flash_reduce`` of
``pybnesian_tpu/ops/kde.py``, which the JAX package runs as jitted XLA (no
Pallas kernel). What lives here:

- :func:`ckde_cv_whitened_parts` and :func:`ckde_cv_fold_reduce_reference`,
  the plain torch versions, on any device and dtype; for float32 inputs they
  take their statistics in float64 and round each output once, as the
  kernels do;
- :func:`ckde_cv_whiten_reference`, the whitening's plain version in the
  kernel's output layout (G = F·K programs, kernel #1's arguments);
- :func:`ckde_cv_whiten` and :func:`ckde_cv_fold_reduce`, the wrappers:
  plain version for CPU tensors, the CUDA kernels ``ckde_cv_whiten_f32``
  and ``ckde_cv_fold_reduce_f32`` (``pybnesian_tpu_torch/csrc/cv_whiten.cu``)
  for CUDA tensors, with launch counters ``.launches``;
- :func:`ucv_starts` and its plain version :func:`ucv_starts_reference`:
  per (family, fold) the normal-reference start vech(chol(H)) of the UCV
  search and the fold's valid train rows, compacted, for the search kernel
  (``ucv_starts_f32``, in the same source; replaces the host's gather,
  ``np.cov`` and ``np.linalg.cholesky`` per problem, which the JAX package
  also runs on the host, ``pybnesian_tpu/learning/scores/likelihood.py``);
- :func:`whiten_leaves` (:func:`~.cuda_build.leaf_count`) and
  :func:`_launch_plan`, the whitening's fixed leaves of a program's train
  rows and the cluster size S that spreads them over a thread-block
  cluster; :func:`_reduce_plan`, the cluster size S that spreads a
  family's folds over the fold reduce's cluster;
- the ctypes binding of those kernels (built at first use by
  :mod:`.cuda_build`).

The kernels sum in float64 in an order fixed by the shapes (ntr, nte, K)
alone, no atomics: the whitening and the UCV starts over
:func:`whiten_leaves` leaves of
fixed row strides per thread, a fixed tree over the block and a balanced
tree over the leaves, whichever of the S blocks of its cluster sweeps a
leaf; the fold sums each fold in one block's fixed order and tree and the
folds in order, whichever of the S blocks of its family's cluster sums a
fold. So a family's whitened rows, CV score and UCV starts are the same
bits alone and in any batch, at every S, and, since
every sum is a column's or an entry's own, whatever the batch's widest
family. The torch reductions of the plain version choose their order by
shape and device.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import cuda_build
from .ckde_cv_kernel import _sm_count
from .cuda_build import MAX_SPLIT, check_tensors, cluster_split, leaf_count
from .linalg import cholesky_or_nan

__all__ = [
    "ckde_cv_whiten",
    "ckde_cv_whiten_reference",
    "ckde_cv_whitened_parts",
    "ckde_cv_fold_reduce",
    "ckde_cv_fold_reduce_reference",
    "ucv_starts",
    "ucv_starts_reference",
    "whiten_leaves",
    "MAX_DPAD",
]

LOG_2PI = math.log(2.0 * math.pi)
#: widest family the whitening kernel takes (kernel #1's ``MAX_DPAD``)
MAX_DPAD = 16
_RULES = {"nr": 0, "scott": 1}
# The launch plan's limits; each mirrors a constant of csrc/cv_whiten.cu.
#: threads per block (kThreads)
THREADS = 256
#: blocks per SM that the plan aims for, splitting each program's leaves
#: over a cluster to get them, twice as many for families wider than
#: :data:`WIDE_DPAD`. Measured on the H100 (tools/whiten_lg_ab.py,
#: PERF.md): phase 4's 150 programs ran fastest split 4 ways at dpad 1 and
#: 3, 8 ways at dpad 16, whose blocks each factor a 16 x 16 bandwidth
TARGET_BLOCKS_PER_SM = 4
#: widest family that the plan gives TARGET_BLOCKS_PER_SM blocks per SM
WIDE_DPAD = 8
#: most folds a block of the fold reduce sums side by side in one round
#: (kMaxFolds): their two sums each go through one block sum of kMaxSums
MAX_FOLDS = 18


#: L, the leaves of one program's ntr train rows in the whitening and
#: UCV-start kernels: the shared rule of csrc/common.cuh
whiten_leaves = leaf_count


@functools.lru_cache(maxsize=1024)
def _launch_plan(G, ntr, dpad, sm_count):
    """S, the blocks of the thread-block cluster that whitens each of G
    programs of ntr train rows and dpad columns on a card of ``sm_count``
    SMs: :func:`~.cuda_build.cluster_split`'s for
    :data:`TARGET_BLOCKS_PER_SM` blocks per SM (twice that above
    :data:`WIDE_DPAD`) over :func:`whiten_leaves`."""
    target = TARGET_BLOCKS_PER_SM * (2 if dpad > WIDE_DPAD else 1)
    return cluster_split(max(G, 1), target * sm_count, whiten_leaves(ntr))


def _reduce_plan(F, K, sm_count):
    """S, the blocks of the thread-block cluster that sums each of F
    families' K folds on a card of ``sm_count`` SMs: enough for F·S to
    reach the SM count, at most :data:`MAX_SPLIT` and K, then the least S
    that leaves its ranks as few folds each (rank q sums folds q, q + S,
    ...): a block more shortens nothing. S only decides which block sums
    which fold: the result is the same at every S."""
    split = min(K, MAX_SPLIT, -(-sm_count // F))
    return -(-K // -(-K // split))


def _check_split(split):
    if split not in (1, 2, 4, 8):
        raise ValueError(f"split {split!r} is not a power of two up to "
                         f"{MAX_SPLIT}")


def ckde_cv_whitened_parts(data, null_mask, col_idx, col_mask, tr_idx,
                           tr_mask, te_idx, te_mask, rule="nr",
                           bandwidths=None):
    """Stage 1 of the CV-CKDE path: per (family, fold) gather, bandwidth,
    Cholesky and whitening — everything *before* the pairwise part. The
    bandwidth is the rule's (``rule``: normal reference "nr" or "scott")
    unless ``bandwidths`` gives one matrix per (family, fold): (F, K, djmax,
    djmax) in the family's column order (evidence first, variable last),
    entries of padded columns ignored — the route of UCV-selected and
    user-selected bandwidths.

    data: (n, D) values (nulls zeroed); null_mask: (n, D) 1.0 where null;
    col_idx/col_mask: (F, djmax) family columns, evidence first / variable
    last; tr_idx/tr_mask: (K, ntr) fold train rows (shared across families);
    te_idx/te_mask: (K, nte). Returns ``(jtr, neg, zv_tr, jte, zv_te, wte,
    lndiff, ok)`` with leading (F, K) axes: jtr (F, K, ntr, djmax), neg and
    zv_tr (F, K, ntr), jte (F, K, nte, djmax), zv_te and wte (F, K, nte),
    lndiff and ok (F, K). A bandwidth that is not positive definite gives
    NaN parts (:func:`cholesky_or_nan`); ``ok`` is 0 where a fold has too
    few rows.

    Every statistic is taken in float64: for float32 data each output is
    one rounding of its float64 value, except ``lndiff``, which stays
    float64 (the fold sums multiply it by the fold's test weight)."""
    dtype = data.dtype
    f64 = torch.float64
    data = data.to(f64)
    null_mask = null_mask.to(f64)
    col_mask = col_mask.to(f64)
    tr_mask = tr_mask.to(f64)
    te_mask = te_mask.to(f64)
    F, djmax = col_idx.shape
    fam = data[:, col_idx].permute(1, 0, 2) * col_mask[:, None, :]
    fam_null = torch.amax(
        null_mask[:, col_idx].permute(1, 0, 2) * col_mask[:, None, :], dim=2
    )
    fvalid = 1.0 - fam_null                                    # (F, n)
    d_eff = torch.sum(col_mask, dim=1)                         # (F,)
    dim_ids = torch.arange(djmax, dtype=f64, device=data.device)
    # one-hot of the variable position (= last valid column)
    vsel = (dim_ids[None, :] == d_eff[:, None] - 1.0).to(f64) * col_mask

    w = tr_mask[None] * fvalid[:, tr_idx]                      # (F, K, ntr)
    train = fam[:, tr_idx]                                     # (F, K, ntr, d)
    n_eff = torch.sum(w, dim=2)                                # (F, K)
    d_col = d_eff[:, None]
    if bandwidths is not None:
        H = bandwidths.to(f64) * (
            col_mask[:, :, None] * col_mask[:, None, :])[:, None]
    else:
        mean = torch.sum(train * w[..., None], dim=2) / n_eff[..., None]
        xc = (train - mean[:, :, None, :]) * (
            w[..., None] * col_mask[:, None, None, :]
        )
        cov = xc.mT @ xc / (n_eff - 1.0)[..., None, None]
        if rule == "nr":
            k = (4.0 / (n_eff * (d_col + 2.0))) ** (2.0 / (d_col + 4.0))
        elif rule == "scott":
            k = n_eff ** (-2.0 / (d_col + 4.0))
        else:
            raise ValueError(f"unknown bandwidth rule {rule!r}")
        H = k[..., None, None] * cov
    H = H + torch.diag_embed(1.0 - col_mask)[:, None]
    L = cholesky_or_nan(H)
    eye = torch.eye(djmax, dtype=f64, device=data.device).expand_as(L)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    logdiag = torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1)))
    # lndiff = jln − mln = −log|L_vv| − ½ log 2π (the n_eff terms cancel)
    lndiff = -torch.sum(logdiag * vsel[:, None, :], dim=2) - 0.5 * LOG_2PI
    jtr = train @ Linv.mT
    jte = fam[:, te_idx] @ Linv.mT
    zv_tr = torch.sum(jtr * vsel[:, None, None, :], dim=3)
    zv_te = torch.sum(jte * vsel[:, None, None, :], dim=3)
    neg = torch.where(w > 0, 0.0, -math.inf).to(f64)
    wte = te_mask[None] * fvalid[:, te_idx]
    ok = (n_eff > d_col).to(f64)
    return (jtr.to(dtype), neg.to(dtype), zv_tr.to(dtype), jte.to(dtype),
            zv_te.to(dtype), wte.to(dtype), lndiff, ok.to(dtype))


def ckde_cv_whiten_reference(data, null_mask, col_idx, col_mask, tr_idx,
                             tr_mask, te_idx, te_mask, rule="nr",
                             bandwidths=None):
    """Plain torch version of the whitening kernel, same arguments and
    result as :func:`ckde_cv_whiten`, on any device: the parts of
    :func:`ckde_cv_whitened_parts` with the (family, fold) pairs flattened
    to G = F·K programs, contiguous, the first seven in
    :func:`~.ckde_cv_kernel.ckde_cv_pairs`'s argument order. Evidence-free
    families are flagged (``no_ev``): their marginal logsumexp is exactly
    ``lm_const`` = log n_eff, so kernel #1 skips the whole marginal pass."""
    jtr, neg, zv_tr, jte, zv_te, wte, lndiff, ok = ckde_cv_whitened_parts(
        data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask,
        rule=rule, bandwidths=bandwidths,
    )
    F, K, ntr, dpad = jtr.shape
    nte = jte.shape[2]
    no_ev = (torch.sum(col_mask, dim=1) <= 1.0)[:, None].expand(F, K)
    n_valid = torch.sum((neg == 0.0).to(torch.float64), dim=2)
    lm_const = torch.log(torch.clamp(n_valid, min=1.0))

    def flat(t, *shape):
        return t.reshape(F * K, *shape).to(data.dtype).contiguous()

    return (flat(jtr, ntr, dpad), flat(neg, ntr), flat(zv_tr, ntr),
            flat(jte, nte, dpad), flat(zv_te, nte), flat(no_ev),
            flat(lm_const), wte.contiguous(), lndiff.contiguous(),
            ok.contiguous())


def ckde_cv_fold_reduce_reference(out, wte, lndiff, ok):
    """(F,) CV log-likelihood from the (F, K, nte) per-test-row
    ``logsumexp_joint − logsumexp_marg``; NaN marks a degenerate fold.
    Summed in float64, returned in ``out``'s dtype."""
    f64 = torch.float64
    w = wte.to(f64)
    rows = torch.where(wte > 0, out.to(f64), 0.0)
    fold_ll = torch.sum(rows * w, dim=2) + lndiff.to(f64) * torch.sum(w, dim=2)
    fold_ll = torch.where(ok > 0, fold_ll, math.nan)
    return torch.sum(fold_ll, dim=1).to(out.dtype)


def _check_whiten_args(data, null_mask, col_idx, col_mask, tr_idx, tr_mask,
                       te_idx, te_mask, rule, bandwidths):
    if not isinstance(data, torch.Tensor) or data.dim() != 2:
        raise ValueError("data must be an (n, D) torch.Tensor")
    if not isinstance(col_idx, torch.Tensor) or col_idx.dim() != 2:
        raise ValueError("col_idx must be an (F, dpad) torch.Tensor")
    for name, t in (("tr_idx", tr_idx), ("te_idx", te_idx)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"{name} must be a (K, rows) torch.Tensor")
    n, D = data.shape
    F, dpad = col_idx.shape
    K, ntr = tr_idx.shape
    nte = te_idx.shape[1]
    tensors = {"data": data, "null_mask": null_mask, "col_idx": col_idx,
               "col_mask": col_mask, "tr_idx": tr_idx, "tr_mask": tr_mask,
               "te_idx": te_idx, "te_mask": te_mask}
    shapes = {"data": (n, D), "null_mask": (n, D), "col_idx": (F, dpad),
              "col_mask": (F, dpad), "tr_idx": (K, ntr), "tr_mask": (K, ntr),
              "te_idx": (K, nte), "te_mask": (K, nte)}
    if bandwidths is not None:
        tensors["bandwidths"] = bandwidths
        shapes["bandwidths"] = (F, K, dpad, dpad)
    elif rule not in _RULES:
        raise ValueError(f"unknown bandwidth rule {rule!r}")
    dtypes = {name: torch.int64 if name.endswith("idx") else torch.float32
              for name in tensors}
    check_tensors(tensors, dtypes, shapes, data.device)
    if not 1 <= dpad <= MAX_DPAD:
        raise ValueError(f"dpad {dpad} outside 1..{MAX_DPAD}")
    return n, D, F, K, ntr, nte, dpad


def ckde_cv_whiten(data, null_mask, col_idx, col_mask, tr_idx, tr_mask,
                   te_idx, te_mask, rule="nr", bandwidths=None, *,
                   split=None):
    """The whitened parts of F families × K folds in the layout of the
    pairs kernel: ``(jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const, wte,
    lndiff, ok)``, the first seven :func:`~.ckde_cv_kernel.ckde_cv_pairs`'s
    arguments for G = F·K programs (jtr (G, ntr, dpad), neg, zv_tr (G, ntr),
    jte (G, nte, dpad), zv_te (G, nte), no_ev, lm_const (G,)), then
    :func:`ckde_cv_fold_reduce`'s: wte (F, K, nte), lndiff (F, K) float64,
    ok (F, K).

    Arguments as :func:`ckde_cv_whitened_parts`'s: float32 values and
    masks, int64 indices, ``bandwidths`` float32 or None (then ``rule`` is
    "nr" or "scott"), all contiguous and on one device, 1 ≤ dpad ≤
    :data:`MAX_DPAD`. Indices must lie in range: the kernel reads NaN for
    one that does not, the plain version raises.

    CPU tensors take :func:`ckde_cv_whiten_reference`. CUDA tensors launch
    the kernel, counted in ``ckde_cv_whiten.launches``, or raise; its
    cluster size is ``split`` (1, 2, 4 or 8) when given, else
    :func:`_launch_plan`'s, and gives the same bits either way."""
    n, D, F, K, ntr, nte, dpad = _check_whiten_args(
        data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask,
        rule, bandwidths)
    if split is not None:
        _check_split(split)
    if data.device.type == "cpu":
        return ckde_cv_whiten_reference(
            data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx,
            te_mask, rule=rule, bandwidths=bandwidths)
    if data.device.type != "cuda":
        raise ValueError(f"no ckde_cv_whiten kernel for {data.device}")
    G = F * K
    device = data.device
    if split is None:
        split = _launch_plan(G, ntr, dpad, _sm_count(device))
    if G * split >= 2**31:
        raise ValueError(f"{G} programs of {split} blocks exceed the grid's "
                         "2**31 - 1")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    outs = (empty(G, ntr, dpad), empty(G, ntr), empty(G, ntr),
            empty(G, nte, dpad), empty(G, nte), empty(G), empty(G),
            empty(F, K, nte), empty(F, K, dtype=torch.float64), empty(F, K))
    if G == 0:
        return outs
    code = 2 if bandwidths is not None else _RULES[rule]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _load_library().ckde_cv_whiten_f32(
            data.data_ptr(), null_mask.data_ptr(), col_idx.data_ptr(),
            col_mask.data_ptr(), tr_idx.data_ptr(), tr_mask.data_ptr(),
            te_idx.data_ptr(), te_mask.data_ptr(),
            None if bandwidths is None else bandwidths.data_ptr(),
            *(t.data_ptr() for t in outs), n, D, F, K, ntr, nte, dpad, code,
            split, stream,
        )
    if err != 0:
        raise RuntimeError(f"ckde_cv_whiten kernel launch failed (F {F}, K "
                           f"{K}, dpad {dpad}, split {split}): CUDA error "
                           f"{err}")
    ckde_cv_whiten.launches += 1
    return outs


ckde_cv_whiten.launches = 0


def ckde_cv_fold_reduce(out, wte, lndiff, ok, *, split=None):
    """(F,) float32 CV log-likelihood of F families from the pairs kernel's
    rows ``out`` (F, K, nte) float32, the test weights ``wte`` (F, K, nte)
    float32, ``lndiff`` (F, K) float64 and ``ok`` (F, K) float32, all
    contiguous: per fold Σ rows·wte + lndiff·Σ wte (rows where wte is 0
    count 0), NaN where ``ok`` is 0, summed over the folds in order.

    CPU tensors take :func:`ckde_cv_fold_reduce_reference`. CUDA tensors
    launch the kernel, counted in ``ckde_cv_fold_reduce.launches``, or
    raise; its cluster size is ``split`` (1 to min(K, 8)) when given, else
    :func:`_reduce_plan`'s, and gives the same bits either way."""
    if not isinstance(out, torch.Tensor) or out.dim() != 3:
        raise ValueError("out must be an (F, K, nte) torch.Tensor")
    F, K, nte = out.shape
    check_tensors({"out": out, "wte": wte, "lndiff": lndiff, "ok": ok},
                  {"out": torch.float32, "wte": torch.float32,
                   "lndiff": torch.float64, "ok": torch.float32},
                  {"out": (F, K, nte), "wte": (F, K, nte), "lndiff": (F, K),
                   "ok": (F, K)}, out.device)
    if split is not None and split not in range(1, min(K, MAX_SPLIT) + 1):
        raise ValueError(f"split {split!r} is not in 1..min(K {K}, "
                         f"{MAX_SPLIT})")
    if out.device.type == "cpu":
        return ckde_cv_fold_reduce_reference(out, wte, lndiff, ok)
    if out.device.type != "cuda":
        raise ValueError(f"no ckde_cv_fold_reduce kernel for {out.device}")
    result = torch.empty(F, dtype=torch.float32, device=out.device)
    if F == 0:
        return result
    if K == 0:
        return result.zero_()
    if split is None:
        split = _reduce_plan(F, K, _sm_count(out.device))
    if F * split >= 2**31:
        raise ValueError(f"{F} families of {split} blocks exceed the grid's "
                         "2**31 - 1")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _load_library().ckde_cv_fold_reduce_f32(
            out.data_ptr(), wte.data_ptr(), lndiff.data_ptr(), ok.data_ptr(),
            result.data_ptr(), F, K, nte, split, stream)
    if err != 0:
        raise RuntimeError(f"ckde_cv_fold_reduce kernel launch failed (F "
                           f"{F}, K {K}, nte {nte}, split {split}): CUDA "
                           f"error {err}")
    ckde_cv_fold_reduce.launches += 1
    return result


ckde_cv_fold_reduce.launches = 0


def ucv_starts_reference(data, null_mask, col_idx, tr_idx, tr_mask):
    """Plain torch version of :func:`ucv_starts`, same arguments and
    result, on any device and dtype. A row of a fold counts when its mask
    is 1 and no column of the family is null there; from the n rows that
    count, in float64: S = Σ (x − mean)(x − mean)ᵀ and the start
    vech(chol(k·S/(n − 1))), k = (4/(n(d + 2)))^(2/(d + 4)) the normal
    reference's factor, NaN where ``ok`` is 0."""
    f64 = torch.float64
    F, d = col_idx.shape
    K, ntr = tr_idx.shape
    fam = data.to(f64)[:, col_idx].permute(1, 0, 2)             # (F, n, d)
    fvalid = 1.0 - torch.amax(null_mask.to(f64)[:, col_idx], dim=2).T
    w = tr_mask.to(f64)[None] * fvalid[:, tr_idx]               # (F, K, ntr)
    x = fam[:, tr_idx]                                          # (F, K, ntr, d)
    n = torch.sum(w, dim=2)
    mean = torch.sum(x * w[..., None], dim=2) / n[..., None]
    xc = (x - mean[:, :, None]) * w[..., None]
    cov = xc.mT @ xc / (n - 1.0)[..., None, None]
    k = (4.0 / (n * (d + 2.0))) ** (2.0 / (d + 4.0))
    L = cholesky_or_nan(k[..., None, None] * cov)
    ok = (n > d) & ~torch.isnan(L[..., 0, 0])
    rows = [i for j in range(d) for i in range(j, d)]
    cols = [j for j in range(d) for _ in range(j, d)]
    starts = torch.where(ok[..., None], L[..., rows, cols], math.nan)
    # the rows that count first, each part in fold order
    keep = w > 0
    order = torch.argsort((~keep).to(torch.uint8), dim=2, stable=True)
    kept = torch.take_along_dim(keep, order, dim=2)
    X = torch.where(kept[..., None],
                    torch.take_along_dim(x, order[..., None], dim=2), 0.0)
    G = F * K
    dtype = data.dtype
    return (X.reshape(G, ntr, d).to(dtype), kept.reshape(G, ntr).to(dtype),
            torch.sum(keep, dim=2).reshape(G).to(dtype),
            starts.reshape(G, len(rows)), ok.reshape(G).to(dtype))


def ucv_starts(data, null_mask, col_idx, tr_idx, tr_mask, *, split=None):
    """The inputs of the UCV bandwidth searches of F families × K folds of
    one width d, ``(X, valid, Ns, starts, ok)`` for B = F·K problems b = f·K
    + k: X (B, ntr, d) the fold's train rows that count (mask 1, no column
    of the family null), in fold order, then zero rows; valid (B, ntr) 1 on
    those rows, 0 after; Ns (B,) their count; starts (B, d(d + 1)/2)
    float64, vech of the Cholesky factor of the rows' normal-reference
    bandwidth (:func:`ucv_starts_reference`); ok (B,) 1 where the problem
    has more than d rows and that factor exists, else 0 and the start NaN
    (a search lane from a NaN start ends after its first phase).

    data (n, D) values (nulls zeroed) and null_mask (n, D) 1.0 where null,
    in one float dtype; col_idx (F, d) int64, each family's columns with
    the variable FIRST (the search's order); tr_idx (K, ntr) int64 and
    tr_mask (K, ntr) the folds' train rows; all contiguous and on one
    device, 1 ≤ d ≤ :data:`MAX_DPAD`.

    CPU tensors and float64 take :func:`ucv_starts_reference`. Float32 CUDA
    tensors launch the kernel ``ucv_starts_f32``, counted in
    ``ucv_starts.launches``, or raise; its cluster size is ``split`` (1,
    2, 4 or 8) when given, else the whitening's :func:`_launch_plan`, and
    gives the same bits either way. The rows are copies of the data's
    cells, so X is the same bits by either route."""
    if not isinstance(col_idx, torch.Tensor) or col_idx.dim() != 2:
        raise ValueError("col_idx must be an (F, d) torch.Tensor")
    if not isinstance(tr_idx, torch.Tensor) or tr_idx.dim() != 2:
        raise ValueError("tr_idx must be a (K, ntr) torch.Tensor")
    if not isinstance(data, torch.Tensor) or data.dim() != 2:
        raise ValueError("data must be an (n, D) torch.Tensor")
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"data must be float32 or float64, got {data.dtype}")
    n, D = data.shape
    F, d = col_idx.shape
    K, ntr = tr_idx.shape
    check_tensors({"data": data, "null_mask": null_mask, "col_idx": col_idx,
                   "tr_idx": tr_idx, "tr_mask": tr_mask},
                  {"data": data.dtype, "null_mask": data.dtype,
                   "col_idx": torch.int64, "tr_idx": torch.int64,
                   "tr_mask": data.dtype},
                  {"data": (n, D), "null_mask": (n, D), "col_idx": (F, d),
                   "tr_idx": (K, ntr), "tr_mask": (K, ntr)}, data.device)
    if not 1 <= d <= MAX_DPAD:
        raise ValueError(f"d {d} outside 1..{MAX_DPAD}")
    if split is not None:
        _check_split(split)
    if data.device.type == "cpu" or data.dtype == torch.float64:
        return ucv_starts_reference(data, null_mask, col_idx, tr_idx,
                                    tr_mask)
    if data.device.type != "cuda":
        raise ValueError(f"no ucv_starts kernel for {data.device}")
    G = F * K
    device = data.device
    if split is None:
        split = _launch_plan(G, ntr, d, _sm_count(device))
    if G * split >= 2**31:
        raise ValueError(f"{G} problems of {split} blocks exceed the grid's "
                         "2**31 - 1")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    outs = (empty(G, ntr, d), empty(G, ntr), empty(G),
            empty(G, d * (d + 1) // 2, dtype=torch.float64), empty(G))
    if G == 0:
        return outs
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _load_library().ucv_starts_f32(
            data.data_ptr(), null_mask.data_ptr(), col_idx.data_ptr(),
            tr_idx.data_ptr(), tr_mask.data_ptr(),
            *(t.data_ptr() for t in outs), n, D, F, K, ntr, d, split, stream)
    if err != 0:
        raise RuntimeError(f"ucv_starts kernel launch failed (F {F}, K {K}, "
                           f"d {d}, split {split}): CUDA error {err}")
    ucv_starts.launches += 1
    return outs


ucv_starts.launches = 0


@functools.cache
def _load_library():
    lib = cuda_build.load("cv_whiten.cu")
    fn = lib.ckde_cv_whiten_f32
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    fn = lib.ucv_starts_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    fn = lib.ckde_cv_fold_reduce_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib
