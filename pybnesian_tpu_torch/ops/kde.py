"""Cross-validated conditional-KDE (CKDE) scores on torch tensors.

Port of ``pybnesian_tpu/ops/kde.py`` as far as the CV score needs it. One
call scores F CKDE families over K folds:

1. :func:`ckde_cv_whitened_parts` — per (family, fold) row gather, rule
   bandwidth (normal reference or Scott), Cholesky and whitening;
2. the pairwise joint-and-marginal logsumexp — on a GPU the hand-written
   kernel behind :func:`ckde_cv_pairs` (:func:`ckde_cv_alldevice_flash`),
   elsewhere the dense chunked form of :func:`ckde_cv_alldevice`;
3. :func:`_flash_reduce` — the per-fold sums.

Family columns are laid out EVIDENCE FIRST with the variable last. The
Cholesky factor of the joint bandwidth is lower-triangular, so its leading
(evidence × evidence) block is the marginal's factor (the reference shares
sub-ranges of one device buffer the same way, CKDE.hpp:182-200): one
whitening serves both densities, and ``marg_d2 = joint_d2 − Δz_var²`` where
``z_var`` is the whitened variable coordinate.

JAX's ``vmap`` over families and folds is written out as leading (F, K)
axes; its ``lax.map`` over test chunks is a Python loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ckde_cv_kernel import ckde_cv_pairs
from .linalg import cholesky_or_nan

__all__ = [
    "ckde_cv_whitened_parts",
    "ckde_cv_alldevice",
    "ckde_cv_alldevice_flash",
    "ckde_cv_pair_args",
    "flash_cv_selfcheck",
]

LOG_2PI = math.log(2.0 * math.pi)

# elements of one (programs, test chunk, train rows) pair block in the
# dense path: 2**24 keeps each of its few live temporaries at 64 MiB in
# float32 and 128 MiB in float64
_DENSE_BLOCK = 1 << 24


def ckde_cv_whitened_parts(data, null_mask, col_idx, col_mask, tr_idx,
                           tr_mask, te_idx, te_mask, rule="nr"):
    """Stage 1 of the CV-CKDE path: per (family, fold) gather, rule
    bandwidth, Cholesky and whitening — everything *before* the pairwise
    part.

    data: (n, D) values (nulls zeroed); null_mask: (n, D) 1.0 where null;
    col_idx/col_mask: (F, djmax) family columns, evidence first / variable
    last; tr_idx/tr_mask: (K, ntr) fold train rows (shared across families);
    te_idx/te_mask: (K, nte). Returns ``(jtr, neg, zv_tr, jte, zv_te, wte,
    lndiff, ok)`` with leading (F, K) axes: jtr (F, K, ntr, djmax), neg and
    zv_tr (F, K, ntr), jte (F, K, nte, djmax), zv_te and wte (F, K, nte),
    lndiff and ok (F, K). A bandwidth that is not positive definite gives
    NaN parts (:func:`cholesky_or_nan`); ``ok`` is 0 where a fold has too
    few rows."""
    F, djmax = col_idx.shape
    dtype = data.dtype
    fam = data[:, col_idx].permute(1, 0, 2) * col_mask[:, None, :]
    fam_null = torch.amax(
        null_mask[:, col_idx].permute(1, 0, 2) * col_mask[:, None, :], dim=2
    )
    fvalid = 1.0 - fam_null                                    # (F, n)
    d_eff = torch.sum(col_mask, dim=1)                         # (F,)
    dim_ids = torch.arange(djmax, dtype=dtype, device=data.device)
    # one-hot of the variable position (= last valid column)
    vsel = (dim_ids[None, :] == d_eff[:, None] - 1.0).to(dtype) * col_mask

    w = tr_mask[None] * fvalid[:, tr_idx]                      # (F, K, ntr)
    train = fam[:, tr_idx]                                     # (F, K, ntr, d)
    n_eff = torch.sum(w, dim=2)                                # (F, K)
    mean = torch.sum(train * w[..., None], dim=2) / n_eff[..., None]
    xc = (train - mean[:, :, None, :]) * (
        w[..., None] * col_mask[:, None, None, :]
    )
    cov = xc.mT @ xc / (n_eff - 1.0)[..., None, None]
    d_col = d_eff[:, None]
    if rule == "nr":
        k = (4.0 / (n_eff * (d_col + 2.0))) ** (2.0 / (d_col + 4.0))
    elif rule == "scott":
        k = n_eff ** (-2.0 / (d_col + 4.0))
    else:
        raise ValueError(f"unknown bandwidth rule {rule!r}")
    H = k[..., None, None] * cov + torch.diag_embed(1.0 - col_mask)[:, None]
    L = cholesky_or_nan(H)
    eye = torch.eye(djmax, dtype=dtype, device=data.device).expand_as(L)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    logdiag = torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1)))
    # lndiff = jln − mln = −log|L_vv| − ½ log 2π (the n_eff terms cancel)
    lndiff = -torch.sum(logdiag * vsel[:, None, :], dim=2) - 0.5 * LOG_2PI
    jtr = train @ Linv.mT
    jte = fam[:, te_idx] @ Linv.mT
    zv_tr = torch.sum(jtr * vsel[:, None, None, :], dim=3)
    zv_te = torch.sum(jte * vsel[:, None, None, :], dim=3)
    neg = torch.where(w > 0, 0.0, -math.inf).to(dtype)
    wte = te_mask[None] * fvalid[:, te_idx]
    ok = (n_eff > d_col).to(dtype)
    return jtr, neg, zv_tr, jte, zv_te, wte, lndiff, ok


def _flash_reduce(out, wte, lndiff, ok):
    """(F,) CV log-likelihood from the (F, K, nte) per-test-row
    ``logsumexp_joint − logsumexp_marg``; NaN marks a degenerate fold."""
    out = torch.where(wte > 0, out, 0.0)
    fold_ll = torch.sum(out * wte, dim=2) + lndiff * torch.sum(wte, dim=2)
    fold_ll = torch.where(ok > 0, fold_ll, math.nan)
    return torch.sum(fold_ll, dim=1)


def _dense_pairs(jtr, neg, zv_tr, jte, zv_te):
    """(G, nte) ``logsumexp_joint − logsumexp_marg`` by dense test chunks:
    the pair distances of a chunk are ONE batched matmul,
    ``‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b``, as in the JAX package's XLA path.
    Full-precision matmul (TF32 off, runtime/device.py)."""
    G, ntr, _ = jtr.shape
    nte = jte.shape[1]
    chunk = max(1, _DENSE_BLOCK // max(G * ntr, 1))
    jn = torch.sum(jtr * jtr, dim=2)                           # (G, ntr)
    out = torch.empty((G, nte), dtype=jtr.dtype, device=jtr.device)
    for s in range(0, nte, chunk):
        jc = jte[:, s: s + chunk]
        zc = zv_te[:, s: s + chunk]
        jd2 = (
            torch.sum(jc * jc, dim=2)[:, :, None]
            - 2.0 * (jc @ jtr.mT)
            + jn[:, None, :]
        )
        lj = torch.logsumexp(-0.5 * jd2 + neg[:, None, :], dim=2)
        vdiff = zc[:, :, None] - zv_tr[:, None, :]
        md2 = jd2 - vdiff * vdiff
        lm = torch.logsumexp(-0.5 * md2 + neg[:, None, :], dim=2)
        out[:, s: s + chunk] = lj - lm
    return out


def ckde_cv_alldevice(data, null_mask, col_idx, col_mask, tr_idx, tr_mask,
                      te_idx, te_mask, rule="nr"):
    """CV log-likelihood of F CKDE families, all folds, in plain torch:
    :func:`ckde_cv_whitened_parts`, then the dense pairwise double
    logsumexp, then the fold sums. The route for every batch that is not
    float32 on a GPU (float64, or CPU tensors) and the reference the
    kernel route is checked against.

    Same arguments as :func:`ckde_cv_whitened_parts`. Returns (F,) summed CV
    test logl; NaN marks degenerate families (the caller maps them to
    -inf)."""
    jtr, neg, zv_tr, jte, zv_te, wte, lndiff, ok = ckde_cv_whitened_parts(
        data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask,
        rule=rule,
    )
    F, K, ntr, djmax = jtr.shape
    nte = jte.shape[2]
    out = _dense_pairs(
        jtr.reshape(F * K, ntr, djmax), neg.reshape(F * K, ntr),
        zv_tr.reshape(F * K, ntr), jte.reshape(F * K, nte, djmax),
        zv_te.reshape(F * K, nte),
    ).reshape(F, K, nte)
    return _flash_reduce(out, wte, lndiff, ok)


def ckde_cv_alldevice_flash(data, null_mask, col_idx, col_mask, tr_idx,
                            tr_mask, te_idx, te_mask, rule="nr"):
    """:func:`ckde_cv_alldevice` with the pairwise double logsumexp in the
    streaming kernel of :func:`ckde_cv_pairs` — no (nte × ntr) intermediate
    in device memory. Same arguments and result; float32 inputs. The F
    families go to the kernel as they are, without padding: the kernel
    masks its own ragged edges."""
    jtr, neg, zv_tr, jte, zv_te, wte, lndiff, ok = ckde_cv_whitened_parts(
        data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask,
        rule=rule,
    )
    out = ckde_cv_pairs(
        *ckde_cv_pair_args(jtr, neg, zv_tr, jte, zv_te, col_mask)
    ).reshape(wte.shape)
    return _flash_reduce(out, wte, lndiff, ok)


def ckde_cv_pair_args(jtr, neg, zv_tr, jte, zv_te, col_mask):
    """The arguments of :func:`ckde_cv_pairs` for the first five (F, K)
    parts of :func:`ckde_cv_whitened_parts`: the (family, fold) pairs
    flattened to G = F·K programs, float32 and contiguous. Evidence-free
    families are flagged (``no_ev``): their marginal logsumexp is exactly
    ``lm_const`` = log n_eff, so the kernel skips the whole marginal
    pass."""
    F, K, ntr, dpad = jtr.shape
    nte = jte.shape[2]
    no_ev = (torch.sum(col_mask, dim=1) <= 1.0)[:, None].expand(F, K)
    n_eff = torch.sum((neg == 0.0).to(torch.float32), dim=2)   # (F, K)
    lm_const = torch.log(torch.clamp(n_eff, min=1.0))

    def flat(t, *shape):
        return t.reshape(F * K, *shape).to(torch.float32).contiguous()

    return (flat(jtr, ntr, dpad), flat(neg, ntr), flat(zv_tr, ntr),
            flat(jte, nte, dpad), flat(zv_te, nte), flat(no_ev),
            flat(lm_const))


def flash_cv_selfcheck(rule: str = "nr", atol: float = 5e-2,
                       rtol: float = 1e-4, device=None):
    """Parity check of the kernel route: run :func:`ckde_cv_alldevice_flash`
    and :func:`ckde_cv_alldevice` on the same small synthetic batch on
    ``device`` and compare. Returns ``(ok, max_abs_diff)``; raises whatever
    the kernel route raises if it cannot run at all.

    The tolerance is on SUMMED fold log-likelihoods over 256 test points
    (values O(1e3)), so atol=5e-2 is ~1e-5 relative — far tighter than any
    wrong kernel would pass, loose enough for f32 accumulation-order
    differences between the two implementations."""
    from ..runtime.device import default_device

    device = torch.device(device) if device is not None else default_device()
    rng = np.random.default_rng(0)
    n, D = 512, 3

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    data = t(rng.normal(size=(n, D)).astype(np.float32))
    null_mask = t(np.zeros((n, D)))
    # family 0 is evidence-free (1-D): covers the kernel's marginal-skip
    # branch; family 1 is 3-D
    col_idx = t([[0, 0, 0], [2, 0, 1]], torch.long)
    col_mask = t([[1, 0, 0], [1, 1, 1]])
    K, ntr, nte = 2, 256, 256
    tr_idx = t(np.stack([np.arange(ntr), np.arange(n - ntr, n)]), torch.long)
    tr_mask = t(np.ones((K, ntr)))
    te_idx = t(np.stack([np.arange(n - nte, n), np.arange(nte)]), torch.long)
    te_mask = t(np.ones((K, nte)))
    args = (data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx,
            te_mask)
    flash = ckde_cv_alldevice_flash(*args, rule=rule).double().cpu().numpy()
    dense = ckde_cv_alldevice(*args, rule=rule).double().cpu().numpy()
    diff = float(np.max(np.abs(flash - dense)))
    ok = bool(
        np.all(np.isfinite(flash))
        and np.allclose(flash, dense, atol=atol, rtol=rtol)
    )
    return ok, diff
