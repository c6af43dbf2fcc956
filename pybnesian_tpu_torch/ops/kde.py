"""Kernel density estimation (KDE) on torch tensors: fitted-model
log-likelihoods and cross-validated conditional-KDE (CKDE) scores.

Port of ``pybnesian_tpu/ops/kde.py``. The fitted-model functions
(:func:`kde_logl_whitened`, :func:`kde_conditional_logsumexp`,
:func:`batched_ckde_logl`, :func:`kde_logl_pair`) take whitened train and
test rows. A float32 batch on a GPU goes to a hand-written kernel: the KDE
kernel of :func:`kde_logl` for the first two, the CV pairs kernel of
:func:`ckde_cv_pairs` for the batched one. Every other batch (float64, or
CPU tensors) takes the plain torch port of the JAX function, whose pair
distances are one matmul per test chunk. The JAX functions padded test
rows to a multiple of their chunk; the kernels mask their own ragged edges
and the plain forms chunk internally, so no caller pads.

One CV call scores F CKDE families over K folds:

1. :func:`ckde_cv_whitened_parts` — per (family, fold) row gather,
   bandwidth (the normal reference or Scott rule, or matrices the caller
   gives: UCV's, a user selector's), Cholesky and whitening;
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

:func:`ucv_pair_sums_batch` holds the pair sums of the UCV bandwidth
objective: on a GPU in float32 the hand-written kernel of
:func:`~.ucv_kernel.ucv_pair_sums_cuda` (the JAX package leaves this
function to XLA), elsewhere its plain torch version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ckde_cv_kernel import ckde_cv_pairs
from .kde_kernel import kde_logl
from .linalg import cholesky_or_nan
from .ucv_kernel import ucv_pair_sums_cuda, ucv_pair_sums_reference

__all__ = [
    "kernel_route",
    "kde_logl_whitened",
    "kde_logl_pair",
    "kde_conditional_logsumexp",
    "batched_ckde_logl",
    "ckde_cv_whitened_parts",
    "ckde_cv_alldevice",
    "ckde_cv_alldevice_flash",
    "ckde_cv_pair_args",
    "flash_cv_selfcheck",
    "ucv_pair_sums",
    "ucv_pair_sums_batch",
]

LOG_2PI = math.log(2.0 * math.pi)

# elements of one (programs, test chunk, train rows) pair block in the
# dense path: 2**24 keeps each of its few live temporaries at 64 MiB in
# float32 and 128 MiB in float64
_DENSE_BLOCK = 1 << 24


def kernel_route(t) -> bool:
    """The port's routing rule: a float32 tensor on a GPU goes to the
    hand-written kernels, every other tensor to the plain torch forms —
    by dtype and device, never because a kernel failed."""
    return t.is_cuda and t.dtype == torch.float32


def _dense_lse(train, test):
    """(M,) ``logsumexp_j −½‖test_i − train_j‖²`` by test chunks, each
    chunk's distances one matmul (``‖a‖² + ‖b‖² − 2a·b``), as the JAX
    package's XLA path forms them."""
    N = train.shape[0]
    chunk = max(1, _DENSE_BLOCK // max(N, 1))
    tn = torch.sum(train * train, dim=1)
    out = torch.empty(test.shape[0], dtype=train.dtype, device=train.device)
    for s in range(0, test.shape[0], chunk):
        tc = test[s: s + chunk]
        d2 = (torch.sum(tc * tc, dim=1)[:, None] - 2.0 * (tc @ train.T)
              + tn[None, :])
        out[s: s + chunk] = torch.logsumexp(-0.5 * d2, dim=1)
    return out


def kde_logl_whitened(train_white, test_white, lognorm):
    """Per-test-point KDE log-likelihood.

    train_white: (N, d) training points already multiplied by L⁻¹
    (bandwidth Cholesky); test_white: (M, d), any M; lognorm: scalar
    −Σ log diag(L) − d/2·log 2π − log N (reference kde/KDE.hpp:451-478).
    Returns (M,) log p(test) in the inputs' dtype."""
    if kernel_route(train_white):
        N = train_white.shape[0]
        out = kde_logl(
            train_white[None].contiguous(),
            torch.ones((1, N), dtype=torch.float32, device=train_white.device),
            test_white[None].contiguous(),
            torch.tensor([float(lognorm)], dtype=torch.float32,
                         device=train_white.device),
        )
        return out[0]
    return _dense_lse(train_white, test_white) + lognorm


def kde_logl_pair(train_white, test_white, lognorm):
    """Full (M, N) matrix of per-kernel log-densities (before logsumexp):
    ``logK[i, j] = −½‖test_i − train_j‖² + lognorm``. Used by CKDE
    sampling weights and cdf (reference CKDE.hpp:289-470). Plain torch on
    every device (the JAX package leaves it to XLA too); distances by
    direct per-column differences."""
    d2 = torch.zeros((test_white.shape[0], train_white.shape[0]),
                     dtype=train_white.dtype, device=train_white.device)
    for k in range(train_white.shape[1]):
        diff = test_white[:, k, None] - train_white[None, :, k]
        d2 += diff * diff
    return -0.5 * d2 + lognorm


def kde_conditional_logsumexp(joint_train_white, joint_test_white,
                              marg_train_white, marg_test_white,
                              joint_lognorm, marg_lognorm):
    """CKDE logl = (logsumexp_joint + joint_lognorm) − (logsumexp_marginal
    + marg_lognorm) per test row (reference CKDE.hpp:202-254). Shapes:
    joint (N, d+e)/(M, d+e), marginal (N, e)/(M, e), any M.

    On the kernel route both halves go in ONE launch of the KDE kernel as
    two programs, the marginal zero-padded to the joint's width."""
    if kernel_route(joint_train_white):
        dj = joint_train_white.shape[1]
        pad = dj - marg_train_white.shape[1]
        device = joint_train_white.device
        train = torch.stack([
            joint_train_white,
            torch.nn.functional.pad(marg_train_white, (0, pad)),
        ]).contiguous()
        test = torch.stack([
            joint_test_white,
            torch.nn.functional.pad(marg_test_white, (0, pad)),
        ]).contiguous()
        out = kde_logl(
            train,
            torch.ones(train.shape[:2], dtype=torch.float32, device=device),
            test,
            torch.tensor([float(joint_lognorm), float(marg_lognorm)],
                         dtype=torch.float32, device=device),
        )
        return out[0] - out[1]
    return (_dense_lse(joint_train_white, joint_test_white)
            - _dense_lse(marg_train_white, marg_test_white)
            + (joint_lognorm - marg_lognorm))


def batched_ckde_logl(jtr, jte, zv_tr, zv_te, trm, lndiff, no_ev=None):
    """Per-test-row conditional-KDE log-likelihood of F factors in ONE
    launch — the model-level ``logl`` path (reference BNGeneric::logl:996
    sums factor logls one at a time).

    Shared-Cholesky layout (evidence first, variable last): jtr: (F, ntr,
    djmax) whitened joint train with padded rows masked by trm; jte: (F,
    nte, djmax); zv_tr/zv_te: (F, *) whitened variable coordinate so
    ``marg_d2 = joint_d2 − Δz_var²``; trm: (F, ntr) 1.0 on valid rows;
    lndiff: (F,) = −log L_vv − ½ log 2π. ``no_ev``: optional (F,) flags of
    evidence-free factors, whose marginal logsumexp is log n_valid (the Δz
    subtraction zeroes their marginal distances): the kernel then skips
    their marginal pass; the plain form needs no flag. Returns (F, nte).

    On the kernel route this is :func:`ckde_cv_pairs` with one program per
    factor."""
    neg = torch.where(trm > 0, 0.0, -math.inf).to(jtr.dtype)
    if kernel_route(jtr):
        F = jtr.shape[0]
        flags = (torch.zeros(F, device=jtr.device) if no_ev is None
                 else torch.as_tensor(no_ev, device=jtr.device))
        n_valid = torch.sum((trm > 0).to(torch.float32), dim=1)
        out = ckde_cv_pairs(
            jtr.contiguous(), neg.contiguous(), zv_tr.contiguous(),
            jte.contiguous(), zv_te.contiguous(),
            flags.to(torch.float32).contiguous(),
            torch.log(torch.clamp(n_valid, min=1.0)),
        )
        return out + lndiff[:, None]
    return _dense_pairs(jtr, neg, zv_tr, jte, zv_te) + lndiff[:, None]


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
    d_col = d_eff[:, None]
    if bandwidths is not None:
        H = bandwidths * (col_mask[:, :, None] * col_mask[:, None, :])[:, None]
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
                      te_idx, te_mask, rule="nr", bandwidths=None):
    """CV log-likelihood of F CKDE families, all folds, in plain torch:
    :func:`ckde_cv_whitened_parts`, then the dense pairwise double
    logsumexp, then the fold sums. The route for every batch that is not
    float32 on a GPU (float64, or CPU tensors) and the reference the
    kernel route is checked against.

    Same arguments as :func:`ckde_cv_whitened_parts` (``bandwidths``
    included). Returns (F,) summed CV test logl; NaN marks degenerate
    families (the caller maps them to -inf)."""
    jtr, neg, zv_tr, jte, zv_te, wte, lndiff, ok = ckde_cv_whitened_parts(
        data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask,
        rule=rule, bandwidths=bandwidths,
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
                            tr_mask, te_idx, te_mask, rule="nr",
                            bandwidths=None):
    """:func:`ckde_cv_alldevice` with the pairwise double logsumexp in the
    streaming kernel of :func:`ckde_cv_pairs` — no (nte × ntr) intermediate
    in device memory. Same arguments and result; float32 inputs. The F
    families go to the kernel as they are, without padding: the kernel
    masks its own ragged edges."""
    jtr, neg, zv_tr, jte, zv_te, wte, lndiff, ok = ckde_cv_whitened_parts(
        data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask,
        rule=rule, bandwidths=bandwidths,
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
    from ..runtime.device import resolve_device

    device = resolve_device(device)
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


def ucv_pair_sums_batch(white, valid=None):
    """The UCV pair sums of B problems at once: ``white`` (B, N, d) whitened
    training rows, ``valid`` (B, N) 1.0 on the rows that count (a problem
    with fewer rows than N is padded with invalid ones), or None when every
    row counts. Returns ``(s2h, sh)``, each (B,) in ``white``'s dtype:

        s2h = Σ_{i<j} exp(−¼‖wᵢ−wⱼ‖²),   sh = Σ_{i<j} exp(−½‖wᵢ−wⱼ‖²)

    over the valid pairs of each problem (reference kde/UCV.cpp,
    KDE.cl.src:471-565), from one exp per pair.

    Routed by :func:`kernel_route`, as kernels #1 and #2 are: a float32
    batch on a GPU goes to the hand-written kernel
    (:func:`~.ucv_kernel.ucv_pair_sums_cuda`; ``white`` made contiguous,
    ``valid`` float32), whose sums of one problem are the same bits alone
    and in any batch; every other batch (float64, so a float64 search, or
    CPU tensors) to the plain torch version
    (:func:`~.ucv_kernel.ucv_pair_sums_reference`)."""
    if kernel_route(white):
        if valid is not None:
            valid = valid.to(torch.float32).contiguous()
        return ucv_pair_sums_cuda(white.contiguous(), valid)
    return ucv_pair_sums_reference(white, valid)


def ucv_pair_sums(train_white, valid=None):
    """:func:`ucv_pair_sums_batch` of one problem: ``train_white`` (N, d),
    ``valid`` (N,) or None. Returns two scalar tensors."""
    s2h, sh = ucv_pair_sums_batch(
        train_white[None], None if valid is None else valid[None])
    return s2h[0], sh[0]
