"""CKDE: conditional kernel density estimation factor.

Rebuild of reference factors/continuous/CKDE.{hpp,cpp} (992 LoC):
``logl = logl_joint − logl_marg`` where the joint KDE covers
(variable, evidence) and the marginal KDE shares the joint's training block
and bandwidth sub-matrix (CKDE.hpp:182-254).

Sampling draws a training kernel per row with probability ∝ marginal
kernel weight at the evidence — a Gumbel-max with host numpy noise instead
of the reference's prefix-sum inverse-CDF kernels (CKDE.hpp:289-470) — then
samples the conditional Gaussian of that kernel. Host randomness and scipy
stay exactly as in the JAX package, so the same seed draws the same noise.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from ..data import DataFrame
from ..kde.bandwidth import BandwidthSelector, NormalReferenceRule
from ..kde.kde import KDE
from ..runtime.device import default_device, host_to_device, torch_dtype
from ..runtime.tracing import count, span
from .base import Factor, FactorType

__all__ = ["CKDEType", "CKDE", "batched_ckde_logl_many"]

_LOG_2PI = math.log(2 * math.pi)


class CKDEType(FactorType):
    def new_factor(self, model, variable, evidence, *args, **kwargs):
        """Dispatch to HCKDE when any evidence node is discrete
        (reference CKDE.cpp:15-33)."""
        if model is not None:
            from .discrete import DiscreteFactorType

            for e in evidence:
                if model.node_type(e) == DiscreteFactorType():
                    from .hybrid import HCKDE

                    return HCKDE(variable, evidence, *args, **kwargs)
        return CKDE(variable, evidence, *args, **kwargs)

    def ToString(self) -> str:
        return "CKDEFactor"


class _TrainPlan:
    """The training side of one fitted CKDE in the batched logl's layout
    (columns permuted evidence first, variable last), built once a fit by
    :meth:`CKDE._train_plan` with the host float64 operations the batched
    path always used: ``perm`` and ``Lp``, the Cholesky factor of the
    permuted bandwidth, which whiten the test rows; ``jtr`` (n, dj) and
    ``zv_tr`` (n,), the whitened training rows and their variable
    coordinate, cast to ``dtype`` on ``device``; ``lndiff`` = −log L_vv −
    ½ log 2π. It is bound to the joint KDE and the bandwidth and training
    arrays it was built from."""

    def __init__(self, joint: KDE, dtype, device):
        from scipy.linalg import solve_triangular

        dj = joint.num_variables()
        self.source = (joint, joint._bandwidth, joint._training)
        self.key = (np.dtype(dtype), device)
        self.dj = dj
        self.perm = [*range(1, dj), 0]  # fitted layout is [var, *ev]
        self.Lp = np.linalg.cholesky(
            joint.bandwidth[np.ix_(self.perm, self.perm)])
        self.lndiff = -math.log(self.Lp[dj - 1, dj - 1]) - 0.5 * _LOG_2PI
        white = solve_triangular(
            self.Lp, joint._training[:, self.perm].T, lower=True).T
        self.jtr = host_to_device(white, dtype, device)
        self.zv_tr = host_to_device(white[:, dj - 1], dtype, device)

    def serves(self, joint: KDE, dtype, device) -> bool:
        src = self.source
        return (src[0] is joint and src[1] is joint._bandwidth
                and src[2] is joint._training
                and self.key == (np.dtype(dtype), device))

    def whiten(self, mat: np.ndarray) -> np.ndarray:
        """Rows of ``mat`` (columns ``[variable, *evidence]``), whitened in
        the permuted layout, in float64."""
        from scipy.linalg import solve_triangular

        return solve_triangular(self.Lp, mat[:, self.perm].T, lower=True).T


# The stacked train side of the last tuple of factor plans seen: (weak
# references to the plans, the stacked tensors). It goes when one of its
# plans is collected (its factor refitted or collected, or another dtype or
# device asked for), so that it never holds device memory for a dead model.
_LAST = None


def _stack_plans(plans, dtype, device):
    """The F plans as :func:`~..ops.kde.batched_ckde_logl_prepared`'s train
    side, by device copies: ``jtr`` (F, ntr, djmax) and ``zv_tr`` (F, ntr)
    zero-padded, ``neg``, the no-evidence flags and ``log n_valid`` from
    the padding mask, and ``lndiff`` (F,)."""
    from ..ops.kde import ckde_train_side

    F = len(plans)
    ntr = max(p.jtr.shape[0] for p in plans)
    djmax = max(p.dj for p in plans)
    jtr = torch.zeros((F, ntr, djmax), dtype=torch_dtype(dtype), device=device)
    zv_tr = torch.zeros((F, ntr), dtype=jtr.dtype, device=device)
    trm = torch.zeros((F, ntr), dtype=jtr.dtype, device=device)
    for f, p in enumerate(plans):
        n = p.jtr.shape[0]
        jtr[f, :n, :p.dj] = p.jtr
        zv_tr[f, :n] = p.zv_tr
        trm[f, :n] = 1.0
    no_ev = np.array([p.dj == 1 for p in plans], dtype=np.float64)
    lndiff = np.array([p.lndiff for p in plans])
    neg, flags, log_n_valid = ckde_train_side(
        jtr, trm, host_to_device(no_ev, dtype, device))
    return (jtr, neg, zv_tr, flags, log_n_valid,
            host_to_device(lndiff, dtype, device))


def _stacked(plans, dtype, device):
    """The stacked train side of ``plans``: the kept one when the last call
    stacked the same plans, else a new one (counted in
    ``slogl.ckde.plan_reuses`` and ``slogl.ckde.plan_builds``)."""
    global _LAST
    last = _LAST
    if (last is not None and len(last[0]) == len(plans)
            and all(r() is p for r, p in zip(last[0], plans))):
        count("slogl.ckde.plan_reuses")
        return last[1]
    count("slogl.ckde.plan_builds")

    def forget(ref):
        global _LAST
        if _LAST is not None and any(r is ref for r in _LAST[0]):
            _LAST = None

    _LAST = ([weakref.ref(p, forget) for p in plans],
             _stack_plans(plans, dtype, device))
    return _LAST[1]


def batched_ckde_logl_many(entries):
    """Per-row logl of many fitted CKDE factors in ONE device launch.

    entries: list of ``(ckde, test_mat)`` where ``test_mat`` is an (m_i, dj)
    float64 matrix in the factor's ``[variable, *evidence]`` column order
    with nulls already zeroed (the caller handles NaN scatter). Returns a
    list of (m_i,) float64 arrays.

    Uses the shared-Cholesky layout: columns are permuted evidence-first so
    the joint Cholesky's leading block is the marginal's (the reference's
    device-buffer sharing, CKDE.hpp:182-200), letting
    :func:`pybnesian_tpu_torch.ops.kde.batched_ckde_logl_prepared` compute
    both log-densities from one pass over the pairs. Factors with fewer
    train or test rows than the largest are padded, their padding train
    rows masked; the device arrays take the factors' data dtype.

    Everything but the test rows is fixed by the fits: each factor keeps
    its whitened training rows on the device (:meth:`CKDE._train_plan`),
    and their stacked, padded form is kept for the tuple of factors. A
    call whitens its test rows on the host, uploads them and launches."""
    from ..ops.kde import batched_ckde_logl_prepared

    F = len(entries)
    m = max(len(e[1]) for e in entries)
    dtype = np.result_type(*(e[0].kde_joint()._dtype for e in entries))
    device = default_device()
    with span("pb.slogl.ckde.whiten"):
        plans = [cpd._train_plan(dtype, device) for cpd, _ in entries]
        train = _stacked(plans, dtype, device)
        jte = np.zeros((F, m, max(p.dj for p in plans)))
        for f, ((_, mat), plan) in enumerate(zip(entries, plans)):
            jte[f, : len(mat), : plan.dj] = plan.whiten(mat)
    var_col = np.array([p.dj - 1 for p in plans])
    zv_te = jte[np.arange(F), :, var_col]

    with span("pb.slogl.ckde.launch"):
        out = batched_ckde_logl_prepared(
            *train, host_to_device(jte, dtype, device),
            host_to_device(zv_te, dtype, device))
    with span("pb.slogl.wait"):
        out = out.cpu().numpy().astype(np.float64)
    return [out[f, : len(entries[f][1])] for f in range(F)]


class CKDE(Factor):
    def __init__(self, variable, evidence=(), bandwidth_selector: BandwidthSelector | None = None):
        super().__init__(variable, evidence)
        self._bselector = bandwidth_selector or NormalReferenceRule()
        self._joint: KDE | None = None
        self._marg: KDE | None = None
        self._fitted = False
        self._plan: _TrainPlan | None = None

    def type(self) -> FactorType:
        return CKDEType()

    def fitted(self) -> bool:
        return self._fitted

    def data_type(self):
        if not self._fitted:
            raise ValueError("CKDE factor not fitted.")
        return self._joint.data_type()

    def kde_joint(self) -> KDE:
        self._check_fitted()
        return self._joint

    def kde_marg(self) -> KDE:
        self._check_fitted()
        return self._marg

    def num_instances(self) -> int:
        self._check_fitted()
        return self._joint.num_instances()

    def bandwidth_selector(self) -> BandwidthSelector:
        return self._bselector

    def _check_fitted(self):
        if not self._fitted:
            raise ValueError(
                f"Factor P({self._variable} | {self._evidence}) not fitted."
            )

    # ------------------------------------------------------------------ fit
    def fit(self, df) -> None:
        df = DataFrame.wrap(df)
        joint = KDE([self._variable, *self._evidence], self._bselector)
        joint.fit(df)
        self._set_joint(joint)

    def _set_joint(self, joint: KDE) -> None:
        """Take a fitted joint KDE over ``[variable, *evidence]`` and derive
        the marginal from it: the marginal shares the joint's training block
        and bandwidth sub-matrix (reference CKDE.hpp:182-200)."""
        self._joint = joint
        if self._evidence:
            self._marg = KDE(list(self._evidence), self._bselector)
            self._marg._dtype = joint._dtype
            self._marg.fit_with_bandwidth(
                joint._training[:, 1:], joint.bandwidth[1:, 1:]
            )
        else:
            self._marg = None
        self._plan = None
        self._fitted = True

    def _train_plan(self, dtype, device) -> _TrainPlan:
        """This factor's training side for :func:`batched_ckde_logl_many`
        in ``dtype`` on ``device``: kept from the last call, and built anew
        after a refit, a change of the joint's bandwidth or training rows,
        or another dtype or device."""
        plan = self._plan
        if plan is None or not plan.serves(self._joint, dtype, device):
            plan = self._plan = _TrainPlan(self._joint, dtype, device)
        return plan

    # ----------------------------------------------------------------- logl
    def logl(self, df) -> np.ndarray:
        self._check_fitted()
        df = DataFrame.wrap(df)
        if not self._evidence:
            return self._joint.logl(df)
        from ..ops.kde import kde_conditional_logsumexp

        variables = [self._variable, *self._evidence]
        self._joint._check_test_dtype(df)
        mat = df.to_numpy(variables, drop_null=False, dtype=np.float64)
        valid = df.combined_mask(*variables)
        mat = np.nan_to_num(mat, nan=0.0)
        joint_test = self._joint._to_device(self._joint._whiten(mat))
        marg_test = self._marg._to_device(self._marg._whiten(mat[:, 1:]))
        out = kde_conditional_logsumexp(
            self._joint.whitened_training(),
            joint_test,
            self._marg.whitened_training(),
            marg_test,
            float(self._joint._lognorm),
            float(self._marg._lognorm),
        )
        with span("pb.factor.wait"):
            out = out.cpu().numpy().astype(np.float64)
        out[~valid] = np.nan
        return out

    def slogl(self, df) -> float:
        return float(np.nansum(self.logl(df)))

    # ------------------------------------------------------------ cond gauss
    def _conditional_coefs(self):
        """Regression of variable on evidence within one kernel:
        mean_i(e) = x_i0 + Hve·Hee⁻¹·(e − x_i,1:), var = Hvv − Hve·Hee⁻¹·Hev."""
        H = self._joint.bandwidth
        Hvv = H[0, 0]
        Hve = H[0, 1:]
        Hee = H[1:, 1:]
        reg = np.linalg.solve(Hee, Hve)
        cond_var = float(Hvv - Hve @ reg)
        return reg, cond_var

    def _kernel_weights_logits(self, evidence_mat: np.ndarray) -> np.ndarray:
        """(M, N) marginal log-kernel weights at the evidence rows."""
        from ..ops.kde import kde_logl_pair

        test = self._marg._to_device(self._marg._whiten(evidence_mat))
        logits = kde_logl_pair(self._marg.whitened_training(), test, 0.0)
        return logits.cpu().numpy().astype(np.float64)

    # --------------------------------------------------------------- sample
    def sample(self, n: int, evidence_values=None, seed: int | None = None):
        self._check_fitted()
        rng = np.random.default_rng(seed)
        train = self._joint._training
        if not self._evidence:
            idx = rng.integers(0, len(train), n)
            h = math.sqrt(self._joint.bandwidth[0, 0])
            return self._as_pa(train[idx, 0] + rng.normal(0.0, h, n))
        ev = DataFrame.wrap(evidence_values)
        mat = ev.to_numpy(self._evidence, drop_null=False, dtype=np.float64)
        if len(mat) != n:
            raise ValueError("evidence_values rows != n")
        logits = self._kernel_weights_logits(np.nan_to_num(mat, nan=0.0))
        # Gumbel-max categorical per row (equivalent in law to the
        # reference's inverse-CDF selection)
        g = rng.gumbel(size=logits.shape)
        idx = np.argmax(logits + g, axis=1)
        reg, cond_var = self._conditional_coefs()
        mean = train[idx, 0] + (mat - train[idx, 1:]) @ reg
        return self._as_pa(mean + rng.normal(0.0, math.sqrt(cond_var), n))

    def _as_pa(self, values: np.ndarray):
        """Samples are Arrow arrays in the training dtype (reference
        CKDE.hpp:289-384 returns arrow arrays)."""
        from ..data.arrow_interop import pa

        return pa.array(values.astype(self._joint._dtype))

    # ------------------------------------------------------------------ cdf
    def cdf(self, df) -> np.ndarray:
        """Σ_i w_i(e) Φ((x − μ_i(e)) / σ) (reference CKDE.hpp:164-168)."""
        self._check_fitted()
        from scipy.special import log_ndtr, logsumexp

        df = DataFrame.wrap(df)
        variables = [self._variable, *self._evidence]
        mat = df.to_numpy(variables, drop_null=False, dtype=np.float64)
        valid = df.combined_mask(*variables)
        train = self._joint._training
        x = mat[:, 0]
        if self._evidence:
            emat = np.nan_to_num(mat[:, 1:], nan=0.0)
            logits = self._kernel_weights_logits(emat)
            logw = logits - logsumexp(logits, axis=1, keepdims=True)
            reg, cond_var = self._conditional_coefs()
            # mean_ij = x_i0 + (e_j - x_i,1:)·reg  → shape (M, N)
            mean = train[None, :, 0] + np.einsum(
                "me,e->m", emat, reg
            )[:, None] - (train[None, :, 1:] @ reg)
            sd = math.sqrt(cond_var)
            z = (x[:, None] - mean) / sd
            out = np.exp(logsumexp(logw + log_ndtr(z), axis=1))
        else:
            h = math.sqrt(self._joint.bandwidth[0, 0])
            z = (x[:, None] - train[None, :, 0]) / h
            out = np.exp(
                logsumexp(log_ndtr(z), axis=1) - math.log(len(train))
            )
        out[~valid] = np.nan
        return out

    # ---------------------------------------------------------------- string
    def ToString(self) -> str:
        v = self._variable
        if self._evidence:
            ev = ", ".join(self._evidence)
            suffix = "" if self._fitted else " not fitted"
            return f"[CKDE] P({v} | {ev}) = CKDE{suffix}"
        suffix = "" if self._fitted else " not fitted"
        return f"[CKDE] P({v}) = CKDE{suffix}"

    # --------------------------------------------------------------- pickle
    def __getstate__(self):
        return {
            "variable": self._variable,
            "evidence": self._evidence,
            "bselector": self._bselector,
            "fitted": self._fitted,
            "joint": self._joint,
            "marg": self._marg,
        }

    def __setstate__(self, state):
        Factor.__init__(self, state["variable"], state["evidence"])
        self._bselector = state["bselector"]
        self._fitted = state["fitted"]
        self._joint = state["joint"]
        self._marg = state["marg"]
        self._plan = None
