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

import numpy as np

from ..data import DataFrame
from ..kde.bandwidth import BandwidthSelector, NormalReferenceRule
from ..kde.kde import KDE
from ..runtime.device import host_to_device
from .base import Factor, FactorType

__all__ = ["CKDEType", "CKDE", "batched_ckde_logl_many"]

_LOG_2PI = math.log(2 * math.pi)


class CKDEType(FactorType):
    def new_factor(self, model, variable, evidence, *args, **kwargs):
        """CKDE over continuous evidence. Discrete evidence dispatches to
        HCKDE in the reference (CKDE.cpp:15-33); ``factors/hybrid.py`` is
        not ported yet (ROADMAP.md Queue 1 item 1)."""
        if model is not None:
            from .discrete import DiscreteFactorType

            if any(model.node_type(e) == DiscreteFactorType()
                   for e in evidence):
                raise NotImplementedError(
                    "HCKDE (CKDE with discrete evidence) is not ported to "
                    "torch yet (ROADMAP.md Queue 1 item 1: factors/hybrid.py)"
                )
        return CKDE(variable, evidence, *args, **kwargs)

    def ToString(self) -> str:
        return "CKDEFactor"


def batched_ckde_logl_many(entries):
    """Per-row logl of many fitted CKDE factors in ONE device launch.

    entries: list of ``(ckde, test_mat)`` where ``test_mat`` is an (m_i, dj)
    float64 matrix in the factor's ``[variable, *evidence]`` column order
    with nulls already zeroed (the caller handles NaN scatter). Returns a
    list of (m_i,) float64 arrays.

    Uses the shared-Cholesky layout: columns are permuted evidence-first so
    the joint Cholesky's leading block is the marginal's (the reference's
    device-buffer sharing, CKDE.hpp:182-200), letting
    :func:`pybnesian_tpu_torch.ops.kde.batched_ckde_logl` compute both
    log-densities from one pass over the pairs. Factors with fewer train or
    test rows than the largest are padded, their padding train rows masked;
    the device arrays take the factors' data dtype.
    """
    from scipy.linalg import solve_triangular

    from ..ops.kde import batched_ckde_logl

    F = len(entries)
    ntr = max(e[0].num_instances() for e in entries)
    m = max(len(e[1]) for e in entries)
    djmax = max(1 + len(e[0].evidence()) for e in entries)
    dtype = np.result_type(*(e[0].kde_joint()._dtype for e in entries))
    jtr = np.zeros((F, ntr, djmax))
    jte = np.zeros((F, m, djmax))
    trm = np.zeros((F, ntr))
    lndiff = np.zeros(F)
    for f, (cpd, mat) in enumerate(entries):
        joint = cpd.kde_joint()
        dj = 1 + len(cpd.evidence())
        n_i = joint.num_instances()
        perm = list(range(1, dj)) + [0]  # fitted layout is [var, *ev]
        Hp = joint.bandwidth[np.ix_(perm, perm)]
        Lp = np.linalg.cholesky(Hp)
        jtr[f, :n_i, :dj] = solve_triangular(
            Lp, joint._training[:, perm].T, lower=True
        ).T
        trm[f, :n_i] = 1.0
        lndiff[f] = -math.log(Lp[dj - 1, dj - 1]) - 0.5 * _LOG_2PI
        jte[f, : len(mat), :dj] = solve_triangular(
            Lp, mat[:, perm].T, lower=True
        ).T
    var_col = np.array([len(e[0].evidence()) for e in entries])
    rows = np.arange(F)
    zv_tr = jtr[rows, :, var_col]
    zv_te = jte[rows, :, var_col]
    no_ev = (var_col == 0).astype(np.float64)

    def dev(a):
        return host_to_device(a, dtype)

    out = batched_ckde_logl(
        dev(jtr), dev(jte), dev(zv_tr), dev(zv_te), dev(trm), dev(lndiff),
        no_ev=dev(no_ev),
    ).cpu().numpy().astype(np.float64)
    return [out[f, : len(entries[f][1])] for f in range(F)]


class CKDE(Factor):
    def __init__(self, variable, evidence=(), bandwidth_selector: BandwidthSelector | None = None):
        super().__init__(variable, evidence)
        self._bselector = bandwidth_selector or NormalReferenceRule()
        self._joint: KDE | None = None
        self._marg: KDE | None = None
        self._fitted = False

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
        self._fitted = True

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
        ).cpu().numpy().astype(np.float64)
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
