"""Cross-validated likelihood score: CVLikelihood.

Rebuild of reference learning/scores/cv_likelihood.{hpp,cpp}, ported from
``pybnesian_tpu/learning/scores/likelihood.py``. Instead of the reference's
serial per-(family, fold) factor fit+slogl, the linear-Gaussian path
evaluates all families × folds in one batched call
(:func:`pybnesian_tpu_torch.ops.gaussian.batched_lg_cv_loglik`) and the CKDE
path scores all families × folds of a bandwidth rule in one fused call
(:mod:`pybnesian_tpu_torch.ops.kde`). Discrete and Python-defined factor
types keep the host paths.

Routing of a CKDE batch (the JAX package's rule, likelihood.py:81-84): a
float32 batch on a GPU goes through the hand-written kernel; every other
batch through the plain torch :func:`ckde_cv_alldevice`. There is no
parity gate with a silent fall-back: on a GPU the kernel runs or the call
raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...data import CrossValidation, DataFrame
from ...factors.base import Arguments
from ...factors.discrete import DiscreteFactorType
from ...factors.lineargaussian import LinearGaussianCPDType
from ...runtime.device import default_device, torch_dtype
from ...utils.exceptions import SingularCovarianceData
from .base import Score

__all__ = ["CVLikelihood"]


def _fused_cv_scores(data, null_mask, col_idx, col_mask, tr_idx, tr_mask,
                     te_idx, te_mask, rule):
    """(F,) CV scores of one rule group: the kernel route for a float32
    batch on a GPU, the plain torch route otherwise."""
    from ...ops.kde import (
        ckde_cv_alldevice, ckde_cv_alldevice_flash, kernel_route)

    fused = (ckde_cv_alldevice_flash if kernel_route(data)
             else ckde_cv_alldevice)
    return fused(data, null_mask, col_idx, col_mask, tr_idx, tr_mask,
                 te_idx, te_mask, rule=rule)


def _family_columns(fams, pos):
    """(col_idx, col_mask) of (variable, parents) families in the kernel
    layout: evidence first, variable last, so that joint and marginal share
    the Cholesky leading block; as wide as the widest family."""
    djmax = max(len(ps) + 1 for _, ps in fams)
    col_idx = np.zeros((len(fams), djmax), np.int64)
    col_mask = np.zeros((len(fams), djmax))
    for f, (v, ps) in enumerate(fams):
        for j, c in enumerate([*ps, v]):
            col_idx[f, j] = pos[c]
            col_mask[f, j] = 1.0
    return col_idx, col_mask


def _ckde_selector(node_type, model, variable, parents, args):
    """Instantiate the factor once to honour Arguments-configured bandwidth
    selectors (factors/arguments.hpp routing)."""
    a, kw = args.args(variable, node_type)
    factor = node_type.new_factor(model, variable, list(parents), *a, **kw)
    return factor.bandwidth_selector()


class _KFoldEngine:
    """Shared device-path CV evaluation over a fixed fold split."""

    def __init__(self, df: DataFrame,
                 folds: list[tuple[np.ndarray, np.ndarray]],
                 device: torch.device):
        self.df = df
        self.folds = folds
        self.device = device

    # ------------------------------------------------------------------ LG
    def lg_batch(self, families) -> np.ndarray:
        """families: list of (var_pos, [parent_pos]). One batched call."""
        from ...ops.gaussian import batched_lg_cv_loglik

        cols = self.df.continuous_columns()
        values, valid = self.df.device_matrix(cols, device=self.device)
        n = self.df.num_rows
        K = len(self.folds)
        if not hasattr(self, "_masks"):
            train = np.zeros((K, n))
            test = np.zeros((K, n))
            for k, (tr, te) in enumerate(self.folds):
                train[k, tr] = 1.0
                test[k, te] = 1.0
            self._masks = tuple(
                torch.as_tensor(m, dtype=values.dtype, device=self.device)
                for m in (train, test)
            )
        train_mask, test_mask = self._masks
        F = len(families)
        P = max((len(ps) for _, ps in families), default=0)
        var_idx = np.zeros(F, np.int64)
        parent_idx = np.zeros((F, P), np.int64)
        parent_mask = np.zeros((F, P))
        for f, (vi, ps) in enumerate(families):
            var_idx[f] = vi
            for j, p in enumerate(ps):
                parent_idx[f, j] = p
                parent_mask[f, j] = 1.0
        out = batched_lg_cv_loglik(
            values, valid, train_mask, test_mask,
            torch.as_tensor(var_idx, device=self.device),
            torch.as_tensor(parent_idx, device=self.device),
            torch.as_tensor(parent_mask, dtype=values.dtype,
                            device=self.device),
        )
        return out.to(torch.float64).cpu().numpy()

    # ---------------------------------------------------------------- CKDE
    def _family_arrays(self):
        """Cached full continuous matrix + per-column null masks (host)."""
        if not hasattr(self, "_fam_cache"):
            cols = self.df.continuous_columns()
            mat = self.df.to_numpy(cols, drop_null=False, dtype=np.float64)
            nulls = np.column_stack(
                [self.df.col(c).null_mask() for c in cols]
            ) if cols else np.zeros((self.df.num_rows, 0), bool)
            self._fam_cache = ({c: i for i, c in enumerate(cols)}, mat, nulls)
        return self._fam_cache

    def _device_cv_cache(self):
        """Device-resident data + fold index arrays, uploaded once. Folds
        are padded only to the longest fold (rows masked out)."""
        if not hasattr(self, "_dev_cv"):
            cols = self.df.continuous_columns()
            pos, mat, nulls = self._family_arrays()
            ntr = max(len(tr) for tr, _ in self.folds)
            nte = max(len(te) for _, te in self.folds)
            K = len(self.folds)
            tr_idx = np.zeros((K, ntr), np.int64)
            tr_mask = np.zeros((K, ntr))
            te_idx = np.zeros((K, nte), np.int64)
            te_mask = np.zeros((K, nte))
            for k, (tr, te) in enumerate(self.folds):
                tr_idx[k, : len(tr)] = tr
                tr_mask[k, : len(tr)] = 1.0
                te_idx[k, : len(te)] = te
                te_mask[k, : len(te)] = 1.0
            dt = self.df.same_type(*cols) if cols else np.float64
            dtype = torch_dtype(
                np.float32 if np.dtype(dt) == np.float32 else np.float64
            )

            def dev(a, dt=dtype):
                return torch.as_tensor(a, dtype=dt, device=self.device)

            self._dev_cv = (
                pos,
                dev(np.nan_to_num(mat, nan=0.0)),
                dev(nulls),
                dev(tr_idx, torch.long),
                dev(tr_mask),
                dev(te_idx, torch.long),
                dev(te_mask),
            )
        return self._dev_cv

    def ckde_scores_batch(self, fams) -> np.ndarray:
        """fams: list of (variable, parents, selector). Rule-based selectors
        (normal reference, Scott) run the fused device path, one call per
        rule; UCV and custom Python selectors are not ported yet."""
        from ...kde.bandwidth import NormalReferenceRule, ScottsBandwidth
        from ...kde.ucv import UCV

        out = np.empty(len(fams))
        device_groups: dict[str, list[int]] = {}
        ucv_idx: list[int] = []
        fallback: list[int] = []
        for i, (v, ps, selector) in enumerate(fams):
            if type(selector) is NormalReferenceRule:
                rule = "nr"
            elif type(selector) is ScottsBandwidth:
                rule = "scott"
            elif type(selector) is UCV:
                ucv_idx.append(i)
                continue
            else:
                fallback.append(i)
                continue
            device_groups.setdefault(rule, []).append(i)

        if ucv_idx:
            self._ckde_ucv_batch([fams[i] for i in ucv_idx])
        if fallback:
            self._ckde_host_batch([fams[i] for i in fallback])

        if device_groups:
            (pos, data, null_mask, tr_idx, tr_mask, te_idx, te_mask) = (
                self._device_cv_cache()
            )
            # dispatch every group before the first device-to-host copy
            pending = []
            for rule, idxs in device_groups.items():
                col_idx, col_mask = _family_columns(
                    [fams[i][:2] for i in idxs], pos
                )
                scores = _fused_cv_scores(
                    data, null_mask,
                    torch.as_tensor(col_idx, device=self.device),
                    torch.as_tensor(col_mask, dtype=data.dtype,
                                    device=self.device),
                    tr_idx, tr_mask, te_idx, te_mask, rule=rule,
                )
                pending.append((idxs, scores))
            for idxs, scores in pending:
                vals = scores.to(torch.float64).cpu().numpy().copy()
                vals[~np.isfinite(vals)] = -math.inf
                out[np.array(idxs)] = vals
        return out

    def _ckde_ucv_batch(self, fams) -> np.ndarray:
        raise NotImplementedError(
            "CV scores of UCV-selected CKDE families are not ported to torch "
            "yet (ROADMAP.md Queue 1 item 5: UCV bandwidth)"
        )

    def _ckde_host_batch(self, fams) -> np.ndarray:
        raise NotImplementedError(
            "CV scores of CKDE families with a custom bandwidth selector are "
            "not ported to torch yet (ROADMAP.md Queue 1 item 5: UCV and "
            "custom bandwidth selectors)"
        )

    def ckde_score(self, variable, parents, selector) -> float:
        return float(self.ckde_scores_batch([(variable, parents, selector)])[0])

    # ------------------------------------------------------------ discrete
    def discrete_score(self, variable, parents) -> float:
        """All folds in one host pass: the per-fold CPT fit is a bincount
        over the cached flat configuration index, and the per-fold slogl is
        the dot product of test-fold counts with the fold's log-CPT
        (reference cv_likelihood.cpp:11-25 fits and scores a DiscreteFactor
        per fold; same counts → same CPT → same sum)."""
        from ...factors.discrete import create_cardinality_strides, flat_indices

        parents = list(parents)
        for v in (variable, *parents):
            if not self.df.is_discrete(v):
                raise ValueError(
                    "Wrong data type to fit DiscreteFactor. Column "
                    f"'{v}' is not categorical."
                )
        card, strides = create_cardinality_strides(self.df, variable, parents)
        C = int(np.prod(card))
        k = int(card[0])
        npc = C // k
        idx = flat_indices(self.df, [variable, *parents], strides)
        log_uniform = -math.log(k)
        total = 0.0
        for (tr, te) in self.folds:
            tr_i = idx[tr]
            tr_i = tr_i[tr_i >= 0]
            counts_tr = np.bincount(tr_i, minlength=C).reshape(npc, k)
            totals = counts_tr.sum(axis=1, keepdims=True)
            with np.errstate(divide="ignore", invalid="ignore"):
                logp = np.log(counts_tr) - np.log(totals)
            logp[totals[:, 0] == 0, :] = log_uniform
            te_i = idx[te]
            te_i = te_i[te_i >= 0]
            counts_te = np.bincount(te_i, minlength=C).reshape(npc, k)
            seen = counts_te > 0
            total += float(np.sum(counts_te[seen] * logp[seen]))
        return total

    # ------------------------------------------------------------- generic
    def generic_score(self, model, node_type, variable, parents, args) -> float:
        a, kw = args.args(variable, node_type)
        total = 0.0
        for (tr, te) in self.folds:
            factor = node_type.new_factor(model, variable, list(parents), *a, **kw)
            try:
                factor.fit(self.df.take(tr))
            except SingularCovarianceData:
                return -math.inf
            total += factor.slogl(self.df.take(te))
        return total


class CVLikelihood(Score):
    """(reference cv_likelihood.{hpp,cpp}). ``device`` holds the data and
    runs the batched scores; default :func:`default_device`."""

    def __init__(self, df, k: int = 10, seed: int = 0,
                 construction_args: Arguments | None = None, device=None):
        self.df = DataFrame.wrap(df)
        self.cv = CrossValidation(self.df, k, seed)
        self.k = k
        self.seed = seed
        self.args = construction_args or Arguments()
        self.device = (
            torch.device(device) if device is not None else default_device()
        )
        self._engine = _KFoldEngine(
            self.df, [self.cv.fold_indices(i) for i in range(k)], self.device
        )

    def data(self):
        return self.df

    def cv_folds(self):
        return self.cv

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        parents = list(parents)
        from ...factors.ckde import CKDEType

        if node_type == LinearGaussianCPDType() and self._lg_ok(variable, parents):
            pos = {c: i for i, c in enumerate(self.df.continuous_columns())}
            fams = [(pos[variable], [pos[p] for p in parents])]
            return float(self._engine.lg_batch(fams)[0])
        if node_type == CKDEType() and self._lg_ok(variable, parents):
            selector = _ckde_selector(node_type, model, variable, parents, self.args)
            return self._engine.ckde_score(variable, parents, selector)
        if node_type == DiscreteFactorType():
            return self._engine.discrete_score(variable, parents)
        return self._engine.generic_score(
            model, node_type, variable, parents, self.args
        )

    def _lg_ok(self, variable, parents) -> bool:
        return not self.df.is_discrete(variable) and not any(
            self.df.is_discrete(p) for p in parents
        )

    def local_score_batch(self, model, families) -> np.ndarray:
        """families: sequence of (variable, parents) or (variable, parents,
        node_type). Linear-Gaussian families go in one batched call, CKDE
        families in one call per bandwidth rule. Returns (F,) float64."""
        norm = []
        for fam in families:
            if len(fam) == 3:
                v, ps, nt = fam
                if nt is None:
                    nt = self._node_type(model, v)
            else:
                v, ps = fam
                nt = self._node_type(model, v)
            norm.append((v, list(ps), nt))
        out = np.empty(len(norm))
        lg_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == LinearGaussianCPDType() and self._lg_ok(v, ps)
        ]
        pos = {c: i for i, c in enumerate(self.df.continuous_columns())}
        if lg_idx:
            fams = [
                (pos[norm[i][0]], [pos[p] for p in norm[i][1]]) for i in lg_idx
            ]
            out[np.array(lg_idx)] = self._engine.lg_batch(fams)
        from ...factors.ckde import CKDEType

        ckde_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == CKDEType() and self._lg_ok(v, ps)
        ]
        if ckde_idx:
            fams = [
                (
                    norm[i][0],
                    norm[i][1],
                    _ckde_selector(norm[i][2], model, norm[i][0], norm[i][1],
                                   self.args),
                )
                for i in ckde_idx
            ]
            out[np.array(ckde_idx)] = self._engine.ckde_scores_batch(fams)
        handled = set(lg_idx) | set(ckde_idx)
        for i, (v, ps, nt) in enumerate(norm):
            if i in handled:
                continue
            out[i] = self.local_score_node_type(model, nt, v, ps)
        return out

    def ToString(self) -> str:
        return "CVLikelihood"
