"""Likelihood-based scores: CVLikelihood, HoldoutLikelihood,
ValidatedLikelihood.

Rebuild of reference learning/scores/cv_likelihood.{hpp,cpp},
holdout_likelihood.{hpp,cpp} and validated_likelihood.hpp:12-80, ported
from ``pybnesian_tpu/learning/scores/likelihood.py``. Instead of the
reference's serial per-(family, fold) factor fit+slogl, the linear-Gaussian
path evaluates all families × folds in one batched call
(:func:`pybnesian_tpu_torch.ops.gaussian.batched_lg_cv_loglik`, and
:func:`~pybnesian_tpu_torch.ops.gaussian.batched_lg_holdout_loglik` for the
holdout split) and the CKDE path scores all families × folds of a bandwidth
rule in one fused call (:mod:`pybnesian_tpu_torch.ops.kde`); the holdout
split is one more fold set, of one fold. CKDE families whose bandwidth
selector is UCV get their families × folds bandwidths from one batched
search (:func:`pybnesian_tpu_torch.kde.ucv.ucv_search_batch`), families
with a user-defined selector from the selector, fold by fold; both are then
scored by the same fused call, given those bandwidths. Discrete and
Python-defined factor types keep the host paths.

Every score holds its tensors on its ``device`` (default
:func:`~pybnesian_tpu_torch.runtime.device.default_device`); the factors it
fits on the host paths run under :func:`use_device` of that device.

Routing of a CKDE batch (the JAX package's rule, likelihood.py:81-84): a
float32 batch on a GPU goes through the hand-written kernel; every other
batch through the plain torch :func:`ckde_cv_alldevice` — whatever chose
the bandwidths. There is no
parity gate with a silent fall-back: on a GPU the kernel runs or the call
raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...data import CrossValidation, DataFrame, HoldOut
from ...factors.base import Arguments
from ...factors.discrete import DiscreteFactorType
from ...factors.lineargaussian import LinearGaussianCPDType
from ...ops.gaussian import family_tensors
from ...runtime.device import host_to_device, numpy_dtype, resolve_device, use_device
from ...utils.exceptions import SingularCovarianceData
from .base import Score, ValidatedScore

__all__ = ["CVLikelihood", "HoldoutLikelihood", "ValidatedLikelihood"]


def _fused_cv_scores(data, null_mask, col_idx, col_mask, tr_idx, tr_mask,
                     te_idx, te_mask, rule=None, bandwidths=None):
    """(F,) CV scores of one group of families, with the bandwidths of
    ``rule`` or the given per-(family, fold) ``bandwidths``: the kernel
    route for a float32 batch on a GPU, the plain torch route otherwise."""
    from ...ops.kde import (
        ckde_cv_alldevice, ckde_cv_alldevice_flash, kernel_route)

    fused = (ckde_cv_alldevice_flash if kernel_route(data)
             else ckde_cv_alldevice)
    return fused(data, null_mask, col_idx, col_mask, tr_idx, tr_mask,
                 te_idx, te_mask, rule=rule, bandwidths=bandwidths)


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


def _family_bandwidths(fams, per_family, pos):
    """``(col_idx, col_mask, H)`` of the fused scoring path for (variable,
    parents) families with host bandwidths ``per_family[f][k]``, the (dj,
    dj) matrix of family f in fold k with the variable FIRST: the columns
    of :func:`_family_columns` (evidence first, variable last), and the
    bandwidths permuted to that order in the leading block of an (F, K,
    djmax, djmax) array."""
    col_idx, col_mask = _family_columns(fams, pos)
    djmax = col_idx.shape[1]
    K = len(per_family[0])
    H = np.zeros((len(fams), K, djmax, djmax))
    for f, hs in enumerate(per_family):
        dj = len(hs[0])
        perm = [*range(1, dj), 0]
        for k in range(K):
            H[f, k, :dj, :dj] = np.asarray(hs[k])[np.ix_(perm, perm)]
    return col_idx, col_mask, H


def _finite_or_neg_inf(scores) -> np.ndarray:
    """Device scores as host float64; NaN (a degenerate family) and +inf
    become −inf."""
    vals = scores.to(torch.float64).cpu().numpy().copy()
    vals[~np.isfinite(vals)] = -math.inf
    return vals


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
    def lg_inputs(self, families):
        """:func:`~pybnesian_tpu_torch.ops.gaussian.batched_lg_cv_loglik`'s
        arguments for ``families``, a list of (var_pos, [parent_pos]): the
        continuous columns and their validity on the device, the (K, n)
        fold masks (built once) and the family tensors."""
        cols = self.df.continuous_columns()
        values, valid = self.df.device_matrix(cols, device=self.device)
        dtype = numpy_dtype(values.dtype)
        n = self.df.num_rows
        K = len(self.folds)
        if not hasattr(self, "_masks"):
            train = np.zeros((K, n))
            test = np.zeros((K, n))
            for k, (tr, te) in enumerate(self.folds):
                train[k, tr] = 1.0
                test[k, te] = 1.0
            self._masks = tuple(
                host_to_device(m, dtype, self.device) for m in (train, test)
            )
        return (values, valid, *self._masks,
                *family_tensors(families, dtype, self.device))

    def lg_batch(self, families) -> np.ndarray:
        """families: list of (var_pos, [parent_pos]). One batched call."""
        from ...ops.gaussian import batched_lg_cv_loglik

        out = batched_lg_cv_loglik(*self.lg_inputs(families))
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

    def _dtype(self):
        """float32 for a float32 frame, else float64: the dtype of every
        device tensor of the CKDE paths, the bandwidth search included."""
        cols = self.df.continuous_columns()
        dt = self.df.same_type(*cols) if cols else np.float64
        return np.float32 if np.dtype(dt) == np.float32 else np.float64

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
            dtype = self._dtype()

            def dev(a, dt=dtype):
                return host_to_device(a, dt, self.device)

            self._dev_cv = (
                pos,
                dev(np.nan_to_num(mat, nan=0.0)),
                dev(nulls),
                dev(tr_idx, np.int64),
                dev(tr_mask),
                dev(te_idx, np.int64),
                dev(te_mask),
            )
        return self._dev_cv

    def ckde_scores_batch(self, fams) -> np.ndarray:
        """fams: list of (variable, parents, selector). Rule-based selectors
        (normal reference, Scott) run the fused device path, one call per
        rule; UCV families take their bandwidths from one batched search
        and families with a custom Python selector from the selector, and
        both are then scored by the same fused path."""
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
                    host_to_device(col_idx, np.int64, self.device),
                    host_to_device(col_mask, numpy_dtype(data.dtype),
                                   self.device),
                    tr_idx, tr_mask, te_idx, te_mask, rule=rule,
                )
                pending.append((idxs, scores))
            for idxs, scores in pending:
                out[np.array(idxs)] = _finite_or_neg_inf(scores)

        if ucv_idx:
            out[np.array(ucv_idx)] = self._ckde_ucv_batch(
                [fams[i] for i in ucv_idx]
            )
        if fallback:
            out[np.array(fallback)] = self._ckde_host_batch(
                [fams[i] for i in fallback]
            )
        return out

    def _fold_trains(self, variable, parents):
        """Per-fold training rows of one family, variable first, nulls
        dropped: a list of (row indices, (n_k, dj) float64 rows), or None
        when some fold has no more rows than columns."""
        pos, full_mat, nulls = self._family_arrays()
        cidx = [pos[c] for c in (variable, *parents)]
        valid = ~nulls[:, cidx].any(axis=1)
        out = []
        for (tr, _te) in self.folds:
            trk = tr[valid[tr]]
            if len(trk) <= len(cidx):
                return None
            out.append((trk, full_mat[np.ix_(trk, cidx)]))
        return out

    def _ckde_ucv_batch(self, fams) -> np.ndarray:
        """UCV-selected CKDE families: every (family, fold) bandwidth
        problem of one width runs through ONE batched Nelder–Mead on the
        device (:func:`pybnesian_tpu_torch.kde.ucv.ucv_search_batch`),
        from the normal-reference start (UCV.cpp:400), and the optimal
        bandwidths feed the fused scoring path. Replaces F·K sequential
        searches (reference kde/UCV.cpp runs one NLopt loop per factor
        fit)."""
        out = np.full(len(fams), -math.inf)
        h_maps, _searches = self._ucv_bandwidths(fams)
        if h_maps:
            idxs = sorted(h_maps)
            out[np.array(idxs)] = self._ckde_host_batch(
                [fams[i] for i in idxs], h_maps=[h_maps[i] for i in idxs],
            )
        return out

    def _ucv_bandwidths(self, fams):
        """{index in ``fams``: [the K per-fold UCV bandwidths, (dj, dj),
        variable first]} by one batched search per family width, and those
        searches' :class:`~pybnesian_tpu_torch.kde.ucv.UCVSearch` records;
        a family with a fold of too few rows, or whose normal-reference
        start is not positive definite, is left out."""
        from ...kde.ucv import invvech_triangular, ucv_search_batch, vech

        K = len(self.folds)
        probs_by_dj: dict[int, list] = {}
        for i, (v, ps, _sel) in enumerate(fams):
            trains = self._fold_trains(v, ps)
            if trains is None:
                continue
            dj = len(ps) + 1
            starts = []
            for _rows, train in trains:
                n_k = len(train)
                knr = (4.0 / (n_k * (dj + 2.0))) ** (2.0 / (dj + 4.0))
                H0 = knr * np.cov(train, rowvar=False, ddof=1).reshape(dj, dj)
                try:
                    starts.append(vech(np.linalg.cholesky(H0)))
                except np.linalg.LinAlgError:
                    break
            if len(starts) == K:
                probs_by_dj.setdefault(dj, []).append((i, trains, starts))

        h_maps: dict[int, list] = {}
        searches = []
        for dj, entries in probs_by_dj.items():
            B = len(entries) * K
            npad = max(len(train) for (_i, trains, _s) in entries
                       for (_rows, train) in trains)
            Xpad = np.zeros((B, npad, dj))
            validm = np.zeros((B, npad))
            Ns = np.zeros(B)
            x0s = np.zeros((B, dj * (dj + 1) // 2))
            for b, (_i, trains, starts) in enumerate(entries):
                for k, ((_rows, train), x0) in enumerate(zip(trains, starts)):
                    row = b * K + k
                    Xpad[row, : len(train)] = train
                    validm[row, : len(train)] = 1.0
                    Ns[row] = len(train)
                    x0s[row] = x0
            search = ucv_search_batch(Xpad, validm, Ns, x0s, dj,
                                      dtype=self._dtype(), device=self.device)
            searches.append(search)
            xb = search.x
            for b, (i, _trains, _starts) in enumerate(entries):
                factors = [invvech_triangular(xb[b * K + k])
                           for k in range(K)]
                h_maps[i] = [L @ L.T for L in factors]
        return h_maps, searches

    def _ckde_host_batch(self, fams, h_maps=None) -> np.ndarray:
        """CKDE families whose per-fold bandwidths come from the host: from
        the family's own selector (a user-defined
        :class:`~pybnesian_tpu_torch.kde.BandwidthSelector`, called once
        per fold on the fold's training rows with the columns variable
        first), or precomputed, ``h_maps[i][k]`` the (dj, dj) bandwidth of
        family i in fold k in that column order. The bandwidths are
        permuted to the scoring layout (evidence first, variable last) and
        all families × folds are scored by ONE fused call, the one the
        rule bandwidths take; a fold whose bandwidth is not positive
        definite, or that has too few rows, makes its family −inf."""
        out = np.full(len(fams), -math.inf)
        kept: list[int] = []
        per_family = []
        for i, (v, ps, selector) in enumerate(fams):
            dj = len(ps) + 1
            if h_maps is not None:
                hs = h_maps[i]
            else:
                trains = self._fold_trains(v, ps)
                if trains is None:
                    continue
                try:
                    with use_device(self.device):
                        hs = [
                            np.asarray(
                                selector.bandwidth(self.df.take(rows),
                                                   [v, *ps]),
                                dtype=np.float64,
                            ).reshape(dj, dj)
                            for rows, _train in trains
                        ]
                except SingularCovarianceData:
                    continue
            kept.append(i)
            per_family.append(hs)
        if not kept:
            return out

        (pos, data, null_mask, tr_idx, tr_mask, te_idx, te_mask) = (
            self._device_cv_cache()
        )
        col_idx, col_mask, H = _family_bandwidths(
            [fams[i][:2] for i in kept], per_family, pos)
        dtype = numpy_dtype(data.dtype)
        scores = _fused_cv_scores(
            data, null_mask,
            host_to_device(col_idx, np.int64, self.device),
            host_to_device(col_mask, dtype, self.device),
            tr_idx, tr_mask, te_idx, te_mask,
            bandwidths=host_to_device(H, dtype, self.device),
        )
        out[np.array(kept)] = _finite_or_neg_inf(scores)
        return out

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
        with use_device(self.device):
            for (tr, te) in self.folds:
                factor = node_type.new_factor(model, variable, list(parents),
                                              *a, **kw)
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
        self.device = resolve_device(device)
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


class HoldoutLikelihood(Score):
    """(reference holdout_likelihood.{hpp,cpp}). ``device`` holds the data
    and runs the batched scores; default :func:`default_device`."""

    def __init__(self, df, test_ratio: float = 0.2, seed: int = 0,
                 construction_args: Arguments | None = None, device=None):
        self.df = DataFrame.wrap(df)
        self.holdout = HoldOut(self.df, test_ratio, seed)
        self.args = construction_args or Arguments()
        self.device = resolve_device(device)
        self._train = self.holdout.training_data()
        self._test = self.holdout.test_data()
        # the holdout split is one (train, test) "fold" of the CV engine
        self._engine = _KFoldEngine(
            self.df, [(self.holdout._train_idx, self.holdout._test_idx)],
            self.device,
        )

    def data(self):
        return self._train

    def training_data(self):
        return self._train

    def test_data(self):
        return self._test

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        parents = list(parents)
        a, kw = self.args.args(variable, node_type)
        factor = node_type.new_factor(model, variable, parents, *a, **kw)
        with use_device(self.device):
            try:
                factor.fit(self._train)
            except SingularCovarianceData:
                return -math.inf
            return factor.slogl(self._test)

    def _continuous_family(self, variable, parents) -> bool:
        return not self._train.is_discrete(variable) and not any(
            self._train.is_discrete(p) for p in parents
        )

    def local_score_batch(self, model, families) -> np.ndarray:
        """families: sequence of (variable, parents) or (variable, parents,
        node_type). Linear-Gaussian families go in one batched call, CKDE
        families through the one-fold CV engine. Returns (F,) float64."""
        from ...factors.ckde import CKDEType
        from ...ops.gaussian import batched_lg_holdout_loglik

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
        cont = self._train.continuous_columns()
        pos = {c: i for i, c in enumerate(cont)}
        lg_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == LinearGaussianCPDType() and self._continuous_family(v, ps)
        ]
        if lg_idx:
            tv, tvalid = self._train.device_matrix(cont, device=self.device)
            sv, svalid = self._test.device_matrix(cont, device=self.device)
            fams = [
                (pos[norm[i][0]], [pos[p] for p in norm[i][1]]) for i in lg_idx
            ]
            scores = batched_lg_holdout_loglik(
                tv, tvalid, sv, svalid,
                *family_tensors(fams, numpy_dtype(tv.dtype), self.device),
            )
            out[np.array(lg_idx)] = scores.to(torch.float64).cpu().numpy()
        ckde_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == CKDEType() and self._continuous_family(v, ps)
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
        return "HoldoutLikelihood"


class ValidatedLikelihood(ValidatedScore):
    """Main channel: CV over the holdout-training part; validation channel:
    holdout test (reference validated_likelihood.hpp:12-80). Both channels
    run on ``device`` (default :func:`default_device`)."""

    def __init__(self, df, test_ratio: float = 0.2, k: int = 10, seed: int = 0,
                 construction_args: Arguments | None = None, device=None):
        self.df = DataFrame.wrap(df)
        self.device = resolve_device(device)
        self.holdout = HoldoutLikelihood(
            self.df, test_ratio, seed, construction_args, device=self.device
        )
        self.cv = CVLikelihood(
            self.holdout.training_data(), k, seed, construction_args,
            device=self.device,
        )

    def data(self):
        return self.cv.df

    def training_data(self):
        return self.holdout.training_data()

    @property
    def holdout_lik(self):
        """HoldoutLikelihood component (read-only property, reference
        pybindings_scores.cpp:644)."""
        return self.holdout

    def validation_data(self):
        """Holdout test split backing the validation channel
        (pybindings_scores.cpp:653)."""
        return self.holdout.test_data()

    @property
    def cv_lik(self):
        """CVLikelihood component (read-only property, reference
        pybindings_scores.cpp:647)."""
        return self.cv

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        return self.cv.local_score_node_type(model, node_type, variable, parents)

    def local_score_batch(self, model, families) -> np.ndarray:
        return self.cv.local_score_batch(model, families)

    def vlocal_score_node_type(self, model, node_type, variable, parents) -> float:
        return self.holdout.local_score_node_type(
            model, node_type, variable, parents
        )

    def vlocal_score_batch(self, model, families) -> np.ndarray:
        return self.holdout.local_score_batch(model, families)

    def ToString(self) -> str:
        return "ValidatedLikelihood"
