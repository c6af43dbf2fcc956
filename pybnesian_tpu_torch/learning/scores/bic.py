"""BIC score (reference learning/scores/bic.{hpp,cpp}).

Ported from ``pybnesian_tpu/learning/scores/bic.py``. Dispatches per node
type: linear-Gaussian closed form (bic.cpp:12-27) and the CLG partition
(bic.cpp:29-64) on the host; the linear-Gaussian batch path — the
hill-climbing hot loop of Gaussian networks — is one batched call over all
candidate families (:func:`pybnesian_tpu_torch.ops.gaussian.batched_bic`)
on the score's ``device``. The discrete count form (bic.cpp:66-97) has
two tiers: the native counting core on the host
(:mod:`.discrete_native`) for small frames, and one batched count on the
device (:func:`pybnesian_tpu_torch.ops.discrete.batched_bic_discrete`) for
large ones, for families the core declines and when the core cannot be
built; a score takes one tier for all its batches
(:func:`.discrete_native.native_tier`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...data import DataFrame
from ...factors.discrete import (
    DiscreteFactorType,
    create_cardinality_strides,
    flat_indices,
)
from ...factors.lineargaussian import LinearGaussianCPDType
from ...learning.parameters import mle_lineargaussian
from ...ops.gaussian import batched_bic, family_tensors
from ...runtime.device import numpy_dtype, resolve_device
from ...utils import MACHINE_TOL
from . import discrete_native
from .base import Score

__all__ = ["BIC"]

_LOG_2PI = math.log(2 * math.pi)


class BIC(Score):
    """(reference bic.{hpp,cpp}). ``device`` holds the data and runs the
    batched linear-Gaussian batches and the discrete ones of a large
    frame; default :func:`default_device`. ``native``: True counts the
    discrete families with the native core, False on the device, None
    (the default) by the frame's size
    (:func:`.discrete_native.takes_frame`)."""

    def __init__(self, df, device=None, native: bool | None = None):
        self.df = DataFrame.wrap(df)
        self.device = resolve_device(device)
        self._native = native
        self._device_cache = None
        self._disc_cache = None
        self._native_cache = None
        self._disc_set = None

    def _discrete_set(self) -> frozenset:
        """Cached discrete-column name set (the DataFrame is immutable):
        per-family dispatch does set lookups instead of per-name
        ``df.is_discrete`` calls."""
        if self._disc_set is None:
            self._disc_set = frozenset(self.df.discrete_columns())
        return self._disc_set

    def _native_codes(self):
        """Cached :func:`.discrete_native.native_codes` of the frame."""
        if self._native_cache is None:
            self._native_cache = discrete_native.native_codes(self.df)
        return self._native_cache

    def native_tier(self) -> bool:
        """True when the native core counts this score's discrete
        families, False when the device does; decided at the first call
        and kept."""
        self._native = discrete_native.native_tier(self.df, self._native)
        return self._native

    def data(self):
        return self.df

    # ------------------------------------------------------------- dispatch
    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        parents = list(parents)
        if node_type == LinearGaussianCPDType():
            discrete_parents = [
                p for p in parents if self.df.is_discrete(p)
            ]
            continuous_parents = [
                p for p in parents if not self.df.is_discrete(p)
            ]
            if discrete_parents:
                return self._bic_clg(variable, discrete_parents, continuous_parents)
            return self._bic_lineargaussian(variable, parents)
        if node_type == DiscreteFactorType():
            if not all(self.df.is_discrete(p) for p in parents):
                # a discrete child cannot have continuous parents. The
                # reference throws here (bic.cpp:131-135), which would abort
                # a search that proposes the arc; scoring it as impossible
                # keeps hc robust without changing any legal result.
                return -math.inf
            return self._bic_discrete(variable, parents)
        raise ValueError(
            f"BIC is not defined for factor type {node_type}."
        )

    # --------------------------------------------------------------- pieces
    def _bic_lineargaussian(self, variable, parents) -> float:
        params = mle_lineargaussian(self.df, variable, parents)
        if params.variance < MACHINE_TOL or math.isinf(params.variance):
            return -math.inf
        n = self.df.valid_rows(variable, *parents)
        k = len(parents)
        loglik = (
            0.5 * (1 + k - n)
            - 0.5 * n * _LOG_2PI
            - 0.5 * n * math.log(params.variance)
        )
        return loglik - math.log(n) * 0.5 * (k + 2)

    def _bic_discrete(self, variable, parents) -> float:
        return float(self._batched_discrete([(variable, list(parents))])[0])

    def _bic_clg(self, variable, discrete_parents, continuous_parents) -> float:
        """Per-discrete-configuration linear regressions (bic.cpp:29-64)."""
        card, strides = create_cardinality_strides(
            self.df, discrete_parents[0], discrete_parents[1:]
        )
        config_idx = flat_indices(self.df, discrete_parents, strides)
        num_configs = int(np.prod(card))
        loglik = 0.0
        kc = len(continuous_parents)
        all_idx = np.arange(self.df.num_rows)
        for c in range(num_configs):
            rows = all_idx[config_idx == c]
            if len(rows) == 0:
                continue
            sub = self.df.take(rows)
            params = mle_lineargaussian(sub, variable, continuous_parents)
            if params.variance < MACHINE_TOL or math.isinf(params.variance):
                return -math.inf
            nv = sub.valid_rows(variable, *continuous_parents)
            loglik += (
                0.5 * (1 + kc - nv)
                - 0.5 * nv * _LOG_2PI
                - 0.5 * nv * math.log(params.variance)
            )
        n = self.df.valid_rows(variable, *discrete_parents, *continuous_parents)
        return loglik - math.log(n) * 0.5 * num_configs * (kc + 2)

    # ----------------------------------------------------------- batched
    def _device_data(self):
        if self._device_cache is None:
            cols = self.df.continuous_columns()
            values, valid = self.df.device_matrix(cols, device=self.device)
            self._device_cache = (
                {c: i for i, c in enumerate(cols)},
                values,
                valid,
            )
        return self._device_cache

    def local_score_batch(self, model, families) -> np.ndarray:
        """One batched call for all linear-Gaussian families; the host
        routes for CLG families."""
        homog_nt = (
            model.type().default_node_type()
            if model.type().is_homogeneous()
            else None
        )
        norm = []
        for fam in families:
            if len(fam) == 3:
                v, ps, nt = fam
                if nt is None:
                    nt = homog_nt or self._node_type(model, v)
            else:
                v, ps = fam
                nt = homog_nt or self._node_type(model, v)
            norm.append((v, list(ps), nt))

        out = np.empty(len(norm))
        lg_idx = []
        disc_idx = []
        lg_t = LinearGaussianCPDType()
        dc_t = DiscreteFactorType()
        disc = self._discrete_set()
        for i, (v, ps, nt) in enumerate(norm):
            if nt == lg_t and v not in disc and not any(
                p in disc for p in ps
            ):
                lg_idx.append(i)
            elif nt == dc_t and v in disc and all(p in disc for p in ps):
                disc_idx.append(i)
            else:
                out[i] = self.local_score_node_type(model, nt, v, ps)

        if disc_idx:
            out[np.array(disc_idx)] = self._batched_discrete(
                [(norm[i][0], norm[i][1]) for i in disc_idx]
            )
        if lg_idx:
            pos, values, valid = self._device_data()
            fams = [(pos[norm[i][0]], [pos[p] for p in norm[i][1]]) for i in lg_idx]
            scores = batched_bic(values, valid, *family_tensors(
                fams, numpy_dtype(values.dtype), self.device))
            out[np.array(lg_idx)] = scores.to(torch.float64).cpu().numpy()
        return out

    def _batched_discrete(self, fams) -> np.ndarray:
        """(F,) BIC of all-discrete (variable, parents) families: the
        native core on its tier (:meth:`native_tier`), the device on the
        other and for families the core declines (NaN: a configuration
        space past its limit)."""
        scores = np.full(len(fams), np.nan)
        if self.native_tier():
            pos, block, cards = self._native_codes()
            scores = discrete_native.bic_batch(
                block, cards, *discrete_native.family_arrays(fams, pos))
        left = np.flatnonzero(np.isnan(scores))
        if len(left):
            scores[left] = self._device_discrete([fams[i] for i in left])
        return scores

    def _device_discrete(self, fams) -> np.ndarray:
        """(F,) discrete BIC by one batched count on the score's device."""
        from ...ops.discrete import batched_bic_discrete, family_index_tensors

        if self._disc_cache is None:
            self._disc_cache = _device_codes(self.df, self.device)
        pos, codes, cards_dev, cards = self._disc_cache
        out = batched_bic_discrete(
            codes, cards_dev,
            *family_index_tensors(
                [(pos[v], [pos[p] for p in ps]) for v, ps in fams],
                cards, self.device),
        )
        return out.cpu().numpy()

    def ToString(self) -> str:
        return "BIC"


def _device_codes(df, device):
    """``(positions, codes, cards on the device, cards on the host)`` of a
    frame's discrete columns for :mod:`pybnesian_tpu_torch.ops.discrete`.
    The (n, D) code tensor is laid out column by column, so that a
    family's gather of whole columns reads contiguous memory."""
    cols = df.discrete_columns()
    codes = df.device_codes(cols, device=device)
    cards = np.array([df.cardinality(c) for c in cols], np.int64)
    return ({c: i for i, c in enumerate(cols)},
            codes.T.contiguous().T,
            torch.from_numpy(cards).to(device),
            cards)
