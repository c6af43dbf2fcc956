"""BDe: Bayesian Dirichlet equivalent score.

Rebuild of reference learning/scores/bde.{hpp,cpp}, ported from
``pybnesian_tpu/learning/scores/bde.py``: the iss prior spread uniformly
over joint configurations. A batch of families is counted and scored by the
native core on the host (:mod:`.discrete_native`) when the frame is small,
and by one batched count on the score's ``device``
(:func:`pybnesian_tpu_torch.ops.discrete.batched_bde`) when it is large,
for families the core declines and when the core cannot be built; a score
takes one tier for all its batches
(:func:`.discrete_native.native_tier`), as the discrete BIC does.
"""

from __future__ import annotations

import math

import numpy as np

from ...data import DataFrame
from ...factors.discrete import DiscreteFactorType
from ...runtime.device import resolve_device
from . import discrete_native
from .base import Score
from .bic import _device_codes

__all__ = ["BDe"]


class BDe(Score):
    """(reference bde.{hpp,cpp}). ``device`` counts the families of a
    large frame; default :func:`default_device`. ``native``: True counts
    with the native core, False on the device, None (the default) by the
    frame's size (:func:`.discrete_native.takes_frame`)."""

    def __init__(self, df, iss: float = 1.0, device=None,
                 native: bool | None = None):
        self.df = DataFrame.wrap(df)
        self.iss = float(iss)
        self.device = resolve_device(device)
        self._native = native
        self._codes_cache = None
        self._native_cache = None

    def _native_codes(self):
        """Cached :func:`.discrete_native.native_codes` of the frame — same
        layout as BIC's."""
        if self._native_cache is None:
            self._native_cache = discrete_native.native_codes(self.df)
        return self._native_cache

    def native_tier(self) -> bool:
        """True when the native core counts this score's families, False
        when the device does; decided at the first call and kept."""
        self._native = discrete_native.native_tier(self.df, self._native)
        return self._native

    def data(self):
        return self.df

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        if node_type != DiscreteFactorType():
            raise ValueError(
                f'Node type "{node_type}" not valid for score BDe'
            )
        parents = list(parents)
        if not all(self.df.is_discrete(p) for p in parents):
            # mirror BIC: impossible family (discrete child, continuous
            # parent) scores -inf instead of aborting the search
            return -math.inf
        return float(self._batched_discrete([(variable, parents)])[0])

    def local_score_batch(self, model, families) -> np.ndarray:
        """All-discrete families in one batch on one tier; anything else
        through :meth:`local_score_node_type`."""
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
        disc_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == DiscreteFactorType()
            and self.df.is_discrete(v)
            and all(self.df.is_discrete(p) for p in ps)
        ]
        disc_set = set(disc_idx)
        for i, (v, ps, nt) in enumerate(norm):
            if i not in disc_set:
                out[i] = self.local_score_node_type(model, nt, v, ps)
        if disc_idx:
            out[np.array(disc_idx)] = self._batched_discrete(
                [(norm[i][0], norm[i][1]) for i in disc_idx]
            )
        return out

    def _batched_discrete(self, fams) -> np.ndarray:
        """(F,) BDe of all-discrete (variable, parents) families: the
        native core on its tier (:meth:`native_tier`), the device on the
        other and for families the core declines (NaN: a configuration
        space past its limit)."""
        scores = np.full(len(fams), np.nan)
        if self.native_tier():
            pos, block, cards = self._native_codes()
            scores = discrete_native.bde_batch(
                block, cards, *discrete_native.family_arrays(fams, pos),
                self.iss,
            )
        left = np.flatnonzero(np.isnan(scores))
        if len(left):
            scores[left] = self._device_discrete([fams[i] for i in left])
        return scores

    def _device_discrete(self, fams) -> np.ndarray:
        """(F,) BDe by one batched count on the score's device."""
        from ...ops.discrete import batched_bde, family_index_tensors

        if self._codes_cache is None:
            self._codes_cache = _device_codes(self.df, self.device)
        pos, codes, cards_dev, cards = self._codes_cache
        var_idx, parent_idx, parent_mask, max_cells, max_pconfigs = (
            family_index_tensors(
                [(pos[v], [pos[p] for p in ps]) for v, ps in fams],
                cards, self.device)
        )
        out = batched_bde(codes, cards_dev, var_idx, parent_idx, parent_mask,
                          self.iss, max_cells, max_pconfigs)
        return out.cpu().numpy()

    def ToString(self) -> str:
        return "BDe"
