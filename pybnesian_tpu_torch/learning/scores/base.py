"""Score interfaces (reference learning/scores/scores.hpp:14-101).

TPU-first addition: ``local_score_batch`` — scores a *list* of candidate
families in one call. Concrete scores override it with a single batched
device kernel (the replacement for the reference's one-`local_score`-per-cell
loop, operators.cpp:100-131); the base implementation falls back to a host
loop so Python-defined scores keep working inside the search algorithms.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ...data import DataFrame

__all__ = ["Score", "ValidatedScore", "DynamicScoreAdaptator"]


class Score:
    def data(self):
        """Training DataFrame, or None when the score has no data."""
        return None

    def has_variables(self, variables) -> bool:
        df = self.data()
        if df is None:
            return False
        if isinstance(variables, str):
            variables = [variables]
        return all(v in df for v in variables)

    def compatible_bn(self, model) -> bool:
        """Whether the score can evaluate the model. Data-backed scores
        check variable coverage; a custom Python score that implements only
        ``local_score`` (data() stays None) is compatible with everything —
        the reference leaves this pure-virtual, so its Python trampoline
        never silently defaults to False."""
        if self.data() is None:
            return True
        return self.has_variables(model.nodes())

    # ------------------------------------------------------------- scoring
    def local_score(self, model, variable, parents=None) -> float:
        if parents is None:
            parents = model.parents(variable)
        node_type = self._node_type(model, variable)
        return self.local_score_node_type(model, node_type, variable, parents)

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        raise NotImplementedError

    def score(self, model) -> float:
        return float(
            sum(self.local_score(model, n) for n in model.nodes())
        )

    def _node_type(self, model, variable):
        df = self.data()
        if df is not None:
            return model.underlying_node_type(df, variable)
        return model.node_type(variable)

    # ------------------------------------------------------- batched (TPU)
    def local_score_batch(self, model, families: Sequence) -> np.ndarray:
        """families: sequence of (variable, parents) or
        (variable, parents, node_type). Returns (F,) scores."""
        out = np.empty(len(families))
        for i, fam in enumerate(families):
            if len(fam) == 3 and fam[2] is not None:
                v, ps, nt = fam
                out[i] = self.local_score_node_type(model, nt, v, list(ps))
            else:
                v, ps = fam[0], fam[1]
                # route through local_score so a Python subclass that only
                # implements local_score (the reference extension contract,
                # pybindings_scores.cpp:282) works inside the search
                out[i] = self.local_score(model, v, list(ps))
        return out

    def ToString(self) -> str:
        return type(self).__name__

    def __str__(self) -> str:
        return self.ToString()


class ValidatedScore(Score):
    """Score with a second, held-out validation channel
    (reference scores.hpp:47-72)."""

    def vlocal_score(self, model, variable, parents=None) -> float:
        if parents is None:
            parents = model.parents(variable)
        node_type = self._node_type(model, variable)
        return self.vlocal_score_node_type(model, node_type, variable, parents)

    def vlocal_score_node_type(self, model, node_type, variable, parents) -> float:
        raise NotImplementedError

    def vscore(self, model) -> float:
        return float(sum(self.vlocal_score(model, n) for n in model.nodes()))

    def vlocal_score_batch(self, model, families) -> np.ndarray:
        out = np.empty(len(families))
        for i, fam in enumerate(families):
            if len(fam) == 3:
                v, ps, nt = fam
                if nt is None:
                    nt = self._node_type(model, v)
            else:
                v, ps = fam
                nt = self._node_type(model, v)
            out[i] = self.vlocal_score_node_type(model, nt, v, list(ps))
        return out


class DynamicScoreAdaptator:
    """Static + transition score pair for dynamic BNs
    (reference scores.hpp:74-101)."""

    def __init__(self, score_cls, df, *args, markovian_order=1, **kwargs):
        from ...data.dynamic import DynamicDataFrame

        if isinstance(df, DynamicDataFrame):
            ddf = df
        else:
            raise TypeError("DynamicScore requires a DynamicDataFrame")
        self._static = score_cls(ddf.static_df(), *args, **kwargs)
        self._transition = score_cls(ddf.transition_df(), *args, **kwargs)

    def static_score(self) -> Score:
        return self._static

    def transition_score(self) -> Score:
        return self._transition

    def has_variables(self, variables) -> bool:
        return self._static.has_variables(variables) or self._transition.has_variables(variables)
