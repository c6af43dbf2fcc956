"""Dynamic score adaptors: static + transition score pairs
(reference learning/scores/scores.hpp:74-101 and the Dynamic* aliases in each
score header).

Copied from ``pybnesian_tpu/learning/scores/dynamic.py``.
"""

from __future__ import annotations

from ...data.dynamic import DynamicDataFrame
from .base import Score
from .bde import BDe
from .bge import BGe
from .bic import BIC
from .likelihood import CVLikelihood, HoldoutLikelihood, ValidatedLikelihood

__all__ = [
    "DynamicScore",
    "DynamicBIC",
    "DynamicBGe",
    "DynamicBDe",
    "DynamicCVLikelihood",
    "DynamicHoldoutLikelihood",
    "DynamicValidatedLikelihood",
]


class DynamicScore:
    """Pairs a static-slice score and a transition-slice score."""

    score_cls = None

    def __init__(self, ddf: DynamicDataFrame, *args, **kwargs):
        if not isinstance(ddf, DynamicDataFrame):
            raise TypeError("Dynamic scores require a DynamicDataFrame")
        self.ddf = ddf
        self._static = self.score_cls(ddf.static_df(), *args, **kwargs)
        self._transition = self.score_cls(ddf.transition_df(), *args, **kwargs)

    def static_score(self) -> Score:
        return self._static

    def transition_score(self) -> Score:
        return self._transition

    def has_variables(self, variables) -> bool:
        return self._static.has_variables(variables) or (
            self._transition.has_variables(variables)
        )

    def ToString(self) -> str:
        return f"Dynamic{self.score_cls.__name__}"


class DynamicBIC(DynamicScore):
    score_cls = BIC


class DynamicBGe(DynamicScore):
    score_cls = BGe


class DynamicBDe(DynamicScore):
    score_cls = BDe


class DynamicCVLikelihood(DynamicScore):
    score_cls = CVLikelihood


class DynamicHoldoutLikelihood(DynamicScore):
    score_cls = HoldoutLikelihood


class DynamicValidatedLikelihood(DynamicScore):
    score_cls = ValidatedLikelihood
