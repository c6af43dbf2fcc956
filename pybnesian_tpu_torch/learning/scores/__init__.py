from .base import DynamicScoreAdaptator, Score, ValidatedScore
from .bde import BDe
from .bge import BGe
from .bic import BIC
from .likelihood import CVLikelihood, HoldoutLikelihood, ValidatedLikelihood

__all__ = ["Score", "ValidatedScore", "DynamicScoreAdaptator", "BIC", "BGe", "BDe", "CVLikelihood",
           "HoldoutLikelihood", "ValidatedLikelihood"]
