from .base import Score, ValidatedScore
from .bic import BIC
from .likelihood import CVLikelihood, HoldoutLikelihood, ValidatedLikelihood

__all__ = ["Score", "ValidatedScore", "BIC", "CVLikelihood",
           "HoldoutLikelihood", "ValidatedLikelihood"]
