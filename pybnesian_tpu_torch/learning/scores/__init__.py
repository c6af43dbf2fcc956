from .base import Score, ValidatedScore
from .likelihood import CVLikelihood

__all__ = ["Score", "ValidatedScore", "CVLikelihood"]
