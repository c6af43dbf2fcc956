from .base import DynamicIndependenceTest, IndependenceTest
from .linearcorrelation import LinearCorrelation
from .chi_square import ChiSquare
from .hybrid_mi import MutualInformation

__all__ = [
    "IndependenceTest",
    "DynamicIndependenceTest",
    "LinearCorrelation",
    "ChiSquare",
    "MutualInformation",
]
