from .base import (
    Args,
    Arguments,
    Assignment,
    Factor,
    FactorType,
    Kwargs,
    UnknownFactorType,
)
from .discrete import DiscreteFactor, DiscreteFactorType
from .hybrid import CLinearGaussianCPD, CLinearGaussianCPDType, HCKDE, HCKDEType
from .lineargaussian import LinearGaussianCPD, LinearGaussianCPDType

__all__ = [
    "FactorType",
    "Factor",
    "UnknownFactorType",
    "Args",
    "Kwargs",
    "Arguments",
    "Assignment",
    "LinearGaussianCPD",
    "LinearGaussianCPDType",
    "DiscreteFactor",
    "DiscreteFactorType",
    "CLinearGaussianCPD",
    "CLinearGaussianCPDType",
    "HCKDE",
    "HCKDEType",
]
