"""pybnesian_tpu_torch: the PyTorch / CUDA port of pybnesian_tpu.

The slice ported so far is cross-validated likelihood scoring of
linear-Gaussian and conditional-KDE families (``CVLikelihood``), the inner
loop of structure learning for KDE and semiparametric networks. Plain
tensor code is torch; the pairwise CV-CKDE logsumexp is a hand-written CUDA
kernel (``csrc/ckde_cv.cu``) on a GPU. This package never imports JAX or
``pybnesian_tpu``.
"""

from .data import CrossValidation, DataFrame
from .factors import (
    Arguments,
    DiscreteFactor,
    DiscreteFactorType,
    Factor,
    FactorType,
    LinearGaussianCPD,
    LinearGaussianCPDType,
    UnknownFactorType,
)
from .factors.ckde import CKDE, CKDEType
from .kde import NormalReferenceRule, ScottsBandwidth
from .learning.scores import CVLikelihood
from .models import GaussianNetwork, KDENetwork, SemiparametricBN

__all__ = [
    "DataFrame",
    "CrossValidation",
    "FactorType",
    "Factor",
    "UnknownFactorType",
    "Arguments",
    "LinearGaussianCPD",
    "LinearGaussianCPDType",
    "DiscreteFactor",
    "DiscreteFactorType",
    "CKDE",
    "CKDEType",
    "NormalReferenceRule",
    "ScottsBandwidth",
    "KDENetwork",
    "SemiparametricBN",
    "GaussianNetwork",
    "CVLikelihood",
]
