"""pybnesian_tpu_torch: the PyTorch / CUDA port of pybnesian_tpu.

What it holds so far:

- structure learning by greedy hill-climbing (``hc``,
  ``GreedyHillClimbing``) with the arc and node-type operators and the
  ``BIC``, ``CVLikelihood``, ``HoldoutLikelihood`` and
  ``ValidatedLikelihood`` scores, over linear-Gaussian and conditional-KDE
  (CKDE) families of Gaussian, KDE and semiparametric networks;
- fitted-model evaluation: ``KDE``, ``ProductKDE``, ``CKDE`` and network
  ``logl``, ``slogl``, ``sample``, ``cdf``.

Plain tensor code is torch; the pairwise KDE logsumexps are hand-written
CUDA kernels (``csrc/ckde_cv.cu``) that float32 tensors on the GPU launch.
Entry points run on the GPU unless the caller asks for the CPU, with a
``device=`` argument or process-wide with :func:`use_device`; with neither,
and no GPU visible, they raise. This package never imports JAX or
``pybnesian_tpu``.
"""

from .data import CrossValidation, DataFrame, HoldOut
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
from .kde import KDE, NormalReferenceRule, ProductKDE, ScottsBandwidth
from .learning.algorithms import Callback, GreedyHillClimbing, SaveModel, hc
from .learning.operators import (
    AddArc,
    ArcOperatorSet,
    ChangeNodeType,
    ChangeNodeTypeSet,
    FlipArc,
    Operator,
    OperatorPool,
    OperatorSet,
    OperatorTabuSet,
    RemoveArc,
)
from .learning.scores import (
    BIC,
    CVLikelihood,
    HoldoutLikelihood,
    Score,
    ValidatedLikelihood,
    ValidatedScore,
)
from .models import (
    GaussianNetwork,
    GaussianNetworkType,
    KDENetwork,
    KDENetworkType,
    SemiparametricBN,
    SemiparametricBNType,
)
from .runtime.device import use_device

__all__ = [
    "DataFrame",
    "CrossValidation",
    "HoldOut",
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
    "KDE",
    "ProductKDE",
    "NormalReferenceRule",
    "ScottsBandwidth",
    "KDENetwork",
    "KDENetworkType",
    "SemiparametricBN",
    "SemiparametricBNType",
    "GaussianNetwork",
    "GaussianNetworkType",
    "Score",
    "ValidatedScore",
    "BIC",
    "CVLikelihood",
    "HoldoutLikelihood",
    "ValidatedLikelihood",
    "Operator",
    "AddArc",
    "RemoveArc",
    "FlipArc",
    "ChangeNodeType",
    "OperatorTabuSet",
    "OperatorSet",
    "ArcOperatorSet",
    "ChangeNodeTypeSet",
    "OperatorPool",
    "GreedyHillClimbing",
    "hc",
    "Callback",
    "SaveModel",
    "use_device",
]
