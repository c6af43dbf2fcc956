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
    Args,
    Arguments,
    DiscreteFactor,
    DiscreteFactorType,
    Factor,
    FactorType,
    Kwargs,
    LinearGaussianCPD,
    LinearGaussianCPDType,
    UnknownFactorType,
)
from .factors.ckde import CKDE, CKDEType
from .kde import (
    KDE,
    UCV,
    BandwidthSelector,
    NormalReferenceRule,
    ProductKDE,
    ScottsBandwidth,
)
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
    BDe,
    BGe,
    CVLikelihood,
    HoldoutLikelihood,
    Score,
    ValidatedLikelihood,
    ValidatedScore,
)
from .models import (
    DiscreteBN,
    DiscreteBNType,
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
    "Args",
    "Kwargs",
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
    "UCV",
    "BandwidthSelector",
    "KDENetwork",
    "KDENetworkType",
    "SemiparametricBN",
    "SemiparametricBNType",
    "GaussianNetwork",
    "DiscreteBN",
    "DiscreteBNType",
    "GaussianNetworkType",
    "Score",
    "ValidatedScore",
    "BIC",
    "BGe",
    "BDe",
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
