"""pybnesian_tpu_torch: the PyTorch / CUDA port of pybnesian_tpu.

The flat public API of the JAX package (reference pybnesian/lib.cpp:22-51),
for what the port holds so far:

- graphs, data frames (static and dynamic), CV folds;
- factors: linear-Gaussian, discrete, ``CKDE`` and the hybrid
  ``CLinearGaussianCPD`` / ``HCKDE``, with ``KDE``, ``ProductKDE`` and the
  bandwidth selectors; every network class, conditional and dynamic ones
  included;
- structure learning: greedy hill-climbing (``hc``,
  ``GreedyHillClimbing``) with the arc and node-type operators and every
  score of the JAX package (``BIC``, ``BDe``, ``BGe``, ``CVLikelihood``,
  ``HoldoutLikelihood``, ``ValidatedLikelihood`` and their ``Dynamic*``
  forms), and the constraint-based learners ``PC``, ``MMPC``, ``MMHC`` and
  ``DMMHC`` over every independence test of the JAX package: the host
  tests ``LinearCorrelation``, ``ChiSquare`` and ``MutualInformation``,
  and ``RCoT`` and ``KMutualInformation``, whose algebra runs on the GPU;
- fitted-model evaluation: ``logl``, ``slogl``, ``sample``, ``cdf``;
- posterior inference over CPD parameters (``inference``: the
  log-density, HMC/NUTS, SMC, ADVI and diagnostics).

Plain tensor code is torch; the pairwise KDE logsumexps are hand-written
CUDA kernels (``csrc/ckde_cv.cu``) that float32 tensors on the GPU launch.
The host independence tests and the PC / MMPC skeleton searches run on the
host (numpy and the native g++ core), as in the JAX package. Entry points that
hold tensors run on the GPU unless the caller asks for the CPU, with a
``device=`` argument or process-wide with :func:`use_device`; with neither,
and no GPU visible, they raise. This package never imports JAX or
``pybnesian_tpu``.
"""

from .data import CrossValidation, DataFrame, HoldOut
from .data.dynamic import DynamicDataFrame, DynamicVariable
from .graph import (
    ConditionalDag,
    ConditionalDirectedGraph,
    ConditionalPartiallyDirectedGraph,
    ConditionalUndirectedGraph,
    Dag,
    DirectedGraph,
    PartiallyDirectedGraph,
    UndirectedGraph,
)
from .factors import (
    Args,
    Arguments,
    Assignment,
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
from .factors.hybrid import CLinearGaussianCPD, HCKDE
from .kde import (
    KDE,
    UCV,
    BandwidthSelector,
    NormalReferenceRule,
    ProductKDE,
    ScottsBandwidth,
)
from .kde.ucv import UCVScorer
from .models import (
    BayesianNetwork,
    BayesianNetworkBase,
    BayesianNetworkType,
    CLGNetwork,
    CLGNetworkType,
    ConditionalBayesianNetwork,
    ConditionalCLGNetwork,
    ConditionalDiscreteBN,
    ConditionalGaussianNetwork,
    ConditionalHeterogeneousBN,
    ConditionalHomogeneousBN,
    ConditionalKDENetwork,
    ConditionalSemiparametricBN,
    DiscreteBN,
    DiscreteBNType,
    GaussianNetwork,
    GaussianNetworkType,
    HeterogeneousBN,
    HeterogeneousBNType,
    HomogeneousBN,
    HomogeneousBNType,
    KDENetwork,
    KDENetworkType,
    SemiparametricBN,
    SemiparametricBNType,
)
from .models.dynamic import (
    DynamicBayesianNetwork,
    DynamicCLGNetwork,
    DynamicDiscreteBN,
    DynamicGaussianNetwork,
    DynamicHeterogeneousBN,
    DynamicHomogeneousBN,
    DynamicKDENetwork,
    DynamicSemiparametricBN,
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
from .learning.scores.dynamic import (
    DynamicBDe,
    DynamicBGe,
    DynamicBIC,
    DynamicCVLikelihood,
    DynamicHoldoutLikelihood,
    DynamicScore,
    DynamicValidatedLikelihood,
)
from .learning.operators import (
    AddArc,
    ArcOperator,
    ArcOperatorSet,
    ChangeNodeType,
    ChangeNodeTypeSet,
    FlipArc,
    LocalScoreCache,
    Operator,
    OperatorPool,
    OperatorSet,
    OperatorTabuSet,
    RemoveArc,
)
from .learning.parameters import (
    MLE,
    MLEDiscreteFactor,
    MLELinearGaussianCPD,
    LinearGaussianParams,
)
from .factors.discrete import DiscreteParams as DiscreteFactorParams
from .learning.algorithms import Callback, GreedyHillClimbing, SaveModel, hc
from .learning.algorithms.pc import PC, MeekRules
from .learning.algorithms.mmpc import MMPC
from .learning.algorithms.mmhc import MMHC
from .learning.algorithms.dmmhc import DMMHC
from .learning.independences import (
    ChiSquare,
    DynamicIndependenceTest,
    IndependenceTest,
    KMutualInformation,
    LinearCorrelation,
    MutualInformation,
    RCoT,
)
from .learning.independences.chi_square import DynamicChiSquare
from .learning.independences.hybrid_mi import DynamicMutualInformation
from .learning.independences.kmutual_info import DynamicKMutualInformation
from .learning.independences.linearcorrelation import DynamicLinearCorrelation
from .learning.independences.rcot import DynamicRCoT
from .kdtree import KDTree
from .utils.pickle import load
from .runtime.device import use_device
from . import data, factors, graph, kde, kdtree, learning, models, utils

# Interface-compatible aliases, as in the JAX package (models/base.py)
ConditionalBayesianNetworkBase = ConditionalBayesianNetwork
DynamicBayesianNetworkBase = DynamicBayesianNetwork

__version__ = "0.3.0"

# the JAX package's names (its modules data ... utils included), less the
# ones still to port (tests/test_torch_public_surface.py lists them), plus
# the device choice; runtime, ops and interop stay out, as the JAX package
# keeps its own ops and runtime out
__all__ = [
    "AddArc", "ArcOperator", "ArcOperatorSet", "Args", "Arguments",
    "Assignment", "BDe", "BGe", "BIC", "BandwidthSelector", "BayesianNetwork",
    "BayesianNetworkBase", "BayesianNetworkType", "CKDE", "CKDEType",
    "CLGNetwork", "CLGNetworkType", "CLinearGaussianCPD", "CVLikelihood",
    "Callback", "ChangeNodeType", "ChangeNodeTypeSet", "ChiSquare",
    "ConditionalBayesianNetwork", "ConditionalBayesianNetworkBase",
    "ConditionalCLGNetwork", "ConditionalDag", "ConditionalDirectedGraph",
    "ConditionalDiscreteBN", "ConditionalGaussianNetwork",
    "ConditionalHeterogeneousBN", "ConditionalHomogeneousBN",
    "ConditionalKDENetwork", "ConditionalPartiallyDirectedGraph",
    "ConditionalSemiparametricBN", "ConditionalUndirectedGraph",
    "CrossValidation", "DMMHC", "Dag", "DataFrame", "DirectedGraph",
    "DiscreteBN", "DiscreteBNType", "DiscreteFactor", "DiscreteFactorParams",
    "DiscreteFactorType", "DynamicBDe", "DynamicBGe", "DynamicBIC",
    "DynamicBayesianNetwork", "DynamicBayesianNetworkBase",
    "DynamicCLGNetwork", "DynamicCVLikelihood", "DynamicChiSquare",
    "DynamicDataFrame", "DynamicDiscreteBN", "DynamicGaussianNetwork",
    "DynamicHeterogeneousBN", "DynamicHoldoutLikelihood",
    "DynamicHomogeneousBN", "DynamicIndependenceTest", "DynamicKDENetwork",
    "DynamicKMutualInformation",
    "DynamicLinearCorrelation", "DynamicMutualInformation", "DynamicRCoT",
    "DynamicScore",
    "DynamicSemiparametricBN", "DynamicValidatedLikelihood", "DynamicVariable",
    "Factor", "FactorType", "FlipArc", "GaussianNetwork",
    "GaussianNetworkType", "GreedyHillClimbing", "HCKDE", "HeterogeneousBN",
    "HeterogeneousBNType", "HoldOut", "HoldoutLikelihood", "HomogeneousBN",
    "HomogeneousBNType", "IndependenceTest", "KDE", "KDENetwork",
    "KDENetworkType", "KDTree", "KMutualInformation", "Kwargs",
    "LinearCorrelation",
    "LinearGaussianCPD", "LinearGaussianCPDType", "LinearGaussianParams",
    "LocalScoreCache", "MLE", "MLEDiscreteFactor", "MLELinearGaussianCPD",
    "MMHC", "MMPC", "MeekRules", "MutualInformation", "NormalReferenceRule",
    "Operator", "OperatorPool", "OperatorSet", "OperatorTabuSet", "PC",
    "PartiallyDirectedGraph", "ProductKDE", "RCoT", "RemoveArc", "SaveModel",
    "Score",
    "ScottsBandwidth", "SemiparametricBN", "SemiparametricBNType", "UCV",
    "UCVScorer", "UndirectedGraph", "UnknownFactorType", "ValidatedLikelihood",
    "ValidatedScore", "data", "factors", "graph", "hc", "kde", "kdtree",
    "learning", "load", "models", "use_device", "utils"
]
