"""Carry the JAX package's state into the port's objects.

Everything here takes numpy arrays and plain Python values — a dict of
column arrays, the (train_idx, test_idx) pairs of
``CrossValidation.fold_indices``, node names, arcs and node-type names as
``FactorType.ToString()`` gives them — so that the two packages can score
the same folds on the same graph. It never imports ``pybnesian_tpu``.
"""

from __future__ import annotations

import numpy as np

from .factors.base import UnknownFactorType
from .factors.ckde import CKDEType
from .factors.discrete import DiscreteFactorType
from .factors.lineargaussian import LinearGaussianCPDType
from .learning.scores.likelihood import CVLikelihood, _KFoldEngine
from .models import GaussianNetwork, KDENetwork, SemiparametricBN

__all__ = ["network", "cv_likelihood"]

_NETWORKS = {
    "GaussianNetwork": GaussianNetwork,
    "KDENetwork": KDENetwork,
    "SemiparametricBN": SemiparametricBN,
}

_NODE_TYPES = {
    "LinearGaussianFactor": LinearGaussianCPDType,
    "CKDEFactor": CKDEType,
    "DiscreteFactor": DiscreteFactorType,
    "UnknownFactorType": UnknownFactorType,
}


def network(kind: str, nodes, arcs=(), node_types=None):
    """The port's network of class name ``kind`` ("GaussianNetwork",
    "KDENetwork" or "SemiparametricBN") over ``nodes`` with ``arcs``
    [(source, target)]. ``node_types`` maps node names to type names
    ("LinearGaussianFactor", "CKDEFactor", "DiscreteFactor",
    "UnknownFactorType"); nodes left out keep the network's default."""
    model = _NETWORKS[kind](list(nodes), [tuple(a) for a in arcs])
    for node, name in (node_types or {}).items():
        model.set_node_type(node, _NODE_TYPES[name]())
    return model


def cv_likelihood(columns, folds, construction_args=None, device=None):
    """CVLikelihood over ``columns`` (dict of arrays or DataFrame) whose
    scores use exactly the given ``folds``: a list of (train_idx, test_idx)
    row-index arrays, one pair per fold."""
    folds = [(np.asarray(tr), np.asarray(te)) for tr, te in folds]
    score = CVLikelihood(columns, k=len(folds),
                         construction_args=construction_args, device=device)
    score._engine = _KFoldEngine(score.df, folds, score.device)
    return score
