"""Carry the JAX package's state into the port's objects.

Everything here takes numpy arrays and plain Python values — a dict of
column arrays, the (train_idx, test_idx) pairs of
``CrossValidation.fold_indices``, node names, arcs and node-type names as
``FactorType.ToString()`` gives them, the fitted parameters of CKDE and
linear-Gaussian factors — so that the two packages can score the same
folds on the same graph and evaluate the same fitted model without either
refitting. It never imports ``pybnesian_tpu``: :func:`network_state` reads
a fitted network, and :func:`operator_state` a structure-search operator,
of either package through its public surface.
"""

from __future__ import annotations

import numpy as np

from .factors.base import UnknownFactorType
from .factors.ckde import CKDE, CKDEType
from .factors.discrete import DiscreteFactorType
from .factors.lineargaussian import LinearGaussianCPD, LinearGaussianCPDType
from .kde import KDE, NormalReferenceRule, ScottsBandwidth
from .kde.ucv import UCV
from .learning.scores import BIC, BDe, BGe
from .learning.scores.likelihood import CVLikelihood, _KFoldEngine
from .models import DiscreteBN, GaussianNetwork, KDENetwork, SemiparametricBN

__all__ = ["network", "cv_likelihood", "score_state", "score", "cpd_state",
           "fitted_cpd", "network_state", "fitted_network", "operator_state"]

_SELECTORS = {
    "NormalReferenceRule": NormalReferenceRule,
    "ScottsBandwidth": ScottsBandwidth,
    "UCV": UCV,
}

_NETWORKS = {
    "DiscreteBN": DiscreteBN,
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
    """The port's network of class name ``kind`` ("DiscreteBN",
    "GaussianNetwork", "KDENetwork" or "SemiparametricBN") over ``nodes`` with ``arcs``
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


def score_state(score) -> dict:
    """The class name and prior parameters of a closed-form score (BIC,
    BDe, BGe) of either package, as plain Python: ``kind``, and ``iss``
    for BDe, ``iss_mu``, ``iss_w`` and ``nu`` for BGe."""
    state = {"kind": type(score).__name__}
    for key in ("iss", "iss_mu", "iss_w", "nu"):
        if hasattr(score, key):
            value = getattr(score, key)
            state[key] = (None if value is None
                          else np.asarray(value, np.float64).tolist())
    return state


def score(columns, kind: str, device=None, **prior):
    """The port's BIC, BDe or BGe over ``columns`` (a pandas frame with
    categorical columns, a dict of arrays or a DataFrame) from
    :func:`score_state`'s dict: ``score(df, **score_state(other))``."""
    if kind == "BGe":
        return BGe(columns, **prior)
    return {"BIC": BIC, "BDe": BDe}[kind](columns, device=device, **prior)


def cpd_state(cpd) -> dict:
    """The fitted state of a CKDE or linear-Gaussian factor of either
    package, as numpy and plain Python. CKDE: ``evidence``, ``training``
    (the joint's (n, 1 + e) rows, variable first), ``bandwidth``, ``dtype``
    (numpy name of the data type) and ``bandwidth_selector`` (class name).
    Linear-Gaussian: ``evidence``, ``beta`` and ``variance``."""
    evidence = list(cpd.evidence())
    if hasattr(cpd, "kde_joint"):
        joint = cpd.kde_joint()
        return {
            "evidence": evidence,
            "training": np.array(joint._training, dtype=np.float64),
            "bandwidth": np.array(joint.bandwidth, dtype=np.float64),
            "dtype": np.dtype(joint._dtype).name,
            "bandwidth_selector": type(cpd.bandwidth_selector()).__name__,
        }
    return {"evidence": evidence,
            "beta": np.array(cpd.beta, dtype=np.float64),
            "variance": float(cpd.variance)}


def fitted_cpd(variable: str, state: dict):
    """The port's fitted factor of ``variable`` from :func:`cpd_state`'s
    dict: a :class:`CKDE` that keeps the given training rows and bandwidth,
    or a :class:`LinearGaussianCPD`. Nothing is refitted."""
    if "beta" in state:
        return LinearGaussianCPD(variable, state["evidence"], state["beta"],
                                 state["variance"])
    selector = _SELECTORS[state["bandwidth_selector"]]()
    joint = KDE([variable, *state["evidence"]], selector)
    joint._dtype = np.dtype(state["dtype"])
    joint.fit_with_bandwidth(state["training"], state["bandwidth"])
    cpd = CKDE(variable, state["evidence"], selector)
    cpd._set_joint(joint)
    return cpd


def network_state(model) -> dict:
    """The arguments of :func:`fitted_network` for a fitted network of
    either package: class name, nodes, arcs, node-type names and every
    node's :func:`cpd_state`."""
    nodes = list(model.nodes())
    return {
        "kind": type(model).__name__,
        "nodes": nodes,
        "arcs": [tuple(a) for a in model.arcs()],
        "node_types": {n: model.node_type(n).ToString() for n in nodes},
        "cpds": {n: cpd_state(model.cpd(n)) for n in nodes},
    }


def fitted_network(kind: str, nodes, arcs, node_types, cpds):
    """The port's fitted network: :func:`network` over ``nodes``, ``arcs``
    and ``node_types``, with ``cpds`` ({node: :func:`cpd_state` dict})
    added as they are."""
    model = network(kind, nodes, arcs, node_types)
    model.add_cpds([fitted_cpd(n, st) for n, st in cpds.items()])
    return model


def operator_state(op):
    """A structure-search operator of either package as plain Python, so
    that the two packages' searches can be compared step by step:
    ``(class name, nodes, node-type name or None, delta)``, with nodes
    ``(source, target)`` for an arc operator and ``(node,)`` for
    ``ChangeNodeType``. ``None`` stays ``None``."""
    if op is None:
        return None
    kind = type(op).__name__
    if hasattr(op, "node_type"):
        return kind, (op.node(),), op.node_type().ToString(), op.delta()
    return kind, (op.source(), op.target()), None, op.delta()
