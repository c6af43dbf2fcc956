"""Carry the JAX package's state into the port's objects.

Everything here takes numpy arrays and plain Python values — a dict of
column arrays, the (train_idx, test_idx) pairs of
``CrossValidation.fold_indices``, node names, arcs and node-type names as
``FactorType.ToString()`` gives them, the fitted parameters of CKDE,
linear-Gaussian, discrete and hybrid factors — so that the two packages can
score the same folds on the same graph and evaluate the same fitted model
without either refitting; :func:`param_layout` carries a posterior's flat
parameter layout and vector, so that both packages evaluate the same
density at the same point. It never imports ``pybnesian_tpu``:
:func:`network_state` reads a fitted network (static, conditional or
dynamic), and :func:`operator_state` a structure-search operator, of
either package through its public surface.
"""

from __future__ import annotations

import numpy as np

from . import models
from .factors.base import UnknownFactorType
from .factors.ckde import CKDE, CKDEType
from .factors.discrete import DiscreteFactor, DiscreteFactorType
from .factors.hybrid import CLinearGaussianCPD, HCKDE
from .factors.lineargaussian import LinearGaussianCPD, LinearGaussianCPDType
from .inference.logdensity import ParamLayout
from .kde import KDE, NormalReferenceRule, ScottsBandwidth
from .kde.ucv import UCV
from .learning.scores import BIC, BDe, BGe
from .learning.scores.likelihood import CVLikelihood, _KFoldEngine
from .models import dynamic
from .runtime.device import host_to_device

__all__ = ["network", "network_args", "cv_likelihood", "score_state",
           "score", "cpd_state", "fitted_cpd", "network_state",
           "fitted_network", "operator_state", "param_layout"]

_SELECTORS = {
    "NormalReferenceRule": NormalReferenceRule,
    "ScottsBandwidth": ScottsBandwidth,
    "UCV": UCV,
}

_ADAPTATORS = {"CLinearGaussianCPD": CLinearGaussianCPD, "HCKDE": HCKDE}

_NODE_TYPES = {
    "LinearGaussianFactor": LinearGaussianCPDType,
    "CKDEFactor": CKDEType,
    "DiscreteFactor": DiscreteFactorType,
    "UnknownFactorType": UnknownFactorType,
}


def _network_class(kind: str):
    return getattr(dynamic if kind.startswith("Dynamic") else models, kind)


def network(kind: str, nodes, arcs=(), node_types=None, *,
            interface_nodes=None, factor_type=None,
            default_factor_types=None, markovian_order=None, static=None,
            transition=None):
    """The port's network of class name ``kind`` over ``nodes`` with
    ``arcs`` [(source, target)]: any class of ``models`` ("DiscreteBN",
    "GaussianNetwork", "KDENetwork", "SemiparametricBN", "CLGNetwork",
    "HomogeneousBN", "HeterogeneousBN" and their "Conditional*" forms,
    which take ``interface_nodes``) or of ``models.dynamic``.
    ``node_types`` maps node names to type names ("LinearGaussianFactor",
    "CKDEFactor", "DiscreteFactor", "UnknownFactorType"); nodes left out
    keep the network's default. A homogeneous network takes its
    ``factor_type`` name, a heterogeneous one its ``default_factor_types``:
    a list of type names, or {data type: list of type names}.

    A dynamic network ("Dynamic*") takes its variables as ``nodes``, its
    ``markovian_order``, and its ``static`` and ``transition`` networks as
    dicts of this function's arguments (:func:`network_state`'s
    ``static`` and ``transition`` entries)."""
    cls = _network_class(kind)
    if kind.startswith("Dynamic"):
        return cls(list(nodes), int(markovian_order), network(**static),
                   network(**transition))
    head = []
    if factor_type is not None:
        head.append(_NODE_TYPES[factor_type]())
    if default_factor_types is not None:
        head.append(_factor_types(default_factor_types))
    args = [*head, list(nodes)]
    if interface_nodes is not None:
        args.append(list(interface_nodes))
    model = cls(*args, [tuple(a) for a in arcs])
    for node, name in (node_types or {}).items():
        model.set_node_type(node, _NODE_TYPES[name]())
    return model


def _factor_types(spec):
    """A heterogeneous network's default types from their names."""
    if isinstance(spec, dict):
        return {k: [_NODE_TYPES[n]() for n in v] for k, v in spec.items()}
    return [_NODE_TYPES[n]() for n in spec]


def network_args(model) -> dict:
    """The arguments of :func:`network` that rebuild ``model``'s structure,
    for a network of either package (static, conditional or dynamic)."""
    kind = type(model).__name__
    if hasattr(model, "static_bn"):
        return {"kind": kind, "nodes": list(model.variables()),
                "markovian_order": model.markovian_order(),
                "static": network_args(model.static_bn()),
                "transition": network_args(model.transition_bn())}
    nodes = list(model.nodes())
    args = {"kind": kind, "nodes": nodes,
            "arcs": [tuple(a) for a in model.arcs()],
            "node_types": {n: model.node_type(n).ToString() for n in nodes}}
    if hasattr(model, "interface_nodes"):
        args["interface_nodes"] = list(model.interface_nodes())
    bn_type = model.type()
    if hasattr(bn_type, "factor_type"):
        args["factor_type"] = bn_type.factor_type.ToString()
    if hasattr(bn_type, "default_list"):
        if bn_type.default_list is not None:
            args["default_factor_types"] = [
                t.ToString() for t in bn_type.default_list]
        else:
            args["default_factor_types"] = {
                k: [t.ToString() for t in v]
                for k, v in bn_type.default_map.items()}
    return args


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
    """The fitted state of a factor of either package, as numpy and plain
    Python. CKDE: ``evidence``, ``training`` (the joint's (n, 1 + e) rows,
    variable first), ``bandwidth``, ``dtype`` (numpy name of the data type)
    and ``bandwidth_selector`` (class name). Linear-Gaussian: ``evidence``,
    ``beta`` and ``variance``. Discrete: ``discrete``, the factor's own
    pickled state (numpy and plain Python in both packages). A hybrid
    factor (``CLinearGaussianCPD`` or ``HCKDE``): ``adaptator`` (its class
    name), its evidence split into discrete and continuous, each discrete
    parent's values, the cardinalities and strides of the configurations,
    and ``factors``, one base factor's state per configuration, ``None``
    for a configuration left unfitted."""
    kind = type(cpd).__name__
    if kind in _ADAPTATORS:
        state = cpd.__getstate__()
        return {
            "adaptator": kind,
            "evidence": list(state["evidence"]),
            "discrete_evidence": list(state["discrete_evidence"]),
            "continuous_evidence": list(state["continuous_evidence"]),
            "discrete_values": {e: tuple(v) for e, v in
                                state["discrete_values"].items()},
            "cardinality": np.array(state["cardinality"], dtype=np.int64),
            "strides": np.array(state["strides"], dtype=np.int64),
            "factors": [None if f is None else cpd_state(f)
                        for f in state["factors"]],
        }
    if kind == "DiscreteFactor":
        return {"discrete": dict(cpd.__getstate__())}
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
    a :class:`LinearGaussianCPD`, a :class:`DiscreteFactor`, or a hybrid
    factor over the given configurations, each base factor carried the same
    way. Nothing is refitted; a carried hybrid factor that is fitted again
    builds its base factors with their default arguments."""
    if "adaptator" in state:
        cpd = _ADAPTATORS[state["adaptator"]].__new__(
            _ADAPTATORS[state["adaptator"]])
        cpd.__setstate__({
            "variable": variable, "evidence": list(state["evidence"]),
            "args": (), "kwargs": {}, "assignment_args": {}, "fitted": True,
            "discrete_evidence": list(state["discrete_evidence"]),
            "continuous_evidence": list(state["continuous_evidence"]),
            "discrete_values": dict(state["discrete_values"]),
            "cardinality": np.array(state["cardinality"], dtype=np.int64),
            "strides": np.array(state["strides"], dtype=np.int64),
            "factors": [None if f is None else fitted_cpd(variable, f)
                        for f in state["factors"]],
        })
        return cpd
    if "discrete" in state:
        cpd = DiscreteFactor.__new__(DiscreteFactor)
        cpd.__setstate__(dict(state["discrete"]))
        return cpd
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
    either package: :func:`network_args` and every node's
    :func:`cpd_state` (``cpds``); for a dynamic network, each of its
    static and transition networks' own state."""
    if hasattr(model, "static_bn"):
        return {"kind": type(model).__name__,
                "nodes": list(model.variables()),
                "markovian_order": model.markovian_order(),
                "static": network_state(model.static_bn()),
                "transition": network_state(model.transition_bn())}
    args = network_args(model)
    args["cpds"] = {n: cpd_state(model.cpd(n)) for n in args["nodes"]}
    return args


def fitted_network(kind: str, nodes, cpds=None, static=None,
                   transition=None, **structure):
    """The port's fitted network from :func:`network_state`'s dict:
    :func:`network` over its structure, with ``cpds`` ({node:
    :func:`cpd_state` dict}) added as they are. A dynamic network's static
    and transition networks are carried the same way."""
    if static is not None:
        return _network_class(kind)(
            list(nodes), int(structure["markovian_order"]),
            fitted_network(**static), fitted_network(**transition))
    model = network(kind, nodes, **structure)
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


def param_layout(slices, theta, device=None):
    """The port's ``(ParamLayout, theta)`` from a ``make_logdensity``
    layout's ``slices`` ({node: (lo, hi, kind)}) and a flat parameter
    vector ``theta`` (numpy), placed on ``device`` (default: the default
    device) in ``theta``'s dtype."""
    layout = ParamLayout()
    for node, (lo, hi, kind) in sorted(slices.items(),
                                       key=lambda item: item[1][0]):
        if lo != layout.size:
            raise ValueError(f"the slices leave a gap before {node!r}")
        layout.add(node, hi - lo, kind)
    theta = np.asarray(theta)
    if theta.shape != (layout.size,):
        raise ValueError(f"theta has shape {theta.shape}; the layout holds "
                         f"{layout.size} parameters")
    return layout, host_to_device(theta, theta.dtype, device)
