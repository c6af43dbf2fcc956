"""MMHC: MMPC skeleton restriction + greedy hill-climbing.

Rebuild of reference learning/algorithms/mmhc.cpp (246 LoC): the MMPC CPC
sets (symmetry-corrected) blacklist every arc outside the skeleton; greedy
hill-climbing then searches inside it.

Copied from ``pybnesian_tpu/learning/algorithms/mmhc.py``.
"""

from __future__ import annotations

from ...data import DataFrame
from ...models.base import ConditionalBayesianNetwork
from .hillclimbing import GreedyHillClimbing
from .mmpc import mmpc_all_variables

__all__ = ["MMHC"]


def _hc_blacklist(nodes, cpcs):
    """(reference create_hc_blacklist, mmhc.cpp:24-43)."""
    blacklist = []
    names = list(nodes)
    for i in range(len(names) - 1):
        for j in range(i + 1, len(names)):
            a, b = names[i], names[j]
            if b not in cpcs[a]:
                blacklist.append((a, b))
                blacklist.append((b, a))
    return blacklist


class MMHC:
    def estimate(
        self,
        hypot_test,
        operators=None,
        score=None,
        nodes=None,
        bn_type=None,
        arc_blacklist=None,
        arc_whitelist=None,
        edge_blacklist=None,
        edge_whitelist=None,
        type_blacklist=None,
        type_whitelist=None,
        callback=None,
        max_indegree: int = 0,
        max_iters: int = 2147483647,
        epsilon: float = 0.0,
        patience: int = 0,
        alpha: float = 0.05,
        seed=None,
        num_folds: int = 10,
        test_holdout_ratio: float = 0.2,
        verbose: int = 0,
    ):
        from ...models import GaussianNetworkType
        from .options import check_valid_operators, check_valid_score

        if bn_type is None:
            bn_type = GaussianNetworkType()
        if nodes is None:
            nodes = hypot_test.variable_names()
        if not hypot_test.has_variables(nodes):
            raise ValueError(
                "IndependenceTest do not contain all the variables in nodes "
                "list."
            )
        bn = bn_type.new_bn(list(nodes))
        # normalize + cross-check the restriction lists before the skeleton
        # search (reference mmhc.cpp:113-115)
        from ...utils.validate import (
            validate_restrictions,
            validate_type_restrictions,
        )

        r = validate_restrictions(
            bn, arc_blacklist, arc_whitelist, edge_blacklist, edge_whitelist
        )
        validate_type_restrictions(bn, type_blacklist, type_whitelist)
        arc_whitelist = sorted(r.arc_whitelist)
        cpcs = mmpc_all_variables(
            hypot_test, list(nodes), alpha, r.arc_whitelist,
            r.edge_blacklist, r.edge_whitelist, verbose=verbose,
        )
        skeleton_blacklist = _hc_blacklist(nodes, cpcs)
        total_blacklist = list(arc_blacklist or []) + skeleton_blacklist

        if score is None or isinstance(score, str):
            if score is None and hasattr(hypot_test, "df"):
                df = hypot_test.df
            else:
                df = getattr(hypot_test, "df", None)
            score = check_valid_score(
                df, bn_type, score, seed=seed or 0, num_folds=num_folds,
                test_holdout_ratio=test_holdout_ratio,
            )
        op_set = check_valid_operators(
            bn_type, operators, total_blacklist, arc_whitelist, max_indegree,
            type_whitelist or [],
        )
        return GreedyHillClimbing().estimate(
            op_set,
            score,
            bn,
            arc_blacklist=total_blacklist,
            arc_whitelist=arc_whitelist,
            type_blacklist=type_blacklist,
            type_whitelist=type_whitelist,
            callback=callback,
            max_indegree=max_indegree,
            max_iters=max_iters,
            epsilon=epsilon,
            patience=patience,
            verbose=verbose,
        )

    def estimate_conditional(
        self,
        hypot_test,
        operators=None,
        score=None,
        nodes=None,
        interface_nodes=None,
        bn_type=None,
        arc_blacklist=None,
        arc_whitelist=None,
        edge_blacklist=None,
        edge_whitelist=None,
        type_blacklist=None,
        type_whitelist=None,
        callback=None,
        max_indegree: int = 0,
        max_iters: int = 2147483647,
        epsilon: float = 0.0,
        patience: int = 0,
        alpha: float = 0.05,
        seed=None,
        num_folds: int = 10,
        test_holdout_ratio: float = 0.2,
        verbose: int = 0,
    ):
        from ...models import GaussianNetworkType
        from .options import check_valid_operators, check_valid_score

        if bn_type is None:
            bn_type = GaussianNetworkType()
        interface_nodes = list(interface_nodes or [])
        if nodes is None:
            raise ValueError("estimate_conditional requires nodes")
        bn = bn_type.new_cbn(list(nodes), interface_nodes)
        from ...utils.validate import (
            validate_restrictions,
            validate_type_restrictions,
        )

        r = validate_restrictions(
            bn, arc_blacklist, arc_whitelist, edge_blacklist, edge_whitelist
        )
        validate_type_restrictions(bn, type_blacklist, type_whitelist)
        arc_whitelist = sorted(r.arc_whitelist)
        all_names = list(nodes) + interface_nodes
        cpcs = mmpc_all_variables(
            hypot_test, all_names, alpha, r.arc_whitelist, r.edge_blacklist,
            r.edge_whitelist, interface_nodes=interface_nodes,
            verbose=verbose,
        )
        blacklist = []
        names = list(nodes)
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                a, b = names[i], names[j]
                if b not in cpcs[a]:
                    blacklist.append((a, b))
                    blacklist.append((b, a))
            for itf in interface_nodes:
                if itf not in cpcs[names[i]]:
                    blacklist.append((itf, names[i]))
        total_blacklist = list(arc_blacklist or []) + blacklist

        if score is None or isinstance(score, str):
            df = getattr(hypot_test, "df", None)
            score = check_valid_score(
                df, bn_type, score, seed=seed or 0, num_folds=num_folds,
                test_holdout_ratio=test_holdout_ratio,
            )
        op_set = check_valid_operators(
            bn_type, operators, total_blacklist, arc_whitelist, max_indegree,
            type_whitelist or [],
        )
        return GreedyHillClimbing().estimate(
            op_set,
            score,
            bn,
            arc_blacklist=total_blacklist,
            arc_whitelist=arc_whitelist,
            type_blacklist=type_blacklist,
            type_whitelist=type_whitelist,
            callback=callback,
            max_indegree=max_indegree,
            max_iters=max_iters,
            epsilon=epsilon,
            patience=patience,
            verbose=verbose,
        )
