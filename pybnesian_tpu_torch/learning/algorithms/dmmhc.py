"""DMMHC: dynamic MMHC for dynamic Bayesian networks.

Rebuild of reference learning/algorithms/dmmhc.cpp: MMHC on the static slice
with an intra-order arc blacklist (no arcs from newer to older slices,
dmmhc.cpp:12-31), MMHC-conditional on the transition slice (interface =
slices 1..m), assembled into a DynamicBayesianNetwork (dmmhc.cpp:33-200).

Copied from ``pybnesian_tpu/learning/algorithms/dmmhc.py``.
"""

from __future__ import annotations

from ...models.dynamic import DynamicBayesianNetwork
from ...utils import temporal_names, temporal_slice_names
from .mmhc import MMHC

__all__ = ["DMMHC", "static_blacklist"]


def static_blacklist(variables, markovian_order: int):
    """Arcs newer-slice → older-slice are forbidden in the static BN
    (reference dmmhc.cpp:12-31)."""
    if markovian_order == 1:
        return []
    blacklist = []
    slices = [
        temporal_slice_names(variables, s)
        for s in range(1, markovian_order + 1)
    ]
    for i in range(markovian_order - 1):
        for source in slices[i]:
            for j in range(i + 1, markovian_order):
                for dest in slices[j]:
                    blacklist.append((source, dest))
    return blacklist


class DMMHC:
    def estimate(
        self,
        hypot_test,
        variables=None,
        bn_type=None,
        markovian_order: int = 1,
        operators=None,
        score=None,
        static_callback=None,
        transition_callback=None,
        max_indegree: int = 0,
        max_iters: int = 2147483647,
        epsilon: float = 0.0,
        patience: int = 0,
        alpha: float = 0.05,
        seed=None,
        verbose: int = 0,
    ) -> DynamicBayesianNetwork:
        from ...models import GaussianNetworkType

        if bn_type is None:
            bn_type = GaussianNetworkType()
        if variables is None:
            variables = hypot_test.variable_names()
        if not hypot_test.has_variables(variables):
            raise ValueError(
                "DynamicIndependenceTest do not contain all the variables in "
                "nodes lists."
            )
        mmhc = MMHC()

        static_nodes = temporal_names(variables, 1, markovian_order)
        static_bn = mmhc.estimate(
            hypot_test.static_tests(),
            score=score.static_score() if score is not None else None,
            nodes=static_nodes,
            bn_type=bn_type,
            arc_blacklist=static_blacklist(variables, markovian_order),
            callback=static_callback,
            max_indegree=max_indegree,
            max_iters=max_iters,
            epsilon=epsilon,
            patience=patience,
            alpha=alpha,
            seed=seed,
            verbose=verbose,
        )

        transition_nodes = temporal_names(variables, 0, 0)
        interface_nodes = temporal_names(variables, 1, markovian_order)
        transition_bn = mmhc.estimate_conditional(
            hypot_test.transition_tests(),
            score=score.transition_score() if score is not None else None,
            nodes=transition_nodes,
            interface_nodes=interface_nodes,
            bn_type=bn_type,
            callback=transition_callback,
            max_indegree=max_indegree,
            max_iters=max_iters,
            epsilon=epsilon,
            patience=patience,
            alpha=alpha,
            seed=seed,
            verbose=verbose,
        )
        return DynamicBayesianNetwork(
            list(variables),
            markovian_order,
            static_bn=static_bn,
            transition_bn=transition_bn,
        )
