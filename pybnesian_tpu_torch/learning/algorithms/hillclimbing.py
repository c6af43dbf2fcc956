"""Greedy hill-climbing structure search.

Rebuild of reference learning/algorithms/hillclimbing.{hpp,cpp}. Loop
semantics are copied exactly from ``estimate_hc``
(hillclimbing.hpp:62-199): plain scores stop when the best delta ≤ epsilon;
validated scores track a held-out validation delta with patience ``p``,
a tabu set of operator opposites, an accumulated offset, and rollback to the
best validated model. The scoring inside each iteration is the batched
device path (see operators / Score.local_score_batch). While a profiler
records, a learn is the span ``pb.hc.learn``, its first scores
``pb.hc.cache``, each iteration ``pb.hc.iteration`` (with ``pb.hc.find_max``,
``pb.hc.validate`` and ``pb.hc.update`` inside), and the counter
``hc.iterations`` adds the iterations it ran. The validation cache takes
the first scores in one ``vlocal_score_batch`` call and each iteration's
changed nodes in one more (``LocalScoreCache.update_vlocal_scores``).

Copied from ``pybnesian_tpu/learning/algorithms/hillclimbing.py``.
"""

from __future__ import annotations

import numpy as np

from ...data import DataFrame
from ...runtime.tracing import count, span
from ...utils import MACHINE_TOL
from ..operators import LocalScoreCache, OperatorTabuSet
from ..scores.base import ValidatedScore

__all__ = ["GreedyHillClimbing", "hc"]


def _validation_delta_score(model, score, nodes_changed, local_validation):
    """Σ (new − prev) of the changed nodes' validation scores, in the
    order of ``nodes_changed``; the new scores in one batch."""
    prev = [local_validation.local_score(model, n) for n in nodes_changed]
    local_validation.update_vlocal_scores(model, score, nodes_changed)
    delta = 0.0
    for n, p in zip(nodes_changed, prev):
        delta += local_validation.local_score(model, n) - p
    return delta


def _native_discrete_hc(operators, score, model, max_indegree, max_iters,
                        epsilon):
    """Run the whole hc loop in the native core when the search is a plain
    discrete BIC/BDe ArcOperatorSet climb (the reference's own hc loop is C++,
    hillclimbing.hpp:62-199 + operators.cpp:100-437). Returns the model
    with the learned ops applied, or None when the fast preconditions fail
    (the Python loop runs instead, identical semantics)."""
    from ...models.base import (
        BayesianNetworkType,
        ConditionalBayesianNetwork,
    )
    from ..operators import ArcOperatorSet
    from ..scores import discrete_native
    from ..scores.bde import BDe
    from ..scores.bic import BIC

    if type(score) is BIC:
        score_kind, iss = 0, 1.0
    elif type(score) is BDe:
        score_kind, iss = 1, score.iss
    else:
        return None
    if (
        type(operators) is not ArcOperatorSet
        or isinstance(model, ConditionalBayesianNetwork)
        or not score.native_tier()
    ):
        # on the device's tier the Python loop runs, with or without a
        # callback: one frame, one tier, one learned graph
        return None
    t = model.type()
    try:
        from ...factors.discrete import DiscreteFactorType

        if (
            not t.is_homogeneous()
            or type(t.default_node_type()) is not DiscreteFactorType
            or type(t).can_have_arc is not BayesianNetworkType.can_have_arc
        ):
            return None
    except Exception:
        return None
    nodes = model.nodes()
    d = len(nodes)
    if d == 0 or d > 64:
        return None
    try:
        pos, block, cards = score._native_codes()
        node_cols = np.fromiter((pos[n] for n in nodes), np.int32, d)
    except Exception:
        return None
    # operator-set restriction validation + valid mask, exactly as
    # cache_scores would build it (raises the same errors)
    operators._update_valid_ops(model)
    if operators._sources != nodes or operators._targets != nodes:
        return None
    valid = operators.valid_op.astype(np.uint8)
    idx = {n: i for i, n in enumerate(nodes)}
    adj = np.zeros((d, d), np.uint8)
    for (s, tt) in model.arcs():
        adj[idx[s], idx[tt]] = 1
    ops = discrete_native.hc_discrete(
        block, cards, node_cols, adj, valid, max_indegree, max_iters,
        epsilon, score_kind=score_kind, iss=iss,
    )
    if ops is None:
        return None
    for kind, si, ti in ops.tolist():
        s, tt = nodes[si], nodes[ti]
        if kind == 0:
            model.add_arc_unsafe(s, tt)
        elif kind == 1:
            model.remove_arc(s, tt)
        else:  # FlipArc(s, tt): remove s->tt, add tt->s (legality proven)
            model.remove_arc(s, tt)
            model.add_arc_unsafe(tt, s)
    operators.finished()
    return model


class GreedyHillClimbing:
    """(reference hillclimbing.hpp:316)."""

    def estimate(
        self,
        operators,
        score,
        start,
        arc_blacklist=None,
        arc_whitelist=None,
        type_blacklist=None,
        type_whitelist=None,
        callback=None,
        max_indegree: int = 0,
        max_iters: int = 2147483647,
        epsilon: float = 0.0,
        patience: int = 0,
        seed=None,
        verbose: int = 0,
    ):
        with span("pb.hc.learn"):
            arc_blacklist = list(arc_blacklist or [])
            arc_whitelist = list(arc_whitelist or [])
            type_blacklist = list(type_blacklist or [])
            type_whitelist = list(type_whitelist or [])

            # cross-check restrictions up front (hillclimbing.hpp:292-297)
            if not score.compatible_bn(start):
                raise ValueError(
                    "BayesianNetwork is not compatible with the score."
                )
            from ...utils.validate import (
                validate_arc_restrictions,
                validate_type_restrictions,
            )

            validate_arc_restrictions(start, arc_blacklist, arc_whitelist)
            validate_type_restrictions(start, type_blacklist, type_whitelist)

            from ...utils.progress import spinner

            progress = spinner(verbose)
            progress.update_status("Checking dataset...")

            validated = isinstance(score, ValidatedScore)
            zero_patience = patience == 0

            current_model = start.clone()
            current_model.force_type_whitelist(type_whitelist)
            # resolve unknown node types from score data
            if not current_model.type().is_homogeneous():
                score_data = score.data()
                if score_data is None:
                    raise ValueError(
                        "The score does not have data to detect the node types."
                    )
                current_model.set_unknown_node_types(score_data, type_blacklist)

            _check_blacklist(current_model, arc_blacklist)
            current_model.force_whitelist(arc_whitelist)

            operators.set_arc_blacklist(arc_blacklist)
            operators.set_arc_whitelist(arc_whitelist)
            operators.set_type_blacklist(type_blacklist)
            operators.set_type_whitelist(type_whitelist)
            operators.set_max_indegree(max_indegree)

            if callback is None and patience == 0 and not validated:
                fast = _native_discrete_hc(
                    operators, score, current_model, max_indegree, max_iters,
                    epsilon,
                )
                if fast is not None:
                    progress.mark_as_completed("Finished Hill-climbing!")
                    return fast

            prev_current_model = current_model.clone()
            best_model = current_model

            local_validation = None
            with span("pb.hc.cache"):
                if validated:
                    local_validation = LocalScoreCache()
                    local_validation.cache_vlocal_scores(current_model, score)
                operators.cache_scores(current_model, score)
            p = 0
            accumulated_offset = 0.0
            tabu_set = OperatorTabuSet()

            if callback is not None:
                callback.call(current_model, None, score, 0)

            iteration = 0
            while iteration < max_iters:
                iteration += 1
                with span("pb.hc.iteration"):
                    with span("pb.hc.find_max"):
                        best_op = (
                            operators.find_max(current_model)
                            if zero_patience
                            else operators.find_max_tabu(current_model,
                                                         tabu_set)
                        )
                    if (best_op is None
                            or (best_op.delta() - epsilon) < MACHINE_TOL):
                        break

                    best_op.apply(current_model)
                    nodes_changed = best_op.nodes_changed(current_model)

                    if validated:
                        with span("pb.hc.validate"):
                            validation_delta = _validation_delta_score(
                                current_model, score, nodes_changed,
                                local_validation
                            )
                    else:
                        validation_delta = best_op.delta()

                    if (validation_delta + accumulated_offset) > MACHINE_TOL:
                        if not zero_patience:
                            if p > 0:
                                best_model = current_model
                                p = 0
                                accumulated_offset = 0.0
                            tabu_set.clear()
                    else:
                        if zero_patience:
                            best_model = prev_current_model
                            break
                        else:
                            if p == 0:
                                best_model = prev_current_model.clone()
                            p += 1
                            if p > patience:
                                break
                            accumulated_offset += validation_delta
                            tabu_set.insert(best_op.opposite(current_model))

                    best_op.apply(prev_current_model)

                    if callback is not None:
                        callback.call(current_model, best_op, score,
                                      iteration)

                    with span("pb.hc.update"):
                        operators.update_scores(current_model, score,
                                                nodes_changed)
                    progress.update_status(best_op.ToString())

            count("hc.iterations", iteration)
            operators.finished()
            if callback is not None:
                callback.call(best_model, None, score, iteration)
            progress.mark_as_completed("Finished Hill-climbing!")
            return best_model


def _check_blacklist(model, arc_blacklist):
    for (s, t) in arc_blacklist:
        if model.has_arc(s, t):
            raise ValueError(
                f"Arc {s} -> {t} in blacklist is present in the graph"
            )


def hc(
    df,
    bn_type=None,
    start=None,
    score=None,
    operators=None,
    arc_blacklist=None,
    arc_whitelist=None,
    type_blacklist=None,
    type_whitelist=None,
    callback=None,
    max_indegree: int = 0,
    max_iters: int = 2147483647,
    epsilon: float = 0.0,
    patience: int = 0,
    seed=None,
    num_folds: int = 10,
    test_holdout_ratio: float = 0.2,
    verbose: int = 0,
):
    """Convenience dispatcher with per-BN-type defaults
    (reference hillclimbing.cpp:26-90, util/validate_options.cpp:16-93)."""
    from ...models import GaussianNetworkType
    from .options import check_valid_operators, check_valid_score

    df = DataFrame.wrap(df)
    if bn_type is None and start is None:
        bn_type = GaussianNetworkType()
    if start is None:
        start = bn_type.new_bn(df.column_names())
    else:
        bn_type = start.type()

    score_obj = check_valid_score(
        df,
        bn_type,
        score,
        seed=seed if seed is not None else 0,
        num_folds=num_folds,
        test_holdout_ratio=test_holdout_ratio,
    )
    op_set = check_valid_operators(
        bn_type,
        operators,
        arc_blacklist or [],
        arc_whitelist or [],
        max_indegree,
        type_whitelist or [],
    )
    return GreedyHillClimbing().estimate(
        op_set,
        score_obj,
        start,
        arc_blacklist=arc_blacklist,
        arc_whitelist=arc_whitelist,
        type_blacklist=type_blacklist,
        type_whitelist=type_whitelist,
        callback=callback,
        max_indegree=max_indegree,
        max_iters=max_iters,
        epsilon=epsilon,
        patience=patience,
        seed=seed,
        verbose=verbose,
    )
