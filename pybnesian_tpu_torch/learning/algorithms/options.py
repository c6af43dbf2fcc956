"""String-dispatched score/operator defaults
(reference util/validate_options.cpp:16-93). Copied from
``pybnesian_tpu/learning/algorithms/options.py``."""

from __future__ import annotations

__all__ = ["check_valid_score", "check_valid_operators"]


def check_valid_score(df, bn_type, score, seed=0, num_folds=10,
                      test_holdout_ratio=0.2):
    from ..scores.bic import BIC

    if score is not None:
        if not isinstance(score, str):
            return score  # already a Score instance
        if score == "bic":
            return BIC(df)
        if score == "bge":
            from ..scores.bge import BGe

            return BGe(df)
        if score == "bde":
            from ..scores.bde import BDe

            return BDe(df)
        if score == "cv-lik":
            from ..scores.likelihood import CVLikelihood

            return CVLikelihood(df, num_folds, seed)
        if score == "holdout-lik":
            from ..scores.likelihood import HoldoutLikelihood

            return HoldoutLikelihood(df, test_holdout_ratio, seed)
        if score == "validated-lik":
            from ..scores.likelihood import ValidatedLikelihood

            return ValidatedLikelihood(
                df, test_holdout_ratio, num_folds, seed
            )
        raise ValueError(
            f'Wrong Bayesian Network score "{score}" specified. The possible '
            'alternatives are "bic", "bge", "bde", "cv-lik", "holdout-lik" or '
            '"validated-lik".'
        )

    from ...models import (
        DiscreteBNType,
        GaussianNetworkType,
        KDENetworkType,
        SemiparametricBNType,
    )

    if bn_type == GaussianNetworkType():
        return BIC(df)
    if bn_type in (SemiparametricBNType(), KDENetworkType()):
        from ..scores.likelihood import ValidatedLikelihood

        return ValidatedLikelihood(df, test_holdout_ratio, num_folds, seed)
    if bn_type == DiscreteBNType():
        return BIC(df)
    raise ValueError(f"Default score not defined for {bn_type.ToString()}.")


def check_valid_operators(bn_type, operators, arc_blacklist, arc_whitelist,
                          max_indegree, type_whitelist):
    from ...models import SemiparametricBNType
    from ..operators import ArcOperatorSet, ChangeNodeTypeSet, OperatorPool

    result = []
    if operators:
        for op in operators:
            if not isinstance(op, str):
                result.append(op)
            elif op == "arcs":
                result.append(
                    ArcOperatorSet(arc_blacklist, arc_whitelist, max_indegree)
                )
            elif op == "node_type":
                if bn_type.is_homogeneous():
                    raise ValueError(
                        f'Operator "node_type" is not compatible with '
                        f'Bayesian network type "{bn_type.ToString()}"'
                    )
                result.append(ChangeNodeTypeSet(type_whitelist))
            else:
                raise ValueError(
                    f'Wrong operator set "{op}". Valid choices are: "arcs" '
                    'or "node_type"'
                )
    else:
        result.append(ArcOperatorSet(arc_blacklist, arc_whitelist, max_indegree))
        if bn_type == SemiparametricBNType():
            result.append(ChangeNodeTypeSet(type_whitelist))

    if len(result) == 1:
        return result[0]
    return OperatorPool(result)
