"""A semiparametric network over a random DAG, for the torch port's tests
of structure learning beyond a chain: the rule of the benchmark's 46-node
configuration (``portbench/harness/dag.py``) at a test's size."""

import math

import numpy as np
import pandas as pd


def dag_data(n=12, arcs=16, rows=500, seed=0, dtype="float64"):
    """Nodes ``x0``... in topological order, ``arcs`` arcs drawn uniformly
    among the forward pairs with in-degree at most 4; a root N(0, 1), a
    node of k parents ``(1 / sqrt(k)) sum g_v(x_p) + N(0, 0.6^2)``,
    ``g_v(x) = sin(0.8 x) + 0.5 x`` at half the non-root nodes (drawn) and
    ``0.8 x`` at the rest."""
    rng = np.random.default_rng(seed)
    pairs = [(s, t) for t in range(n) for s in range(t)]
    parents = [[] for _ in range(n)]
    drawn = 0
    for j in rng.permutation(len(pairs)):
        s, t = pairs[j]
        if drawn < arcs and len(parents[t]) < 4:
            parents[t].append(s)
            drawn += 1
    children = [v for v in range(n) if parents[v]]
    nonlinear = set(rng.choice(children, size=len(children) // 2,
                               replace=False).tolist())
    cols = []
    for v, ps in enumerate(parents):
        if not ps:
            cols.append(rng.normal(0.0, 1.0, rows))
            continue
        total = sum(np.sin(0.8 * cols[p]) + 0.5 * cols[p]
                    if v in nonlinear else 0.8 * cols[p] for p in ps)
        cols.append(total / math.sqrt(len(ps)) + rng.normal(0.0, 0.6, rows))
    return pd.DataFrame({f"x{v}": c.astype(dtype)
                         for v, c in enumerate(cols)})


def dag_families(widths):
    """``(variable, parents)`` families of ``dag_data``'s columns, one of
    each width: ``x<w>`` with the ``w - 1`` nodes before it, nearest
    first."""
    return [(f"x{w}", [f"x{w - 1 - j}" for j in range(w - 1)])
            for w in widths]
