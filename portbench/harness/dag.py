"""Frames of a seeded semiparametric network over a random DAG, made on
the host.

The structure is drawn once from a seed: the nodes ``x0``...``x<n-1>`` in
topological order, ``arcs`` arcs taken uniformly among the forward pairs
(a pair whose target already has ``max_in_degree`` parents is skipped),
and half the non-root nodes, drawn from the same stream, nonlinear. The
values of a frame come from a stream of their own: a root is N(0, 1); a
node of k parents is ``(1 / sqrt(k)) sum_p g_v(x_p) + N(0, noise_sd^2)``,
``g_v(x) = sin(freq x) + slope x`` at a nonlinear node and
``linear_weight x`` at a linear one. The 8-node chain of
:mod:`~portbench.harness.data` is this rule with one parent a node and
every node nonlinear."""

from __future__ import annotations

import math

import numpy as np

from .data import rng

# the stream of a seed that draws the structure
STRUCTURE = 6


class Dag:
    """The network: ``parents[v]`` the parents of node v (ascending), and
    ``nonlinear`` the nodes whose ``g_v`` is the sine."""

    def __init__(self, parents, nonlinear):
        self.parents = parents
        self.nonlinear = frozenset(nonlinear)

    def arcs(self):
        return [(p, v) for v, ps in enumerate(self.parents) for p in ps]


def structure(data, seed):
    """The :class:`Dag` of the configuration's ``data`` block drawn from
    ``seed``."""
    gen = rng(seed, STRUCTURE)
    n, cap = data["columns"], data["max_in_degree"]
    pairs = [(s, t) for t in range(n) for s in range(t)]
    parents = [[] for _ in range(n)]
    drawn = 0
    for j in gen.permutation(len(pairs)):
        if drawn == data["arcs"]:
            break
        s, t = pairs[j]
        if len(parents[t]) < cap:
            parents[t].append(s)
            drawn += 1
    if drawn < data["arcs"]:
        raise ValueError(f"{data['arcs']} arcs do not fit {n} nodes of "
                         f"in-degree at most {cap}")
    children = [v for v in range(n) if parents[v]]
    nonlinear = gen.choice(children, size=len(children) // 2, replace=False)
    return Dag([sorted(ps) for ps in parents], nonlinear.tolist())


def values(dag, data, gen, rows):
    """{"x0": ..., "x<n-1>": ...} float32 columns of ``rows`` rows from
    ``gen``."""
    cols = []
    for v, ps in enumerate(dag.parents):
        if not ps:
            cols.append(gen.normal(0.0, 1.0, rows))
            continue
        total = np.zeros(rows)
        for p in ps:
            x = cols[p]
            total += (np.sin(data["freq"] * x) + data["slope"] * x
                      if v in dag.nonlinear else data["linear_weight"] * x)
        cols.append(total / math.sqrt(len(ps))
                    + gen.normal(0.0, data["noise_sd"], rows))
    return {f"x{v}": c.astype(np.float32) for v, c in enumerate(cols)}


def frame(data, seed, *stream, rows=None):
    """One frame of the network drawn from ``seed``, its values from the
    stream (seed, *stream); ``rows`` overrides the row count."""
    return values(structure(data, seed), data, rng(seed, *stream),
                  rows or data["rows"])
