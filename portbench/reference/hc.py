"""Greedy hill-climbing of a semiparametric network with a validation
channel, as PyBNesian defines it (``GreedyHillClimbing::estimate`` over
arc and node-type operators, patience, a tabu set of opposites and the
best validated model kept aside).

Two uses: :func:`search` runs the whole search from the empty graph with
every node linear-Gaussian (the control runs it in bfloat16), and
:func:`replay` follows a search that the program ran, operator by
operator, on the program's own scores, and says whether every choice,
every validation verdict and the returned network are the ones the
loop's rules give on those scores. The scores themselves are held to the
reference's apart (``loops/learn.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .family import CKDE, LG

# the program stops when the best delta is below this (PyBNesian's
# MACHINE_TOL)
MACHINE_TOL = 2.220446049250313e-16 * 4
# two deltas this close are a tie: the program rounds each delta to 1e-9
TIE = 2e-9
OTHER = {LG: CKDE, CKDE: LG}


@dataclass
class Model:
    nodes: list
    parents: dict
    types: dict

    @classmethod
    def empty(cls, nodes):
        return cls(list(nodes), {n: () for n in nodes}, {n: LG for n in nodes})

    def copy(self):
        return Model(self.nodes, dict(self.parents), dict(self.types))

    def key(self):
        return (frozenset((p, n) for n in self.nodes for p in self.parents[n]),
                tuple(sorted(self.types.items())))

    def has_path(self, a, b, skip=None):
        """Whether a directed path leads from ``a`` to ``b``, leaving out
        the arc ``skip``."""
        children = {n: [] for n in self.nodes}
        for n in self.nodes:
            for p in self.parents[n]:
                if (p, n) != skip:
                    children[p].append(n)
        stack, seen = [a], {a}
        while stack:
            x = stack.pop()
            if x == b:
                return True
            for c in children[x]:
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return False

    def apply(self, op):
        kind, a, b = op
        if kind == "add":
            self.parents[b] = (*self.parents[b], a)
        elif kind == "remove":
            self.parents[b] = tuple(p for p in self.parents[b] if p != a)
        elif kind == "flip":
            self.parents[b] = tuple(p for p in self.parents[b] if p != a)
            self.parents[a] = (*self.parents[a], b)
        else:
            self.types[a] = b

    def changed(self, op):
        kind, a, b = op
        return [b] if kind in ("add", "remove") else (
            [a, b] if kind == "flip" else [a])

    def opposite(self, op):
        """The tabu entry of ``op``, taken on the model after it."""
        kind, a, b = op
        if kind == "add":
            return ("remove", a, b)
        if kind == "remove":
            return ("add", a, b)
        if kind == "flip":
            return ("flip", b, a)
        return ("type", a, self.types[a])


def candidates(model, scores):
    """{operator: delta} of every legal operator on ``model`` by the CV
    scores: arcs added, removed and flipped (no cycle), node types
    changed."""
    local = {n: scores.cv(n, model.parents[n], model.types[n])
             for n in model.nodes}
    out = {}
    for t in model.nodes:
        pa = model.parents[t]
        for s in model.nodes:
            if s == t:
                continue
            if s in pa:
                out[("remove", s, t)] = scores.cv(
                    t, tuple(p for p in pa if p != s), model.types[t]) - local[t]
                if not model.has_path(s, t, skip=(s, t)):
                    out[("flip", s, t)] = (
                        scores.cv(s, (*model.parents[s], t), model.types[s])
                        + scores.cv(t, tuple(p for p in pa if p != s),
                                    model.types[t])
                        - local[s] - local[t])
            elif t not in model.parents[s] and not model.has_path(t, s):
                out[("add", s, t)] = scores.cv(
                    t, (*pa, s), model.types[t]) - local[t]
        other = OTHER[model.types[t]]
        out[("type", t, other)] = scores.cv(t, pa, other) - local[t]
    return out


def validation_delta(before, after, op, scores):
    return sum(scores.validation(n, after.parents[n], after.types[n])
               - scores.validation(n, before.parents[n], before.types[n])
               for n in after.changed(op))


@dataclass
class State:
    """The loop's state between two steps: the current model, the best
    validated model (None while it is the current one), the patience
    count, the accumulated validation offset and the tabu set."""

    model: Model
    best: Model | None = None
    p: int = 0
    offset: float = 0.0
    tabu: set = field(default_factory=set)

    def returned(self):
        return self.model if self.best is None else self.best

    def step(self, op, vdelta, improved, patience):
        """Apply ``op`` with validation delta ``vdelta`` judged
        ``improved``; False when the loop breaks on patience."""
        before = self.model.copy()
        self.model.apply(op)
        if improved:
            if self.p > 0:
                self.best, self.p, self.offset = None, 0, 0.0
            self.tabu.clear()
            return True
        if self.p == 0:
            self.best = before
        self.p += 1
        if self.p > patience:
            return False
        self.offset += vdelta
        self.tabu.add(self.model.opposite(op))
        return True


def best_of(cands, tabu):
    legal = {op: d for op, d in cands.items() if op not in tabu}
    if not legal:
        return None, -math.inf
    op = max(legal, key=legal.get)
    return op, legal[op]


def search(scores, nodes, patience, max_iters):
    """The whole search: ([operators reported step by step], the returned
    model). Operators are (kind, a, b) tuples: ("add", s, t), ("remove",
    s, t), ("flip", s, t) for the arc s -> t, ("type", node, new kind)."""
    st = State(Model.empty(nodes))
    ops = []
    for _ in range(max_iters):
        op, delta = best_of(candidates(st.model, scores), st.tabu)
        if op is None or delta < MACHINE_TOL:
            break
        after = st.model.copy()
        after.apply(op)
        vd = validation_delta(st.model, after, op, scores)
        if not st.step(op, vd, vd + st.offset > MACHINE_TOL, patience):
            break
        ops.append(op)
    return ops, st.returned()


class Missing(KeyError):
    """A family the search needed and the program never scored."""


class Recorded:
    """The scores a program returned during one search, by family: what
    :func:`replay` judges the search by."""

    def __init__(self, scored):
        self.values = {(channel, v, frozenset(ps), kind): value
                       for channel, v, ps, kind, value in scored}

    def _get(self, channel, v, ps, kind):
        key = (channel, v, frozenset(ps), kind)
        if key not in self.values:
            raise Missing(key)
        return self.values[key]

    def cv(self, v, ps, kind):
        return self._get("cv", v, ps, kind)

    def validation(self, v, ps, kind):
        return self._get("validation", v, ps, kind)


def replay(scores, nodes, ops, returned, patience, max_iters):
    """Whether a search that the program ran follows the loop's rules on
    its own scores: ``scores`` the :class:`Recorded` scores, ``ops`` the
    operators it reported, ``returned`` the Model it returned. At every
    step the chosen operator is a legal one, not tabu, whose delta lies
    within :data:`TIE` of the best legal delta and above zero; the
    validation verdicts, the patience, the tabu set and the model kept
    aside follow from its validation scores; the search ends where the
    rules end it, on the model they return. False too where the search
    needed the score of a family the program never scored."""
    st = State(Model.empty(nodes))
    try:
        for i, op in enumerate(ops[:max_iters]):
            cands = candidates(st.model, scores)
            _, d_best = best_of(cands, st.tabu)
            if op not in cands or op in st.tabu:
                return False
            if cands[op] < d_best - TIE or cands[op] < -TIE:
                return False
            after = st.model.copy()
            after.apply(op)
            vd = validation_delta(st.model, after, op, scores)
            if not st.step(op, vd, vd + st.offset > MACHINE_TOL, patience):
                return False  # the program went on after a break
        if len(ops) > max_iters:
            return False
        want = returned.key()
        op_best, d_best = best_of(candidates(st.model, scores), st.tabu)
        if len(ops) == max_iters or d_best <= TIE:
            if st.returned().key() == want:
                return True
        # a break on patience after one more (unreported) operator
        if op_best is None or st.p != patience or d_best < -TIE:
            return False
        after = st.model.copy()
        after.apply(op_best)
        vd = validation_delta(st.model, after, op_best, scores)
        if vd + st.offset > MACHINE_TOL:
            return False
        st.step(op_best, vd, False, patience)
        return st.returned().key() == want
    except Missing:
        return False
