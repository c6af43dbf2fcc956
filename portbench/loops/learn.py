"""Structure learning back to back: ``hc`` over a pool of frames, one
learned network a call.

Mix parameters: ``pool`` frames and their fold seeds, drawn from the
fixed stream ``data_seed``, so that every run learns the same networks
(the work of a learn depends on its data); the run's seed draws the order
of the frames, a new one for every pass over the pool, and each frame's
column order; ``warm`` learns in set-up; ``check`` learns compared with
the reference after the window (drawn from the seed, with the one of the
most steps); ``trace_calls`` learns in the profiled sub-window. The
configuration's ``learn`` block gives the score's hold-out ratio and
folds, the patience and the iteration cap."""

from __future__ import annotations

import torch

from portbench.harness import data, program
from portbench.harness.session import Session, relative
from portbench.reference.family import FamilyScores, cv_folds, holdout_split
from portbench.reference.hc import Model, Recorded, replay, search


class Recorder:
    """hc callback: the operators of a search, in order."""

    def __init__(self):
        self.ops = []

    def call(self, model, operator, score, iteration):
        if operator is not None:
            self.ops.append(operator)


def as_model(nodes, bn):
    """A returned network of the program as the reference's Model."""
    parents = {n: tuple(bn.parents(n)) for n in nodes}
    return Model(list(nodes), parents,
                 {n: bn.node_type(n).ToString() for n in nodes})


class Learn(Session):
    def setup(self):
        port = self.port
        spec, pool = self.config["data"], self.mix["pool"]
        fixed = self.mix["data_seed"]
        self.columns = []
        for f in range(pool):
            cols = data.frame(spec, fixed, 1, f)
            names = list(cols)
            order = data.rng(self.seed, 1, f).permutation(len(names))
            self.columns.append({names[j]: cols[names[j]] for j in order})
        self.frame_seeds = [int(data.rng(fixed, 2, f).integers(2**31))
                            for f in range(pool)]
        self.frames = [port.DataFrame.wrap(c) for c in self.columns]
        self.built = self.build()
        self.Score = program.recording_validated_likelihood()
        self.learns = []
        self.spans = program.spans() if self.trace else None
        for i in range(self.mix["warm"]):
            self.call(i)
        self.learns = []
        if self.spans is not None:
            self.spans = program.spans()

    def frame_of(self, i):
        """The frame of call ``i``: pass i // pool over the frames, in an
        order drawn from the seed for that pass."""
        pool = len(self.frames)
        order = data.rng(self.seed, 5, i // pool).permutation(pool)
        return int(order[i % pool])

    def call(self, i):
        port = self.port
        learn = self.config["learn"]
        f = self.frame_of(i)
        fseed = self.frame_seeds[f]
        score = self.Score(self.frames[f], learn["test_ratio"],
                           learn["folds"], fseed, device=self.device)
        score.spans = self.spans
        recorder = Recorder()
        returned = port.hc(self.frames[f],
                           bn_type=port.SemiparametricBNType(), score=score,
                           callback=recorder, seed=fseed,
                           patience=learn["patience"],
                           max_iters=learn["max_iters"])
        self.learns.append((f, recorder.ops, returned, score.record))
        return 1

    def outputs(self):
        """[(frame, [operators], returned Model, [scored families])]."""
        return [(f, [program.op_tuple(op) for op in ops],
                 as_model(list(self.columns[f]), bn), program.scored(record))
                for f, ops, bn, record in self.learns]

    def references(self, dtype=torch.float64):
        cache = {}

        def scores(f):
            if f not in cache:
                learn = self.config["learn"]
                n = len(next(iter(self.columns[f].values())))
                tr, te = holdout_split(n, learn["test_ratio"],
                                       self.frame_seeds[f])
                folds = [(tr[a], tr[b]) for a, b in
                         cv_folds(len(tr), learn["folds"],
                                  self.frame_seeds[f])]
                cache[f] = FamilyScores(
                    self.reference_columns(self.columns[f]), folds, (tr, te),
                    dtype)
            return cache[f]
        return scores

    def control(self, dtype=torch.bfloat16):
        """The reference's search in ``dtype`` on the frames of the first
        ``check`` calls, with the scores it used."""
        scores = self.references(dtype)
        learn = self.config["learn"]
        out = []
        for f in map(self.frame_of, range(self.mix["check"])):
            s = scores(f)
            ops, returned = search(s, list(self.columns[f]),
                                   learn["patience"], learn["max_iters"])
            out.append((f, ops, returned, s.scored()))
        return out

    def check(self, outputs):
        n = len(outputs)
        gen = data.rng(self.seed, 3)
        picks = set(gen.choice(n, size=min(n, self.mix["check"]),
                               replace=False).tolist())
        picks.add(max(range(n), key=lambda i: len(outputs[i][1])))
        scores = self.references()
        learn = self.config["learn"]
        rel, mismatched = 0.0, 0
        for i in sorted(picks):
            f, ops, returned, scored = outputs[i]
            scored = list(scored)
            s = scores(f)
            for channel, v, ps, kind, value in scored:
                want = (s.cv(v, ps, kind) if channel == "cv"
                        else s.validation(v, ps, kind))
                rel = max(rel, relative(value, want))
            if not replay(Recorded(scored), list(self.columns[f]), ops,
                          returned, learn["patience"], learn["max_iters"]):
                mismatched += 1
        return {"score_rel": rel, "search_mismatch": float(mismatched)}


SESSION = Learn
