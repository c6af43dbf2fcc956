"""Structure learning back to back over any network the configuration
draws, with either of PyBNesian's CV scores: the loop of
``loops/learn.py``, its frames by the configuration's ``data.generator``
(``chain``: :mod:`~portbench.harness.data`; ``dag``:
:mod:`~portbench.harness.dag`, the network drawn from the mix's
``data_seed``) and its score by the mix's ``score``:

- ``validated`` (the default): ``ValidatedLikelihood(df, test_ratio,
  folds, seed)``, a CV channel over the hold-out's training rows and the
  hold-out's validation channel, as ``learn``'s;
- ``cv``: ``CVLikelihood(df, folds, seed)`` over all rows, ``hc``'s
  score ``"cv-lik"``, with no validation channel: ``hc`` takes each
  operator's own delta as its validation delta, so every step improves.
  The reference's search and replay answer their validation scores by
  the CV scores (:class:`CvOnly`), which is that rule.

Every other mix parameter is ``learn``'s. :meth:`LearnNet.pairs_programs`
gives kernel #1's work in the learns of the profiled sub-window."""

from __future__ import annotations

import time

import torch

from portbench.harness import dag, data, program
from portbench.harness.session import relative
from portbench.harness.trace import span
from portbench.loops.learn import Learn
from portbench.reference.family import (CKDE, FamilyScores, cv_folds,
                                        holdout_split)
from portbench.reference.hc import Recorded, replay

GENERATORS = {"chain": data.frame, "dag": dag.frame}


class CvOnly:
    """The scores of a search with no validation channel: each
    validation score is the family's CV score."""

    def __init__(self, scores):
        self.scores = scores

    def cv(self, v, ps, kind):
        return self.scores.cv(v, ps, kind)

    validation = cv

    def scored(self):
        return self.scores.scored()


def recording(base, cv_only):
    """The port's score class ``base`` (``ValidatedLikelihood``, or
    ``CVLikelihood`` with ``cv_only``) keeping what every score call
    returns in ``self.record``, as
    :func:`~portbench.harness.program.recording_validated_likelihood`'s
    record. With ``self.spans`` set, each call's host seconds go to its
    channel in a ``pb.score.<channel>`` span, as that score's, and the
    recording of the call's families runs in a ``pb.score.keep`` span, so
    that a reader can leave the harness's own work out. It takes the
    validated score's arguments; ``cv_only`` drops the hold-out ratio."""

    class Recording(base):
        def __init__(self, df, test_ratio, k, seed, device=None):
            args = (k, seed) if cv_only else (test_ratio, k, seed)
            super().__init__(df, *args, device=device)
            self.record = []
            self.spans = None

        def _scored(self, channel, fn, model, families, one, *args):
            if self.spans is None:
                out = fn(model, *args)
                self._keep(channel, model, families, [out] if one else out)
                return out
            t0 = time.perf_counter()
            try:
                with span("score." + channel):
                    out = fn(model, *args)
            finally:
                self.spans[channel] += time.perf_counter() - t0
            with span("score.keep"):
                self._keep(channel, model, families, [out] if one else out)
            return out

        def _keep(self, channel, model, families, values):
            types = {n: model.node_type(n) for n in model.nodes()}
            self.record.append((channel, list(families), values, types))

        def local_score_batch(self, model, families):
            return self._scored("cv", super().local_score_batch, model,
                                families, False, families)

        def local_score_node_type(self, model, node_type, variable, parents):
            return self._scored("cv", super().local_score_node_type, model,
                                [(variable, parents, node_type)], True,
                                node_type, variable, parents)

        if not cv_only:
            def vlocal_score_batch(self, model, families):
                return self._scored("validation", super().vlocal_score_batch,
                                    model, families, False, families)

            def vlocal_score_node_type(self, model, node_type, variable,
                                       parents):
                return self._scored("validation",
                                    super().vlocal_score_node_type, model,
                                    [(variable, parents, node_type)], True,
                                    node_type, variable, parents)

    return Recording


class LearnNet(Learn):
    def setup(self):
        port = self.port
        spec, pool = self.config["data"], self.mix["pool"]
        fixed = self.mix["data_seed"]
        self.cv_only = self.mix.get("score", "validated") == "cv"
        make = GENERATORS[spec["generator"]]
        self.columns = []
        for f in range(pool):
            cols = make(spec, fixed, 1, f)
            names = list(cols)
            order = data.rng(self.seed, 1, f).permutation(len(names))
            self.columns.append({names[j]: cols[names[j]] for j in order})
        self.frame_seeds = [int(data.rng(fixed, 2, f).integers(2**31))
                            for f in range(pool)]
        self.frames = [port.DataFrame.wrap(c) for c in self.columns]
        self.built = self.build()
        self.Score = recording(port.CVLikelihood if self.cv_only
                               else port.ValidatedLikelihood, self.cv_only)
        self.learns = []
        self.spans = program.spans() if self.trace else None
        for i in range(self.mix["warm"]):
            self.call(i)
        self.learns = []
        if self.spans is not None:
            self.spans = program.spans()

    def rows(self, f):
        return len(next(iter(self.columns[f].values())))

    def references(self, dtype=torch.float64):
        if not self.cv_only:
            return super().references(dtype)
        cache = {}

        def scores(f):
            if f not in cache:
                folds = cv_folds(self.rows(f), self.config["learn"]["folds"],
                                 self.frame_seeds[f])
                cache[f] = CvOnly(FamilyScores(
                    self.reference_columns(self.columns[f]), folds, None,
                    dtype))
            return cache[f]
        return scores

    def check(self, outputs):
        """``learn``'s check, with the recorded scores answering the
        replay's validation scores by their CV scores where the score has
        no validation channel."""
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
            recorded = Recorded(scored)
            if self.cv_only:
                recorded = CvOnly(recorded)
            if not replay(recorded, list(self.columns[f]), ops, returned,
                          learn["patience"], learn["max_iters"]):
                mismatched += 1
        return {"score_rel": rel, "search_mismatch": float(mismatched)}

    def pairs_programs(self, i):
        """Kernel #1's programs in the ``i``-th learn of the profiled
        sub-window (the last ``trace_calls`` learns): for every CKDE family
        the learn scored, one a fold of the CV channel and one of the
        hold-out channel, each (train rows, test rows, the family's own
        width, has evidence), the width unpadded."""
        learn = self.config["learn"]
        f, _, _, record = self.learns[i - self.mix["trace_calls"]]
        n = self.rows(f)
        shapes = {}
        if not self.cv_only:
            tr, te = holdout_split(n, learn["test_ratio"], 0)
            shapes["validation"] = [(len(tr), len(te))]
            n = len(tr)
        shapes["cv"] = [(len(tr), len(te))
                        for tr, te in cv_folds(n, learn["folds"], 0)]
        return [(ntr, nte, 1 + len(ps), bool(ps))
                for channel, _, ps, kind, _ in program.scored(record)
                if kind == CKDE for ntr, nte in shapes[channel]]


SESSION = LearnNet
