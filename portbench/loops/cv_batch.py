"""CV scores of candidate CKDE families, one ``local_score_batch`` a call.

Mix parameters: ``frames`` frames, each with its own ``CVLikelihood``,
their data and fold seeds drawn from the run's seed, or with
``data_seed`` from that fixed stream (where the work of a call depends on
its data, as a UCV search's iterations do, so that every run does the
same work); ``shifts``: a call scores bench.py's 15 families
``families(d, shift)`` of one frame, each pass over the (frame, shift)
pairs in an order drawn from the run's seed; ``selector``:
``normal_reference`` or ``ucv``; ``trace_calls`` calls in the profiled
sub-window; with UCV, ``check_calls`` calls drawn from the seed, every
search of which the reference's objective judges."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import data
from portbench.harness.session import Session, relative
from portbench.reference import ucv
from portbench.reference.family import CKDE, FamilyScores, cv_folds


def families(d, shift):
    """bench.py's 15 candidate families (bench.py:47)."""
    names = [f"x{i}" for i in range(d)]
    fams = []
    for i, v in enumerate(names):
        fams.append((v, []))
        fams.append((v, [names[(i + shift) % d]]))
        fams.append((v, [names[(i + shift) % d],
                         names[(i + shift + 1) % d]]))
    return fams


class CvBatch(Session):
    def setup(self):
        port = self.port
        spec = self.config["data"]
        nf = self.mix["frames"]
        source = self.mix.get("data_seed", self.seed)
        self.columns = [data.frame(spec, source, 1, f) for f in range(nf)]
        self.fold_seeds = [int(data.rng(source, 2, f).integers(2**31))
                           for f in range(nf)]
        self.built = self.build()
        ucv_on = self.mix["selector"] == "ucv"
        args = (port.Arguments({port.CKDEType(): port.Kwargs(
            bandwidth_selector=port.UCV())}) if ucv_on else None)
        self.scores, self.models = [], []
        self.bandwidths = None
        for f in range(nf):
            score = port.CVLikelihood(
                port.DataFrame.wrap(self.columns[f]),
                k=self.config["score"]["folds"], seed=self.fold_seeds[f],
                construction_args=args, device=self.device)
            if ucv_on:
                self._observe_bandwidths(score)
            self.scores.append(score)
            self.models.append(port.KDENetwork(list(self.columns[f])))
        self.d = len(self.columns[0])
        self.ckde = port.CKDEType()
        self.batches = {s: [(v, ps, self.ckde) for v, ps in families(self.d, s)]
                        for s in self.mix["shifts"]}
        first = self.batches[self.mix["shifts"][0]]
        for f in range(nf):
            self.scores[f].local_score_batch(self.models[f], first)
        self.calls = []

    def _observe_bandwidths(self, score):
        """Keep the per-fold UCV bandwidths of each call (what the
        selector returned), as the program's output to judge."""
        engine = score._engine
        select = engine._ucv_bandwidths

        def observed(fams):
            h_maps, searches = select(fams)
            self.bandwidths = h_maps
            return h_maps, searches
        engine._ucv_bandwidths = observed

    def where(self, i):
        """(frame, shift) of call ``i``."""
        nf = len(self.scores)
        shifts = self.mix["shifts"]
        n = nf * len(shifts)
        pair = int(data.rng(self.seed, 5, i // n).permutation(n)[i % n])
        return pair % nf, shifts[pair // nf]

    def call(self, i):
        f, s = self.where(i)
        out = self.scores[f].local_score_batch(self.models[f], self.batches[s])
        self.calls.append((f, s, out, self.bandwidths))
        return len(out)

    def outputs(self):
        """[(frame, shift, scores, UCV bandwidths or None)]."""
        return self.calls

    def pairs_programs(self, i):
        """Kernel #1's programs of a normal-reference call: a family and
        a fold each, its valid train rows against its test rows."""
        if self.mix["selector"] != "normal_reference":
            return None
        n = len(next(iter(self.columns[0].values())))
        folds = cv_folds(n, self.config["score"]["folds"], 0)
        _, s = self.where(i)
        return [(len(tr), len(te), 1 + len(ps), bool(ps))
                for _, ps in families(self.d, s) for tr, te in folds]

    def references(self, dtype=torch.float64):
        cache = {}

        def scores(f):
            if f not in cache:
                n = len(next(iter(self.columns[f].values())))
                cache[f] = FamilyScores(
                    self.reference_columns(self.columns[f]),
                    cv_folds(n, self.config["score"]["folds"],
                             self.fold_seeds[f]), None, dtype)
            return cache[f]
        return scores

    def fold_rows(self, scores, v, ps, k):
        tr, _ = scores.folds[k]
        return scores.matrix(v, ps)[tr]

    def control(self, dtype=torch.bfloat16):
        """One pass over the frames and shifts by the reference in
        ``dtype``, its bandwidths and its scores; with UCV, one call (150
        of its own searches in ``dtype``, to the program's tolerances)."""
        scores = self.references(dtype)
        exact = self.references()
        ucv_on = self.mix["selector"] == "ucv"
        out = []
        for i in range(1 if ucv_on else
                       len(self.scores) * len(self.mix["shifts"])):
            f, s = self.where(i)
            fams = families(self.d, s)
            if ucv_on:
                maps = {}
                for j, (v, ps) in enumerate(fams):
                    maps[j] = []
                    for k in range(len(exact(f).folds)):
                        X = self.fold_rows(exact(f), v, ps, k)
                        L = ucv.invvech(ucv.minimize(X, dtype))
                        maps[j].append(L @ L.T)
                vals = [scores(f).cv(v, ps, CKDE, [torch.as_tensor(
                    h, device=self.device) for h in maps[j]])
                    for j, (v, ps) in enumerate(fams)]
            else:
                maps = None
                vals = [scores(f).cv(v, ps, CKDE) for v, ps in fams]
            out.append((f, s, np.asarray(vals), maps))
        return out

    def check(self, outputs):
        scores = self.references()
        want, rel = {}, 0.0
        for f, s, got, maps in outputs:
            fams = families(self.d, s)
            key = (f, s, None if maps is None else tuple(
                np.asarray(h).tobytes() for j in sorted(maps)
                for h in maps[j]))
            if key not in want:
                want[key] = [
                    scores(f).cv(v, ps, CKDE, None if maps is None else [
                        torch.as_tensor(np.asarray(h), dtype=torch.float64,
                                        device=self.device)
                        for h in maps[j]])
                    for j, (v, ps) in enumerate(fams)]
            for g, w in zip(got, want[key]):
                rel = max(rel, relative(float(g), w))
        numbers = {"score_rel": rel}
        if self.mix["selector"] == "ucv":
            numbers["ucv_descent"] = self.ucv_descent(outputs, scores)
        return numbers

    def ucv_descent(self, outputs, scores):
        """The largest :func:`~portbench.reference.ucv.descent` of the
        program's bandwidths over every (family, fold) search of
        ``check_calls`` calls drawn from the seed, each distinct search
        once."""
        gen = data.rng(self.seed, 4)
        picks = gen.choice(len(outputs), replace=False,
                           size=min(len(outputs), self.mix["check_calls"]))
        seen, worst = set(), 0.0
        for c in sorted(picks.tolist()):
            f, s, _, maps = outputs[c]
            for j, (v, ps) in enumerate(families(self.d, s)):
                for k, H in enumerate(maps[j]):
                    H = np.asarray(H, np.float64)
                    key = (f, v, tuple(ps), k, H.tobytes())
                    if key in seen:
                        continue
                    seen.add(key)
                    X = self.fold_rows(scores(f), v, ps, k)
                    worst = max(worst, ucv.descent(
                        X, ucv.vech(np.linalg.cholesky(H))))
        return worst


SESSION = CvBatch
