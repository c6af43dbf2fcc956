"""Inference on a fitted network: ``slogl`` over pre-drawn test frames in
turn.

The configuration's ``model`` block: the arcs (``chain``: x0 -> x1 -> ...),
the CKDE nodes (``even``: x0, x2, ...; the others linear-Gaussian), the
rows of the train frame and of each test frame. Mix parameters: ``tests``
test frames and the train frame, drawn from the fixed stream ``data_seed``
(an ``slogl``'s host time depends on its data, so that every run does the
same work); the run's seed draws the order of the test frames, a new one
for every pass; ``warm`` calls in set-up; ``trace_calls`` calls in the
profiled sub-window. Set-up fits the network on the train frame. A call
counts nodes x test rows evaluations."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import data
from portbench.harness.session import Session, relative
from portbench.reference.family import CKDE, LG
from portbench.reference.kde import algebra_dtype, ckde_logl, normal_reference
from portbench.reference.lg import lg_fit, lg_logl


class Slogl(Session):
    def structure(self):
        """(nodes, {node: parents}, {node: kind}) of the configuration."""
        names = [f"x{i}" for i in range(self.config["data"]["columns"])]
        spec = self.config["model"]
        if (spec["arcs"], spec["ckde_nodes"]) != ("chain", "even"):
            raise ValueError(f"no such network: {spec}")
        parents = {n: (names[i - 1],) if i else () for i, n in enumerate(names)}
        kinds = {n: CKDE if i % 2 == 0 else LG for i, n in enumerate(names)}
        return names, parents, kinds

    def setup(self):
        port = self.port
        spec, model = self.config["data"], self.config["model"]
        fixed = self.mix["data_seed"]
        self.train = data.frame(spec, fixed, 1, rows=model["train_rows"])
        self.tests = [data.frame(spec, fixed, 2, t, rows=model["test_rows"])
                      for t in range(self.mix["tests"])]
        self.built = self.build()
        names, parents, kinds = self.structure()
        self.model = port.SemiparametricBN(
            names, [(p, n) for n in names for p in parents[n]],
            [(n, port.CKDEType()) for n in names if kinds[n] == CKDE])
        self.model.fit(port.DataFrame.wrap(self.train))
        self.frames = [port.DataFrame.wrap(t) for t in self.tests]
        self.values = []
        for i in range(self.mix["warm"]):
            self.call(i)
        self.values = []

    def call(self, i):
        n = len(self.frames)
        t = int(data.rng(self.seed, 5, i // n).permutation(n)[i % n])
        self.values.append((t, float(self.model.slogl(self.frames[t]))))
        return len(self.tests[t]) * len(next(iter(self.tests[t].values())))

    def fitted(self, node):
        """The program's fitted factor of ``node``: (LG, beta, variance)
        or (CKDE, bandwidth over [node, *evidence])."""
        cpd = self.model.cpd(node)
        if cpd.type().ToString() == LG:
            return (LG, np.asarray(cpd.beta, np.float64),
                    float(cpd.variance))
        return (CKDE, np.asarray(cpd.kde_joint().bandwidth, np.float64))

    def outputs(self):
        """({node: fitted factor}, [(test frame, slogl)])."""
        names, _, _ = self.structure()
        return {n: self.fitted(n) for n in names}, list(self.values)

    def pairs_programs(self, i):
        """Kernel #1's programs of a call: one per CKDE node, its train
        rows against the test frame's rows."""
        names, parents, kinds = self.structure()
        ntr = self.config["model"]["train_rows"]
        nte = self.config["model"]["test_rows"]
        return [(ntr, nte, 1 + len(parents[n]), bool(parents[n]))
                for n in names if kinds[n] == CKDE]

    def reference(self, dtype=torch.float64):
        """The reference's fitted factors and each test frame's slogl, the
        rows rounded to ``dtype`` and the fits in its algebra dtype."""
        names, parents, kinds = self.structure()
        tr = self.reference_columns(self.train)
        fits, totals = {}, [0.0] * len(self.tests)
        tests = [self.reference_columns(t) for t in self.tests]
        for n in names:
            cols = (n, *parents[n])
            X = torch.stack([tr[c] for c in cols], dim=1)
            if kinds[n] == LG:
                beta, variance = lg_fit(X[:, 0], X[:, 1:], dtype)
                fits[n] = (LG, beta.cpu().numpy(), variance)
            else:
                H = normal_reference(
                    X.to(dtype).to(algebra_dtype(dtype))).double()
                fits[n] = (CKDE, H.cpu().numpy())
            for t, te in enumerate(tests):
                Y = torch.stack([te[c] for c in cols], dim=1)
                if kinds[n] == LG:
                    ll = lg_logl(Y[:, 0], Y[:, 1:], beta, variance, dtype)
                else:
                    ll = ckde_logl(X, Y, H, dtype)
                totals[t] += float(ll.sum())
        return fits, totals

    def control(self, dtype=torch.bfloat16):
        fits, totals = self.reference(dtype)
        return fits, list(enumerate(totals))

    def check(self, outputs):
        fits, values = outputs
        want_fits, want = self.reference()
        fit_rel = 0.0
        for n, ref in want_fits.items():
            got = fits[n]
            for g, w in zip(got[1:], ref[1:]):
                g, w = np.atleast_1d(g), np.atleast_1d(w)
                scale = float(np.max(np.abs(w)))
                fit_rel = max(fit_rel, float(np.max(np.abs(g - w))) / scale)
        slogl_rel = max(relative(v, want[t]) for t, v in values)
        return {"fit_rel": fit_rel, "slogl_rel": slogl_rel}


SESSION = Slogl
