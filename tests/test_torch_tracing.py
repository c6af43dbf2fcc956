"""The port's spans and counters (``runtime/tracing.py``), on the CPU.

With no profiler recording, a tiny ``hc`` with ``ValidatedLikelihood``, a
``CVLikelihood.local_score_batch`` over normal-reference and UCV families
and an ``slogl`` enter no ``record_function`` and count nothing. Under a
CPU ``torch.profiler`` the same calls show the port's span tree, every
span named ``pb.`` and none a name the benchmark's harness keeps for its
own spans, and the counters agree with what the calls returned: the
iterations a callback sees, the families scored, the search's validation
families (all through the hold-out batch, none refitted), the operator
sets' rescoring passes and the cells they rescored, the UCV searches'
evaluations. ``trace`` with a directory writes the Chrome trace and the
counters it counted.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pybnesian_tpu_torch as pt
from pybnesian_tpu_torch import runtime
from pybnesian_tpu_torch.kde.ucv import UCVSearch
from pybnesian_tpu_torch.learning.scores import likelihood
from pybnesian_tpu_torch.runtime import tracing

from data_gen import normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

NODES = ["a", "b", "c", "d"]
# the benchmark harness's own span names
HARNESS = {"pb.score.cv", "pb.score.validation", "pb.score.keep"}
# what a span's nearest enclosing span of the port may be
PARENTS = {
    "pb.hc.learn": {None},
    "pb.hc.cache": {"pb.hc.learn"},
    "pb.hc.iteration": {"pb.hc.learn"},
    "pb.hc.find_max": {"pb.hc.iteration"},
    "pb.hc.validate": {"pb.hc.iteration"},
    "pb.hc.update": {"pb.hc.iteration"},
    "pb.hc.cells": {"pb.hc.cache", "pb.hc.update"},
    "pb.cv.batch": {None, "pb.hc.cache", "pb.hc.update", "pb.hc.cells"},
    "pb.holdout.refit": {None},
    "pb.holdout.batch": {None, "pb.hc.cache", "pb.hc.validate"},
    "pb.holdout.lg": {"pb.holdout.batch"},
    "pb.cv.families": {"pb.cv.batch"},
    "pb.cv.lg": {"pb.cv.batch"},
    "pb.cv.ckde": {"pb.cv.batch"},
    "pb.cv.ckde.pack": {"pb.cv.ckde", "pb.holdout.batch", "pb.ckde.host"},
    "pb.cv.ckde.launch": {"pb.cv.ckde", "pb.holdout.batch",
                          "pb.ckde.host"},
    "pb.ucv.starts": {"pb.cv.ckde"},
    "pb.ucv.pack": {"pb.cv.ckde"},
    "pb.ucv.search": {"pb.cv.ckde"},
    "pb.ucv.unpack": {"pb.cv.ckde"},
    "pb.ckde.host": {"pb.cv.ckde"},
    "pb.score.wait": {"pb.cv.lg", "pb.cv.ckde", "pb.holdout.lg",
                      "pb.holdout.batch", "pb.ckde.host"},
    "pb.factor.wait": {"pb.holdout.refit"},
    "pb.slogl": {None},
    "pb.slogl.ckde.pack": {"pb.slogl"},
    "pb.slogl.ckde": {"pb.slogl"},
    "pb.slogl.lg": {"pb.slogl"},
    "pb.slogl.ckde.whiten": {"pb.slogl.ckde"},
    "pb.slogl.ckde.launch": {"pb.slogl.ckde"},
    "pb.slogl.wait": {"pb.slogl.ckde"},
}


class Iterations:
    """hc callback: the iteration of its last call (the search's end)."""

    def __init__(self):
        self.last = None

    def call(self, model, operator, score, iteration):
        self.last = iteration


def counting_validated_likelihood():
    """A ValidatedLikelihood that counts the families each channel
    returns."""

    class Counting(pt.ValidatedLikelihood):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.returned = {"cv": 0, "holdout": 0}

        def local_score_batch(self, model, families):
            out = super().local_score_batch(model, families)
            self.returned["cv"] += len(out)
            return out

        def local_score_node_type(self, *args):
            self.returned["cv"] += 1
            return super().local_score_node_type(*args)

        def vlocal_score_batch(self, model, families):
            out = super().vlocal_score_batch(model, families)
            self.returned["holdout"] += len(out)
            return out

        def vlocal_score_node_type(self, *args):
            self.returned["holdout"] += 1
            return super().vlocal_score_node_type(*args)

    return Counting


def learn(df):
    """A tiny semiparametric hc with a validation channel, from a network
    with a CKDE node, then one batch of its validation channel and one
    family of it refitted: (the callback, the score; ``score.searched``
    holds what the score had returned when the search ended)."""
    score = counting_validated_likelihood()(df, 0.2, 3, 0)
    seen = Iterations()
    start = pt.SemiparametricBN(NODES, [], [("b", pt.CKDEType())])
    learned = pt.hc(df, start=start, score=score, callback=seen, patience=2,
                    max_iters=6)
    score.searched = dict(score.returned)
    score.vlocal_score_batch(learned, [
        ("b", ["a"], pt.LinearGaussianCPDType()), ("c", [], pt.CKDEType())])
    score.vlocal_score_node_type(learned, pt.CKDEType(), "c", ["b"])
    return seen, score


def ucv_batch(df, monkeypatch):
    """One CV batch of normal-reference and UCV families: (scores, the UCV
    searches it ran)."""
    searches = []
    select = likelihood._KFoldEngine._ucv_bandwidths

    def observed(self, fams):
        h_maps, found = select(self, fams)
        searches.extend(found)
        return h_maps, found

    monkeypatch.setattr(likelihood._KFoldEngine, "_ucv_bandwidths", observed)
    ucv = pt.Arguments({v: pt.Kwargs(bandwidth_selector=pt.UCV())
                        for v in ("b", "c")})
    score = pt.CVLikelihood(df, k=3, seed=1, construction_args=ucv)
    ckde = pt.CKDEType()
    fams = [("a", [], ckde), ("b", ["a"], ckde), ("c", ["b"], ckde),
            ("d", ["c"], ckde), ("a", [], pt.LinearGaussianCPDType())]
    return score.local_score_batch(pt.KDENetwork(NODES), fams), searches


def fitted_spbn(df):
    model = pt.SemiparametricBN(
        NODES, [("a", "b"), ("b", "c"), ("c", "d")],
        [("a", pt.CKDEType()), ("c", pt.CKDEType())])
    model.fit(df)
    return model


@pytest.fixture(scope="module")
def frame():
    return normal_chain_data(120)


@pytest.fixture
def traced(frame, monkeypatch):
    """Every call under one CPU profile: (profiler, counters it left,
    callback, score, UCV searches)."""
    model = fitted_spbn(frame)
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seen, score = learn(frame)
        _, searches = ucv_batch(frame, monkeypatch)
        model.slogl(frame)
    counted = tracing.counters()
    tracing.reset_counters()
    return prof, counted, seen, score, searches


def nearest_port_parent(event):
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith("pb."):
        parent = parent.cpu_parent
    return None if parent is None else parent.name


def test_with_no_profiler_nothing_is_recorded_or_counted(frame, monkeypatch):
    model = fitted_spbn(frame)
    tracing.reset_counters()

    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    assert not tracing.enabled()
    assert tracing.span("pb.hc.learn") is tracing.span("pb.slogl")
    seen, _ = learn(frame)
    scores, searches = ucv_batch(frame, monkeypatch)
    model.slogl(frame)
    with runtime.trace("annotated"):
        tracing.count("hc.iterations", 3)
    assert seen.last >= 1 and len(scores) == 5 and searches
    assert {k: v for k, v in tracing.counters().items()
            if not k.startswith("launches.")} == {}


def test_a_profile_shows_the_span_tree(traced):
    prof = traced[0]
    names = set()
    for event in prof.events():
        if not event.name.startswith("pb."):
            continue
        names.add(event.name)
        assert not event.name.startswith("pb.call"), event.name
        assert event.name not in HARNESS
        assert nearest_port_parent(event) in PARENTS[event.name], (
            event.name, nearest_port_parent(event))
    assert names == set(PARENTS)


def test_the_iterations_are_those_the_callback_sees(traced):
    _, counted, seen, _, _ = traced
    assert counted["hc.iterations"] == seen.last >= 2


def test_the_families_counted_are_those_returned(traced):
    _, counted, _, score, _ = traced
    assert score.returned["cv"] > 0 and score.returned["holdout"] > 0
    # the learn's, and the five of the UCV batch
    assert counted["score.families.cv"] == score.returned["cv"] + 5
    assert counted["score.families.holdout"] == score.returned["holdout"]


def port_ancestors(event):
    names = []
    parent = event.cpu_parent
    while parent is not None:
        if parent.name.startswith("pb."):
            names.append(parent.name)
        parent = parent.cpu_parent
    return names


def test_hc_validates_through_the_holdout_batch(traced):
    """The search's validation scores come from the hold-out batch, in
    its first scores and in each iteration; a continuous family is never
    refitted inside the search (the one refit is the call after it)."""
    prof, counted, seen, score, _ = traced
    inside = {}
    for event in prof.events():
        if event.name in ("pb.holdout.batch", "pb.holdout.refit"):
            where = nearest_port_parent(event)
            inside.setdefault(event.name, set()).add(where)
            if event.name == "pb.holdout.refit":
                assert "pb.hc.learn" not in port_ancestors(event)
    assert inside["pb.holdout.batch"] == {None, "pb.hc.cache",
                                          "pb.hc.validate"}
    assert inside["pb.holdout.refit"] == {None}
    assert counted["hc.validation_batched"] == score.searched["holdout"] > 0
    assert counted["hc.validation_refits"] == 0


def test_a_validated_score_sees_every_validation_family(frame):
    """A ValidatedLikelihood that overrides ``vlocal_score_batch`` sees
    every validation family the search used: every node's in the first
    batch, then each iteration's changed nodes' in one batch each."""

    class Seeing(pt.ValidatedLikelihood):
        def __init__(self, *args):
            super().__init__(*args)
            self.batches = []

        def vlocal_score_batch(self, model, families):
            self.batches.append([(v, tuple(ps)) for v, ps, *_ in families])
            return super().vlocal_score_batch(model, families)

        def vlocal_score_node_type(self, *args):
            raise AssertionError("a validation family refitted")

    class Changed:
        def __init__(self):
            self.families = []

        def call(self, model, operator, score, iteration):
            if operator is not None:
                self.families.append(
                    [(n, tuple(model.parents(n)))
                     for n in operator.nodes_changed(model)])

    start = pt.SemiparametricBN(NODES, [], [("b", pt.CKDEType())])
    changed = Changed()
    score = Seeing(frame, 0.2, 3, 0)
    pt.hc(frame, start=start, score=score, callback=changed, patience=2,
          max_iters=6)
    batches = score.batches
    assert batches[0] == [(n, ()) for n in start.nodes()]
    assert len(changed.families) >= 2
    # a search ended by its patience validated one more step
    assert len(batches) - 1 - len(changed.families) in (0, 1)
    assert batches[1:1 + len(changed.families)] == changed.families


def test_each_rescoring_pass_is_a_span_and_counts_its_cells(frame,
                                                            monkeypatch):
    """Every rescoring pass of the arc and node-type operator sets is one
    ``pb.hc.cells`` span, and ``hc.operator_cells`` adds the cells it was
    given: at the first scores every arc cell (4 x 3) and every node
    (4)."""
    from pybnesian_tpu_torch.learning import operators

    passes = []
    for cls, name in ((operators.ArcOperatorSet, "_recompute_cells"),
                      (operators.ChangeNodeTypeSet, "_recompute_nodes")):
        def seen(self, model, score, cells, _orig=getattr(cls, name)):
            passes.append(len(cells))
            return _orig(self, model, score, cells)
        monkeypatch.setattr(cls, name, seen)
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        learn(frame)
    counted = tracing.counters()
    tracing.reset_counters()
    spans = [e for e in prof.events() if e.name == "pb.hc.cells"]
    assert sorted(passes[:2]) == [4, 12] and len(passes) > 2
    assert len(spans) == len(passes)
    assert counted["hc.operator_cells"] == sum(passes)


def test_the_ucv_counters_sum_the_searches(traced, frame):
    _, counted, _, _, searches = traced
    assert searches and all(isinstance(s, UCVSearch) for s in searches)
    assert counted["ucv.lane_evaluations"] == sum(
        int(s.lane_evaluations.sum()) for s in searches)
    assert counted["ucv.iterations"] == sum(
        int(s.iterations.sum()) for s in searches)
    # two UCV families of width 2, three folds each
    assert counted["ucv.searches"] == 6
    folds = pt.CrossValidation(pt.DataFrame.wrap(frame), 3, 1)
    pairs = [len(folds.fold_indices(k)[0]) for k in range(3)]
    pairs = np.array([n * (n - 1) // 2 for n in pairs] * 2)
    lanes = np.concatenate([s.lane_evaluations for s in searches])
    assert counted["ucv.lane_pairs.d2"] == int((lanes * pairs).sum())


def test_counters_read_the_launch_counts_and_reset():
    from pybnesian_tpu_torch.ops.ucv_search_kernel import ucv_search_cuda

    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("hc.iterations")
        tracing.count("hc.iterations", 2)
    got = tracing.counters()
    assert got["hc.iterations"] == 3
    assert got["launches.ucv_search_cuda"] == ucv_search_cuda.launches
    assert len([k for k in got if k.startswith("launches.")]) == 8
    tracing.reset_counters()
    assert "hc.iterations" not in tracing.counters()


def test_trace_writes_the_counters_beside_the_chrome_trace(frame, tmp_path):
    score = pt.CVLikelihood(frame, k=3, seed=0)
    fams = [("b", ["a"], pt.LinearGaussianCPDType()),
            ("c", [], pt.CKDEType())]
    with runtime.trace("scored", log_dir=str(tmp_path)):
        score.local_score_batch(pt.KDENetwork(NODES), fams)
    assert (tmp_path / "scored.pt.trace.json").stat().st_size > 0
    counted = json.loads((tmp_path / "scored.counters.json").read_text())
    assert counted["score.families.cv"] == 2
    assert counted["launches.ckde_cv_pairs"] == 0
