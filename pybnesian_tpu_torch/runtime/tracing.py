"""Spans and counters of the port's own phases, and the operator's
profile of a region.

Tracing is on exactly while a ``torch.profiler`` records; nothing else
switches it. Then :func:`span` enters ``torch.profiler.record_function``,
so a phase shows as a host event on the profiler's own clock, beside the
device's operations, and :func:`count` adds to the counters in memory.
With no profiler recording, a span or a count costs one read of
``torch.autograd.profiler._is_profiler_enabled``: no ``record_function``,
no string formatting, no allocation (:func:`span` hands back one shared
null context). A call site whose counter name or value takes work to
compute tests :func:`enabled` first.

Every span name of the port starts with ``pb.``: a profile's reader tells
host annotations from device operations by that prefix, since the
profiler puts annotations on the device's timeline too. By layer:

- search (``learning/algorithms/hillclimbing.py``): ``pb.hc.learn`` (one
  ``estimate``), ``pb.hc.cache`` (the first scores), ``pb.hc.iteration``
  and inside it ``pb.hc.find_max``, ``pb.hc.validate``, ``pb.hc.update``;
  the counters ``hc.iterations``, ``hc.validation_batched`` (validation
  families scored by ``vlocal_score_batch``) and ``hc.validation_refits``
  (those of them refitted for a batch value that was not finite;
  ``learning/operators``); in ``learning/operators``, ``pb.hc.cells`` (an
  operator set's rescoring pass: the arc set's walk of its cells to a
  family list and its fill of the delta matrix, or the node-type set's
  families and type deltas, with the score call nested inside it) and
  the counter ``hc.operator_cells`` (the arc cells and nodes those passes
  rescored, at the first scores and at every update).
- scores (``learning/scores/likelihood.py``): ``pb.cv.batch`` and
  ``pb.holdout.batch`` (a batch of a channel), ``pb.holdout.refit`` (one
  family of the hold-out channel, refitted: in ``hc`` only a family whose
  batch value is not finite), ``pb.cv.families`` (the
  families' node types and selectors), ``pb.cv.lg`` and ``pb.holdout.lg``
  (the LG batches), ``pb.cv.ckde`` (the CV score's CKDE batch),
  ``pb.cv.ckde.pack`` and ``pb.cv.ckde.launch`` (a CKDE batch's columns
  and bandwidths uploaded, then its kernels launched),
  ``pb.ucv.starts``, ``pb.ucv.pack``, ``pb.ucv.search``, ``pb.ucv.unpack``
  (a UCV batch: the normal-reference starts, the search's inputs, the
  search through its read-back, the bandwidths), ``pb.ckde.host`` (CKDE
  families with host bandwidths), ``pb.score.wait`` (a read-back); the
  counters ``score.families.cv``, ``score.families.holdout`` (families
  returned) and ``ucv.searches``, ``ucv.iterations``,
  ``ucv.lane_evaluations``, ``ucv.lane_pairs.d<width>`` (the UCV
  searches' problems, iterations, evaluations, and pairs of rows those
  evaluations summed, of the families the searches gave bandwidths: a
  family left out for a fold of no start is not counted),
  ``ucv.device_starts`` and ``ucv.host_starts`` (the
  problems whose starts and rows ``ucv_starts`` formed by its kernel, or
  by its plain version).
- models and factors (``models/base.py``, ``factors/ckde.py``,
  ``kde/kde.py``): ``pb.slogl`` (one ``slogl`` or ``logl``),
  ``pb.slogl.ckde.pack``, ``pb.slogl.ckde`` and inside it
  ``pb.slogl.ckde.whiten``, ``pb.slogl.ckde.launch``, ``pb.slogl.wait``
  (the CKDE nodes in one launch), ``pb.slogl.lg`` (each factor outside
  that launch), ``pb.factor.wait`` (a fitted KDE's or CKDE's read-back);
  the counters ``slogl.ckde.plan_builds`` and ``slogl.ckde.plan_reuses``
  (a launch's stacked training side of the CKDE factors, built anew or
  kept from an earlier call).

:func:`trace` is the operator's entry point: ``with trace("learn",
log_dir="traces"):`` profiles the region (which turns the spans and
counters on) and writes ``traces/learn.pt.trace.json`` (the Chrome trace)
and ``traces/learn.counters.json`` (what the counters counted in it).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "count", "enabled", "counters", "reset_counters",
           "trace"]

# the one null context every span hands back while no profiler records
_OFF = contextlib.nullcontext()

# counts by name, added to only while a profiler records
_COUNTS: dict[str, int] = {}

# kernel wrappers whose own ``launches`` attribute counts every launch,
# traced or not: (module under pybnesian_tpu_torch, wrapper)
_LAUNCH_COUNTERS = (
    ("ops.ckde_cv_kernel", "ckde_cv_pairs"),
    ("ops.kde_kernel", "kde_logl"),
    ("ops.cv_whiten_kernel", "ckde_cv_whiten"),
    ("ops.cv_whiten_kernel", "ckde_cv_fold_reduce"),
    ("ops.lg_cv_kernel", "lg_cv_stats"),
    ("ops.ucv_kernel", "ucv_pair_sums_cuda"),
    ("ops.ucv_search_kernel", "ucv_search_cuda"),
    ("ops.cv_whiten_kernel", "ucv_starts"),
)


def enabled() -> bool:
    """Whether a profiler records now, so spans and counts are on."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context manager marking a phase of the port as ``name`` (a
    ``pb.`` name): ``record_function(name)`` while a profiler records, a
    shared null context otherwise. Spans nest: a span entered inside
    another is its child in the profile."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict:
    """A snapshot of the counters, with the kernel wrappers' launch counts
    (``launches.<wrapper>``, counted since the process started, traced or
    not) read from their ``launches`` attributes."""
    out = dict(_COUNTS)
    for module, name in _LAUNCH_COUNTERS:
        mod = importlib.import_module("pybnesian_tpu_torch." + module)
        out["launches." + name] = getattr(mod, name).launches
    return out


def reset_counters() -> None:
    """Clears the counters (the launch counts are the wrappers')."""
    _COUNTS.clear()


@contextlib.contextmanager
def trace(name: str, log_dir: str | None = None):
    """Without ``log_dir``, the span ``name``. With ``log_dir``, profiles
    the region (CPU activity, and CUDA activity when a card is visible), so
    the port's spans and counters are on inside it, and writes the Chrome
    trace to ``log_dir/<name>.pt.trace.json`` and what each counter
    counted in the region to ``log_dir/<name>.counters.json``."""
    if log_dir is None:
        with span(name):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = counters()
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
    after = counters()
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))
    counted = {k: v - before.get(k, 0) for k, v in sorted(after.items())}
    with open(os.path.join(log_dir, f"{name}.counters.json"), "w") as f:
        json.dump(counted, f, indent=1)
