"""The port's own phases in a traced run: the time of its ``pb.`` host
spans and its counters (``pybnesian_tpu_torch.runtime.tracing``), over
the calls of the profiled sub-window. A program that records none of
them gives None, as a reader returns for a metric it finds nothing of."""

from __future__ import annotations

import bisect

from .trace import merged


def is_wait(name):
    """A span in which the port blocks on the card reading a result back
    (``pb.score.wait``, ``pb.slogl.wait``, ``pb.factor.wait``)."""
    return name.startswith("pb.") and name.endswith(".wait")


def span_ms(run, names, less=None):
    """Milliseconds a call inside the host spans named in ``names`` (a span
    nested in another of them counted once), less the time of the spans
    nested in them whose name ``less`` accepts; on the profiler's clock.
    None without a profile or without such a span."""
    prof = run.profile
    if prof is None:
        return None
    by_thread = {}
    for n, s, e, th in prof.host:
        if n in names:
            by_thread.setdefault(th, []).append((s, e))
    if not by_thread:
        return None
    total = 0.0
    for th, spans in by_thread.items():
        outer = merged(spans)
        total += sum(e - s for s, e in outer)
        if less is None:
            continue
        starts = [s for s, _ in outer]
        for n, s, e, t in prof.host:
            if t == th and less(n):
                i = bisect.bisect_right(starts, s) - 1
                if i >= 0 and e <= outer[i][1]:
                    total -= e - s
    return total / prof.calls * 1e3


def counts(run):
    """The port's counters as the profiled sub-window left them (they count
    only while a profiler records), or None without a profile or without
    the port's tracing module."""
    if run.profile is None:
        return None
    try:
        from pybnesian_tpu_torch.runtime.tracing import counters
    except ImportError:
        return None
    return counters()


def per_call(run, names):
    """The sum of the counters ``names`` a call of the profiled
    sub-window, or None where none of them counted."""
    found = counts(run)
    if not found or not any(n in found for n in names):
        return None
    return sum(found.get(n, 0) for n in names) / run.profile.calls
