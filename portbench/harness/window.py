"""The closed loop: one caller, the next call when the last has ended."""

from __future__ import annotations

import statistics
import time


class Window:
    """What a measured window did: ``calls`` the wall seconds of each call,
    ``seconds`` from the first call's start to the last one's end, and
    ``work`` the units of work each call did."""

    def __init__(self, calls, seconds, work):
        self.calls = calls
        self.seconds = seconds
        self.work = work

    def rate(self):
        """All the work of the window over all its time."""
        return sum(self.work) / self.seconds

    def percentile(self, q):
        """The q-th percentile of the calls' wall times (``statistics``'
        inclusive quantiles over every call)."""
        if len(self.calls) < 2:
            return self.calls[0]
        cuts = statistics.quantiles(self.calls, n=100, method="inclusive")
        return cuts[q - 1]


def run(sync, call, seconds):
    """Call ``call(i)`` (it returns the units of work it did) back to back
    until ``seconds`` have passed; every call ends in ``sync()``, the
    device's synchronize."""
    calls, work = [], []
    sync()
    start = time.perf_counter()
    i, end = 0, start
    while end - start < seconds:
        t0 = time.perf_counter()
        work.append(call(i))
        sync()
        end = time.perf_counter()
        calls.append(end - t0)
        i += 1
    return Window(calls, end - start, work)
