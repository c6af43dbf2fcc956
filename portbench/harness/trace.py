"""A profiled sub-window: device operations from ``torch.profiler`` (CUPTI),
reduced to the busy time, the time by operation name, and the idle gaps
named by what the host was doing."""

from __future__ import annotations

# the harness's own host spans in a profile start with this
SPAN = "pb."


def merged(intervals):
    """The union of (start, end) intervals as disjoint [start, end]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Profile:
    """The device's operations in a profiled sub-window of ``calls`` calls.
    Times in seconds."""

    def __init__(self, events, calls):
        from torch.autograd import DeviceType

        self.calls = calls
        device, host, spans = [], [], []
        for e in events:
            t = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            if e.device_type == DeviceType.CUDA:
                # the harness's spans show on the device's timeline too
                # (user annotations), as no operation
                if not e.name.startswith(SPAN):
                    device.append((e.name, *t))
            elif e.name.startswith(SPAN + "call"):
                spans.append(t)
            else:
                host.append((e.name, *t, e.thread))
        self.device = device
        # the window: from the start of the first call to the end of the
        # last, on the profiler's own clock
        self.start = min(s for s, _ in spans) if spans else 0.0
        self.end = max(e for _, e in spans) if spans else 0.0
        self.window_s = self.end - self.start
        self.host = host
        self.busy_s = sum(e - s for s, e in merged(
            (max(s, self.start), min(e, self.end)) for _, s, e in device
            if e > self.start and s < self.end))

    def idle_share(self):
        if self.window_s <= 0 or not self.device:
            return None
        return 1.0 - self.busy_s / self.window_s

    def seconds(self, match):
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n))

    def device_ops(self, top=10):
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """[name, seconds]: the device's idle time inside the window,
        grouped by the innermost host operation or span open at each gap's
        middle (``python`` where none is)."""
        busy = merged([(s, e) for _, s, e in self.device])
        gaps, cursor = [], self.start
        for s, e in busy:
            if s > cursor and cursor < self.end:
                gaps.append((cursor, min(s, self.end)))
            cursor = max(cursor, e)
        if cursor < self.end:
            gaps.append((cursor, self.end))
        threads = {}
        for n, s, e, th in self.host:
            threads[th] = threads.get(th, 0) + 1
        main = max(threads, key=threads.get) if threads else None
        events = sorted((s, -e, n) for n, s, e, th in self.host
                        if th == main)
        by, stack, i = {}, [], 0
        for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (g0 + g1) / 2
            while i < len(events) and events[i][0] <= mid:
                s, neg_e, n = events[i]
                while stack and stack[-1][0] <= s:
                    stack.pop()
                stack.append((-neg_e, n))
                i += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            name = stack[-1][1] if stack else "python"
            by[name] = by.get(name, 0.0) + (g1 - g0)
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def span(name):
    """A host span in the profile (``record_function``)."""
    from torch.profiler import record_function

    return record_function(SPAN + name)


def profiled(sync, call, calls):
    """Run ``call(i)`` ``calls`` times under the profiler, each in a
    ``pb.call`` span ending in ``sync()``; returns the :class:`Profile`."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            with span("call"):
                call(i)
                sync()
    return Profile(prof.events(), calls)

