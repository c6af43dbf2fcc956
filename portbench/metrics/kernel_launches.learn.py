"""Hand-kernel launches per learn: the wrappers' launch counters over the
window, per learn."""


def read(run):
    total = sum(run.launches.values())
    return total / len(run.window.calls)
