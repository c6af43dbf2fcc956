"""Share of the profiled sub-window in which no operation ran on the
device, in percent: one less the union of the device operations'
intervals over the window, both on the profiler's clock."""


def read(run):
    if run.profile is None:
        return None
    idle = run.profile.idle_share()
    return None if idle is None else idle * 100.0
