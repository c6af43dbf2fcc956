"""Device milliseconds a call in the UCV search kernel (``ucv_search_f32``,
three launches a call: one a family width), from the profiled
sub-window."""

from portbench.harness import program


def read(run):
    prof = run.profile
    if prof is None:
        return None
    seconds = prof.seconds(program.is_ucv_search_kernel)
    if seconds <= 0:
        return None
    return seconds / prof.calls * 1e3
