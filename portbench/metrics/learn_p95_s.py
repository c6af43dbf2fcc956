"""95th percentile of one learn's wall seconds, over every learn of the
window."""


def read(run):
    return run.window.percentile(95)
