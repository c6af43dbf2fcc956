"""Milliseconds per learn outside the score calls: the search's own host
work (operators, tabu, validation bookkeeping), from the window's wall and
the host spans around every score call."""


def read(run):
    if run.spans is None:
        return None
    inside = sum(run.spans.values())
    return (run.window.seconds - inside) / len(run.window.calls) * 1e3
