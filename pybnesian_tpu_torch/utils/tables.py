"""ASCII table rendering for factor ``ToString`` output — the stand-in for
the reference's vendored libfort tables (DiscreteFactor.cpp:210-280,
DiscreteAdaptator.hpp:359-425 render CPTs and per-assignment factor tables
with ``fort::char_table``)."""

from __future__ import annotations

__all__ = ["char_table"]


def char_table(spans, header, rows) -> str:
    """Render a libfort-style box table.

    ``spans``: optional top header as [(text, ncols), ...] group spans (may
    be None); ``header``: list of column titles; ``rows``: list of cell
    lists. All cells are str()'d and centre-aligned.
    """
    ncols = len(header)
    grid = [[str(c) for c in header]] + [
        [str(c) for c in r] for r in rows
    ]
    widths = [0] * ncols
    for row in grid:
        for j, cell in enumerate(row):
            widths[j] = max(widths[j], len(cell))
    if spans:
        # widen columns so each span title fits its group
        j = 0
        for text, n in spans:
            text = str(text)
            group = sum(widths[j : j + n]) + 3 * (n - 1)
            if len(text) > group:
                extra = len(text) - group
                for k in range(n):
                    widths[j + k] += extra // n + (1 if k < extra % n else 0)
            j += n

    def hline():
        return "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt_row(cells, cell_widths):
        out = "|"
        for cell, w in zip(cells, cell_widths):
            out += " " + str(cell).center(w) + " |"
        return out

    lines = [hline()]
    if spans:
        span_widths = []
        j = 0
        for _, n in spans:
            span_widths.append(sum(widths[j : j + n]) + 3 * (n - 1))
            j += n
        lines.append(fmt_row([t for t, _ in spans], span_widths))
        lines.append(hline())
    lines.append(fmt_row(grid[0], widths))
    lines.append(hline())
    for row in grid[1:]:
        lines.append(fmt_row(row, widths))
    lines.append(hline())
    return "\n".join(lines)
