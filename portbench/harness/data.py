"""The one generator of the benchmark's data: frames of a nonlinear
Gaussian chain, made on the host from a seed.

``x_0 = b`` (or ``b + e_0`` with ``root_noise``), ``x_i = sin(f x_{i-1}) +
s x_{i-1} + e_i``, with ``b ~ N(0, 1)`` and ``e_i ~ N(0, noise_sd^2)``
drawn in that order: with ``root_noise`` it is bench.py's ``make_data``
(bench.py:31), without it config3b's chain
(benchmarks/config3b_logl_evals.py:34-49)."""

from __future__ import annotations

import numpy as np


def rng(seed, *stream):
    """A generator for one stream of a run: the same (seed, stream) gives
    the same draws, any seed up to and past 2**63."""
    return np.random.default_rng([int(seed), *map(int, stream)])


def chain(gen, rows, columns, noise_sd, freq, slope, root_noise):
    """{"x0": ..., "x<columns-1>": ...} float32 columns from ``gen``."""
    base = gen.normal(0.0, 1.0, rows)
    cols = {}
    prev = None
    for i in range(columns):
        if i == 0 and not root_noise:
            x = base
        else:
            noise = gen.normal(0.0, noise_sd, rows)
            x = base + noise if i == 0 else (
                np.sin(freq * prev) + slope * prev + noise)
        cols[f"x{i}"] = x
        prev = x
    return {k: v.astype(np.float32) for k, v in cols.items()}


def frame(data, seed, *stream, rows=None):
    """One frame of the configuration's ``data`` block from (seed, stream):
    ``rows`` overrides the row count."""
    return chain(rng(seed, *stream), rows or data["rows"], data["columns"],
                 data["noise_sd"], data["freq"], data["slope"],
                 data["root_noise"])
