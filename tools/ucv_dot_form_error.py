#!/usr/bin/env python3
"""How many digits the dot-product form of the UCV distances loses, on the
CPU in numpy (no GPU needed).

    python3 tools/ucv_dot_form_error.py

The UCV kernel (``csrc/ucv_pairs.cu``) forms each pair's exponent (minus
the distance in log2 units) up to 16 columns in the dot-product form, d + 1
FP32 instructions a pair: per-row biases b_i = -s |w_i|^2 and y_ij = b_i
+ b_j + sum_c (2 s w_ic) w_jc, with s = log2(e) / 4 and w the rows less an
origin, which each block takes at the first valid row of its row tile of
256; the difference form takes 2d. This script emulates both forms in
float32 (each operation rounded to float32, an FMA's product kept exact)
on bench.py's data (``chip_smoke.make_data``: 3 columns, the first 4,000
of 9,000 rows), whitened by the normal-reference bandwidth times each of
``chip_smoke.UCV_FACTORS_CHECKED`` (phase 9's searches start near 1 and
print the range of factors they visit beside these), and prints each
form's relative error of the two sums against float64 — the dot form with
the rows as they are, moved to their first row, and moved, per row tile
of 256, to the tile's first row, as the kernel does; first the same at
the normal-reference bandwidth on 4,000 normal rows whose mean lies 50,
-30 and 10 standard deviations out. Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCALE = math.log2(math.e) / 4.0
TILE = 256  # rows of the kernel's row tile, one origin each


def f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def pair_sums(white, form, tile_origin=False):
    """(relative error of s2h, of sh) of the float32 form against float64
    over the pairs i < j of ``white`` (N, d) float32; with
    ``tile_origin``, the rows of each row tile and every column moved to
    the tile's first row before the dot form."""
    N, d = white.shape
    w64 = white.astype(np.float64)
    exact = np.zeros(2)
    approx = np.zeros(2)
    sc = f32(math.sqrt(SCALE))
    for a in range(0, N, TILE):
        rows = slice(a, min(a + TILE, N))
        upper = np.arange(a, rows.stop)[:, None] < np.arange(N)[None, :]
        e = np.exp(-0.25 * ((w64[rows, None, :] - w64[None]) ** 2).sum(-1))
        exact += [(e * upper).sum(), (e * e * upper).sum()]
        if form == "difference":
            ws, xs = f32(white[rows] * sc), f32(white * sc)
            y = np.zeros((rows.stop - a, N), np.float32)
            for c in range(d):
                df = f32(ws[:, None, c].astype(np.float64) - xs[None, :, c])
                y = f32(y - df.astype(np.float64) * df)
        else:
            moved = f32(white - white[a]) if tile_origin else white
            m64 = moved.astype(np.float64)
            bias = f32(-(m64 ** 2).sum(1) * SCALE)
            u = f32(2.0 * SCALE * m64)
            y = f32(bias[rows, None].astype(np.float64) + bias[None, :])
            for c in range(d):
                y = f32(y + u[rows, None, c].astype(np.float64)
                        * moved[None, :, c])
        t = np.exp2(y.astype(np.float64))
        approx += [(t * upper).sum(), (t * t * upper).sum()]
    return np.abs(approx / exact - 1.0)


FORMS = (("difference", None), ("dot", None), ("dot", "row 0"),
         ("dot", "tile"))


def report(white, tag):
    for form, origin in FORMS:
        w = f32(white - white[0]) if origin == "row 0" else white
        err = pair_sums(w, form, tile_origin=origin == "tile")
        w64 = w.astype(np.float64)
        norm = (max(((w64 - w64[a]) ** 2).sum(1).max()
                    for a in range(0, len(w), TILE)) if origin == "tile"
                else (w64 ** 2).sum(1).max())
        print(f"[ucv dot form] {tag} form={form} origin={origin!r} "
              f"max_sq_norm={norm:.1f} "
              f"s2h_rel_err={err[0]:.3e} sh_rel_err={err[1]:.3e}",
              flush=True)


def main():
    import chip_smoke

    far = np.random.default_rng(1).normal(0.0, 1.0, (4_000, 3)) + [50.0, -30.0,
                                                                   10.0]
    chol = np.linalg.cholesky(
        (4.0 / (9_000 * 5)) ** (2.0 / 7) * np.cov(far.T))
    report(f32(np.linalg.solve(chol, far.T).T), "data=50 sd out "
           "bandwidth=nr*1.0")
    cols = chip_smoke.make_data(n=9_000, d=3, dtype=np.float64)
    x = np.column_stack(list(cols.values()))
    n, d = x.shape
    rule = (4.0 / (n * (d + 2))) ** (2.0 / (d + 4))
    for factor in chip_smoke.UCV_FACTORS_CHECKED:
        chol = np.linalg.cholesky(rule * factor ** 2 * np.cov(x.T))
        report(f32(np.linalg.solve(chol, x.T).T)[:4_000],
               f"bandwidth=nr*{factor}")


if __name__ == "__main__":
    main()
