"""ctypes loader for the native discrete-family scoring core
(pybnesian_tpu_torch/_native/discretecore.cpp, auto-built on first use like
the graph closure core, through the package's race-free loader). The
reference scores discrete families in C++ (scores/bic.cpp:66-97 over
discrete_indices.cpp counts); this is the host tier of the dispatch in
learning/scores/bic.py and bde.py — one compiled pass over the cached codes
for a whole hill-climbing batch — and the whole native discrete
hill-climb (``dc_hc``).

Copied from ``pybnesian_tpu/learning/scores/discrete_native.py``. A build
or load failure is not swallowed: :func:`available` turns False, a
``RuntimeWarning`` carries the compiler's message once, and
:func:`load_error` keeps it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

__all__ = ["available", "load_error", "native_codes", "family_arrays",
           "takes_frame", "native_tier", "NATIVE_BELOW_ROW_ITEMS",
           "bic_batch", "bic_addcand", "hc_discrete", "chi2_batch",
           "gtest_batch", "grouped_moments", "bde_batch"]

_LIB = None
_TRIED = False
_ERROR: str | None = None

# beyond this configuration-space size the core declines a family (NaN) and
# the caller routes it to another tier
MAX_CONFIGS = 1 << 22


def _load():
    global _LIB, _TRIED, _ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    pkg_dir = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    src = os.path.join(pkg_dir, "_native", "discretecore.cpp")
    try:
        from ..._native import build_and_load

        lib = build_and_load(src)
        lib.dc_bic_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.dc_bic_batch.restype = None
        lib.dc_bic_addcand.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.dc_bic_addcand.restype = None
        lib.dc_hc.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.dc_bde_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.dc_bde_batch.restype = None
        lib.dc_hc.restype = ctypes.c_int32
        lib.dc_chi2_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.dc_chi2_batch.restype = None
        lib.dc_gtest_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.dc_gtest_batch.restype = None
        lib.dc_grouped_moments.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.dc_grouped_moments.restype = None
        _LIB = lib
    except Exception as exc:  # pragma: no cover - toolchain specific
        _LIB = None
        detail = ""
        if isinstance(exc, subprocess.CalledProcessError) and exc.stderr:
            detail = ": " + exc.stderr.decode(errors="replace")[-2000:]
        _ERROR = f"{type(exc).__name__}: {exc}{detail}"
        warnings.warn(
            "the native discrete scoring core could not be built or loaded "
            f"({_ERROR}); discrete scores take the slower routes",
            RuntimeWarning,
            stacklevel=3,
        )
    return _LIB


# Which tier scores a frame's discrete families: the native core when
# rows x columns^2 (the row-items of a search's first pass, which scores a
# family for every ordered pair of columns) is below this, the device from
# there up. A score decides once, at its first batch, so one search never
# mixes the two tiers' scores: they agree to the last bits only, and BIC
# and BDe score an arc and its reversal alike, so such a tie could break
# either way. From the whole searches that chip_smoke.py (phase 10) times
# on the card's machine, 20 columns of cardinality 3 over 10,000 to
# 1,000,000 rows: on an H100 the core's own loop took ~1.7 us per row
# (0.02 s at 10,000 rows, 0.17 s at 100,000) and a search on the card
# ~0.1 s up to 100,000 rows, so the core won at 4M row-items and the card
# at 40M (PERF.md section 6).
NATIVE_BELOW_ROW_ITEMS = 20_000_000


def takes_frame(n_rows: int, n_columns: int) -> bool:
    """True when the native core should score the discrete families of a
    frame of ``n_rows`` rows and ``n_columns`` discrete columns: it is
    loaded, and rows x columns^2 is below :data:`NATIVE_BELOW_ROW_ITEMS`."""
    return (n_rows * n_columns * n_columns < NATIVE_BELOW_ROW_ITEMS
            and available())


def native_tier(df, native: bool | None) -> bool:
    """A score's tier for ``df``: the caller's choice (``native`` True or
    False), or :func:`takes_frame`'s when it made none. Raises when the
    caller chose the core and it cannot be loaded."""
    if native is None:
        return takes_frame(df.num_rows, len(df.discrete_columns()))
    if native and not available():
        raise RuntimeError(
            f"the native discrete scoring core is not available: {_ERROR}")
    return bool(native)


def native_codes(df):
    """``(positions, block, cards)`` of a frame's discrete columns for the
    native core: {name: row of the block}, the (ncols, n) C-contiguous
    int32 code block (-1 marks nulls) and the int64 cardinalities."""
    cols = df.discrete_columns()
    block = np.ascontiguousarray(
        np.stack([df.codes(c).astype(np.int32) for c in cols])
        if cols else np.zeros((0, df.num_rows), np.int32)
    )
    cards = np.array([df.cardinality(c) for c in cols], np.int64)
    return {c: i for i, c in enumerate(cols)}, block, cards


def family_arrays(fams, pos):
    """``(fam_var (F,), fam_parents (F, maxp))`` int32 arrays of (variable,
    parents) name families for :func:`bic_batch` and :func:`bde_batch`;
    -1 pads the parents."""
    maxp = max(max((len(ps) for _, ps in fams), default=0), 1)
    fam_var = np.array([pos[v] for v, _ in fams], np.int32)
    fam_parents = np.full((len(fams), maxp), -1, np.int32)
    for f, (_, ps) in enumerate(fams):
        for j, p in enumerate(ps):
            fam_parents[f, j] = pos[p]
    return fam_var, fam_parents


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    """Why :func:`available` is False: the build's or the loader's message;
    None when the core loaded (or was not asked for yet)."""
    _load()
    return _ERROR


def bic_batch(codes_block: np.ndarray, cards: np.ndarray,
              fam_var: np.ndarray, fam_parents: np.ndarray) -> np.ndarray:
    """BIC scores for F families over the (ncols, n) int32 code block.

    ``fam_parents`` is (F, maxp) with -1 padding. Returns (F,) scores with
    NaN where the family's configuration space exceeded MAX_CONFIGS (the
    caller routes those to another tier).
    """
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    F, maxp = fam_parents.shape
    out = np.empty(F, np.float64)
    lib.dc_bic_batch(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, ncols,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        np.ascontiguousarray(fam_var, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(fam_parents, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        F, maxp, MAX_CONFIGS,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def bic_addcand(codes_block: np.ndarray, cards: np.ndarray, tcol: int,
                base_idx: np.ndarray, cand_idx: np.ndarray) -> np.ndarray:
    """BIC scores of the families (tcol, base_idx + [c]) for every c in
    ``cand_idx`` — one shared-base counting pass (dc_bic_addcand). Counts
    and scores are identical to :func:`bic_batch` on the expanded family
    list; NaN marks config-space overflow or all-null families."""
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    base_idx = np.ascontiguousarray(base_idx, np.int32)
    cand_idx = np.ascontiguousarray(cand_idx, np.int32)
    out = np.empty(len(cand_idx), np.float64)
    lib.dc_bic_addcand(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        int(tcol),
        base_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(base_idx),
        cand_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(cand_idx),
        MAX_CONFIGS,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def hc_discrete(codes_block: np.ndarray, cards: np.ndarray,
                node_cols: np.ndarray, adj: np.ndarray, valid: np.ndarray,
                max_indegree: int, max_iters: int, epsilon: float,
                score_kind: int = 0, iss: float = 1.0):
    """Run the full discrete ArcOperatorSet hill-climbing natively
    (dc_hc; score_kind 0 = BIC, 1 = BDe with the given iss). Returns the
    (kind, s, t) op list, or None when the native loop aborts
    (config-space overflow — caller runs the generic path).
    kind: 0 AddArc(s, t), 1 RemoveArc(s, t), 2 FlipArc(s, t).
    ``hc_discrete.calls`` counts the searches handed to the core."""
    lib = _load()
    assert lib is not None
    hc_discrete.calls += 1
    ncols, n = codes_block.shape
    d = len(node_cols)
    node_cols = np.ascontiguousarray(node_cols, np.int32)
    adj = np.ascontiguousarray(adj, np.uint8)
    valid = np.ascontiguousarray(valid, np.uint8)
    max_ops = max(4 * d * d, 1024)
    out_ops = np.empty((max_ops, 3), np.int32)
    rc = lib.dc_hc(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        node_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        d,
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(max_indegree),
        int(max_iters),
        float(epsilon),
        MAX_CONFIGS,
        int(score_kind),
        float(iss),
        out_ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_ops,
    )
    if rc < 0:
        return None
    return out_ops[:rc]


hc_discrete.calls = 0


def chi2_batch(codes_block: np.ndarray, cards: np.ndarray,
               tx: np.ndarray, ty: np.ndarray, tz: np.ndarray) -> np.ndarray:
    """Pearson χ² statistics for F conditional tests x ⊥ y | Z.
    ``tz`` is (F, maxz) with -1 padding. NaN marks config-space overflow
    (caller falls back to the serial path for that test)."""
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    F, maxz = tz.shape if tz.ndim == 2 else (len(tx), 0)
    if maxz == 0:
        tz = np.full((F, 1), -1, np.int32)
        maxz = 1
    out = np.empty(F, np.float64)
    lib.dc_chi2_batch(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        np.ascontiguousarray(tx, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(ty, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(tz, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        F, maxz, MAX_CONFIGS,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def gtest_batch(codes_block: np.ndarray, cards: np.ndarray,
                tx: np.ndarray, ty: np.ndarray, tz: np.ndarray):
    """(N·MI statistic, valid-row count) for F all-discrete conditional MI
    tests. NaN statistic marks config-space overflow."""
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    F, maxz = tz.shape
    out = np.empty(F, np.float64)
    out_n = np.empty(F, np.float64)
    lib.dc_gtest_batch(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        np.ascontiguousarray(tx, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(ty, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(tz, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        F, maxz, MAX_CONFIGS,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out, out_n


def grouped_moments(vals: np.ndarray, idx: np.ndarray, valid: np.ndarray,
                    n_configs: int):
    """Per-config (counts, sums, group-centred product sums) over valid
    rows in two fused native passes. vals: (n, d) float64 C-contiguous;
    idx: (n,) int64; valid: (n,) uint8/bool. Returns (counts (C,),
    sums (C, d), sq (C, d, d))."""
    lib = _load()
    assert lib is not None
    n, d = vals.shape
    vals = np.ascontiguousarray(vals, np.float64)
    idx = np.ascontiguousarray(idx, np.int64)
    valid = np.ascontiguousarray(valid, np.uint8)
    counts = np.empty(n_configs, np.int64)
    sums = np.empty((n_configs, d), np.float64)
    sq = np.empty((n_configs, d, d), np.float64)
    lib.dc_grouped_moments(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, d, n_configs,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sums.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return counts, sums, sq


def bde_batch(codes_block: np.ndarray, cards: np.ndarray,
              fam_var: np.ndarray, fam_parents: np.ndarray,
              iss: float) -> np.ndarray:
    """BDe local scores (uniform iss prior) for F families — same contract
    as :func:`bic_batch`; NaN marks config-space overflow."""
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    F, maxp = fam_parents.shape
    out = np.empty(F, np.float64)
    lib.dc_bde_batch(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, ncols,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        np.ascontiguousarray(fam_var, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(fam_parents, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        F, maxp, MAX_CONFIGS, float(iss),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
