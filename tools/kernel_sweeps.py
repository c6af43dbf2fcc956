#!/usr/bin/env python3
"""Where the time of the CV whitening (``csrc/cv_whiten.cu``), the
linear-Gaussian kernel (``csrc/lg_cv.cu``) and the UCV search kernel
(``csrc/ucv_pairs.cu``) goes, and how the launch plans were chosen, on
one card.

    python3 tools/kernel_sweeps.py stamps   # per-phase times of a block
    python3 tools/kernel_sweeps.py chunks   # LG: folds a program x S
    python3 tools/kernel_sweeps.py stages   # whitening: rows in flight
    python3 tools/kernel_sweeps.py search [PARENT]  # the UCV search's split

- ``stamps`` builds an instrumented copy of each source (into
  ``_chipwork/sweeps``, an ignored directory), in which thread 0 of every
  block reads ``%globaltimer`` at the boundaries of the kernel's phases,
  and prints per cluster size S the median and largest time of each phase,
  a block's median time and the quantiles of the blocks' start times (the
  waves): the whitening at phase 4's inputs (15 families x 10 folds, 9,000
  x 1,000 rows) at dpad 3 and 1, the LG kernel at ``hc``'s one-parent CV
  batch (56 families x 10 folds, 8,000 rows). Whitening phases: the
  gather and mean sums; the cluster barrier and merge; the covariance
  sums; the barrier, merge and bandwidth; the factor and L^-1; the
  whitened train rows; the test rows; the last barrier. LG phases: the
  Gram sums; the barrier, merge and write-out; the solves; the test sums;
  the last barriers.
- ``chunks`` times (batched) the LG kernel at ``hc``'s frame for 1 to 56
  one-parent families over every fold chunk in 10, 5, 2, 1 and S in 2, 4,
  8, beside the parent tree's kernel when ``_chipwork/parent`` holds one.
- ``stages`` times (batched) copies of the whitening source with 2, 4 and
  8 rows in flight per thread at phase 4's inputs (dpad 3 and 1), S 4 and
  8, with their registers and spills.

- ``search`` builds an instrumented copy of ``ucv_pairs.cu`` in which
  lane 0 of a warp logs ``%globaltimer`` events of ``ucv_search_kernel``
  into a device buffer (a block's entry and exit; its tile work: each
  (lane, point, tile pair) item; the lane steps; the grid barriers or the
  waits for work), runs ``tools/ucv_profile.py``'s search of (10, 9000,
  3) problems and ``chip_smoke.py`` phase 9 (b)'s three searches through
  it, and prints per search the share of block-time in tile work, in lane
  steps, waiting, and the rest (set-up, scans), per round (the grid's
  lockstep iteration) the lanes and items, or per lane its end and the
  idle share while k lanes were live. With PARENT (another checkout, whose
  search kernel meets at grid barriers) it runs PARENT's instrumented
  copy first, in a process of its own that imports PARENT's package.
  ``chip_smoke.py`` phase 9 prints the same split of this tree's kernel
  (:func:`search_split_of`).

The instrumentation and the variants are text substitutions at lines of
the sources that the script names; it stops if one is missing. Inputs are
random from a seed (``tools/whiten_lg_ab.py``'s, or the profile's and
phase 9's). Needs a GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
OUT = os.path.join(REPO, "_chipwork", "sweeps")
CSRC = os.path.join(REPO, "pybnesian_tpu_torch", "csrc")

STAMP = ('if (threadIdx.x == 0) {{ unsigned long long t_; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
         'g_stamps[blockIdx.x * 16 + {i}] = t_; }}\n')
STAMP_HEAD = ('__device__ unsigned long long g_stamps[1 << 17];\n'
              'extern "C" int read_stamps(void* dst, int n) { return '
              '(int)cudaMemcpyFromSymbol(dst, g_stamps, (size_t)n * 8); }\n')
# (line, True: stamp after it / False: before it)
# (stamps 1 and 3 sit in train_means and train_cov, the last in both
# kernels: the UCV starts' kernel shares them)
WHITEN_STAMPS = [
    ("  const int f = g / a.K, k = g % a.K;\n  double d_eff = 0.0;", True),
    ("  cluster_sync(split);  // every leaf's sums are in place", False),
    ("  if (a.rule == 2) {\n    if (split > 1) cluster_arrive();", False),
    ("  cluster_sync(split);  // every leaf's covariance sums are in place",
     False),
    ("  // the Cholesky factor and L^-1 by warp 0 of every rank", False),
    ("  // the whitened train rows, their variable coordinate and the row "
     "mask", False),
    ("  __syncthreads();  // the resident rows are read: test rows take "
     "the slots", True),
    ("  if (rank == 0 && threadIdx.x == 0) {\n    a.no_ev[g]", False),
    ("  if (split > 1) cluster_wait();  // no block leaves while another "
     "reads it", True, 2),
]
LG_STAMPS = [
    ("  const int pairs = kc * E;\n  if (threadIdx.x < W) {", False),
    ("  cluster_sync(split);  // every rank's subtree sums are in place",
     False),
    ("  __syncthreads();  // s_gram is written out before the solves "
     "overwrite it", True),
    ("  if (a.te_values != nullptr) {\n    // stage 3", False),
    ("    cluster_sync(split);  // the Gram sums are read; the test sums "
     "in place", False),
    ("  if (split > 1) {\n    cluster_arrive();  // done reading the "
     "cluster's sums\n    cluster_wait();", False),
]
STAGES_LINE = "__host__ __device__ constexpr int stages_for(int) { return 2; }"


def variant(source, name, edits, csrc=CSRC):
    """Compiles ``source`` of ``csrc`` with ``edits`` (pairs of a line and
    its replacement, each line found exactly once, or triples whose third
    is the number of times it is there, each replaced) into OUT; (CDLL,
    ptxas)."""
    from pybnesian_tpu_torch.ops import cuda_build

    with open(os.path.join(csrc, source)) as f:
        text = f.read()
    for old, new, *times in edits:
        want = times[0] if times else 1
        if text.count(old) != want:
            raise SystemExit(f"{source}: the line {old!r} is there "
                             f"{text.count(old)} times, not {want}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"{name}_{source}")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib{name}_{source}.so")
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build._NVCC_FLAGS, "-I",
                           csrc, "-o", lib, src], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(proc.stderr[-3000:])
    return ctypes.CDLL(lib), proc.stderr


def stamped(source, stamps):
    """The instrumented copy of ``source``: a stamp at each line."""
    edits = [("namespace cg = cooperative_groups;",
              "namespace cg = cooperative_groups;\n" + STAMP_HEAD)]
    for i, (line, after, *times) in enumerate(stamps):
        stamp = STAMP.format(i=i)
        edits.append((line, line + "\n" + stamp if after else stamp + line,
                      *times))
    lib, _ = variant(source, "stamped", edits)
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def report_stamps(torch, label, lib, launch, blocks, phases):
    launch()
    torch.cuda.synchronize()
    buf = np.zeros(blocks * 16, np.uint64)
    lib.read_stamps(buf.ctypes.data, blocks * 16)
    t = buf.reshape(blocks, 16)[:, :phases].astype(np.int64)
    start = (t[:, 0] - t[:, 0].min()) / 1e3
    took = (t[:, -1] - t[:, 0]) / 1e3
    dur = np.diff(t, axis=1) / 1e3
    print(f"[stamps] {label} blocks={blocks} "
          f"block_us_median={np.median(took):.2f} "
          f"start_us_quantiles={np.percentile(start, [0, 25, 50, 75, 100]).round(1).tolist()} "
          f"phase_us_median={np.median(dur, axis=0).round(2).tolist()} "
          f"phase_us_max={dur.max(axis=0).round(1).tolist()}", flush=True)


def hc_batch(torch, ab, families):
    """``lg_cv_stats``'s arguments for the first ``families`` one-parent
    families of ``hc``'s 8-column frame (8,000 rows, 10 folds)."""
    from pybnesian_tpu_torch.ops.gaussian import family_tensors

    fams = [(t, [s]) for t in range(8) for s in range(8) if s != t]
    values, valid, _, _ = ab.lg_frame(torch, 10_000, 8, seed=0)
    train, test = ab.lg_frame(torch, 8_000, 1, seed=1)[2:]
    tv, tm = values[:8000].contiguous(), valid[:8000].contiguous()
    return [tv, tm, train, *family_tensors(fams[:families], np.float32,
                                           "cuda"), tv, tm, test]


def phase4(torch, ab, dpad):
    widths = [1 + f % 3 for f in range(15)] if dpad == 3 else [1] * 15
    return ab.whiten_inputs(torch, 10_000, 9000, 1000, widths, seed=dpad)


# ------------------------------------------------------------- UCV search
# The event log of the instrumented search kernel: lane 0 of a warp writes
# (time, tag << 32 | arg) pairs into its own row of a device buffer.
SEARCH_HEAD = r'''
__device__ unsigned long long* g_log;
__device__ int* g_log_n;
__device__ int g_log_cap;
#define LOG_EVENT(who, tag, arg)                                           \
  if (who) {                                                               \
    const int w_ = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;      \
    const int n_ = g_log_n[w_];                                            \
    if (n_ < g_log_cap) {                                                  \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      const size_t i_ = 2 * (static_cast<size_t>(w_) * g_log_cap + n_);    \
      g_log[i_] = t_;                                                      \
      g_log[i_ + 1] = (static_cast<unsigned long long>(tag) << 32) |       \
                      static_cast<unsigned>(arg);                          \
    }                                                                      \
    g_log_n[w_] = n_ + 1;                                                  \
  }
#define T0 (threadIdx.x == 0)
#define W0 ((threadIdx.x & 31) == 0)
extern "C" int set_log(void* log, void* counts, int cap) {
  cudaError_t e = cudaMemcpyToSymbol(g_log, &log, sizeof(void*));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_log_n, &counts, sizeof(void*));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_log_cap, &cap, sizeof(int));
  return static_cast<int>(e);
}
'''
# tags: a block's entry and exit; the change's work queue (its start,
# an item's begin, its tiles whitened, its end, a lane step's begin and
# end); the parent's tile phases, items, grid barriers, lane steps (per
# warp) and rounds
(ENTRY, EXIT, RUN, ITEM_BEGIN, WHITENED, ITEM_END, STEP_BEGIN, STEP_END,
 TILES_BEGIN, TILES_END, ITEM, SYNC_BEGIN, SYNC_END, WARP_STEP_BEGIN,
 WARP_STEP_END, ROUND) = range(16)


def _log(who, tag, arg):
    return f"LOG_EVENT({who}, {tag}, {arg}) "


SETUP_LINE = "  for (int b = gw; b < a.B; b += warps) setup_lane(a, b);"
# this tree's kernel: lanes through a work queue
SEARCH_STAMPS = [
    (SETUP_LINE, _log("T0", ENTRY, 0) + SETUP_LINE),
    ("  run_lanes<D>(a);", _log("T0", RUN, 0) + "run_lanes<D>(a);"),
    ("    if (item.x == -2) return;",
     "    if (item.x == -2) { " + _log("T0", EXIT, 0) + "return; }"),
    ("    const int b = item.x;\n",
     _log("T0", ITEM_BEGIN, "item.x") + "const int b = item.x;\n"),
    ("      s_last = atomicAdd(state_of(a, b) + 4, 1) + 1 == item.z;\n"
     "    }\n    __syncthreads();\n",
     "      s_last = atomicAdd(state_of(a, b) + 4, 1) + 1 == item.z;\n"
     "    }\n    __syncthreads();\n" + _log("T0", ITEM_END, "b") + "\n"),
    ("  __syncthreads();\n  const SharedTile<T> row_tile",
     "  __syncthreads();\n" + _log("T0", WHITENED, 0)
     + "const SharedTile<T> row_tile"),
    ("    if (s_last && lead) lane_step(a, b, kind);",
     "    if (s_last && lead) { " + _log("T0", STEP_BEGIN, "b * 8 + kind")
     + "lane_step(a, b, kind); " + _log("T0", STEP_END, "b") + "}"),
]


def _parent_step(call, kind):
    return (call, "{ " + _log("W0", WARP_STEP_BEGIN, f"b * 8 + {kind}") + call
            + " " + _log("W0", WARP_STEP_END, "b") + "}")


def _parent_tiles(call, phase):
    return (call, _log("T0", TILES_BEGIN, phase) + call + " "
            + _log("T0", TILES_END, phase))


# a parent's kernel: lanes in lockstep between grid barriers
PARENT_SEARCH_STAMPS = [
    (SETUP_LINE, _log("T0", ENTRY, 0) + SETUP_LINE),
    ("  for (int b = gw; b < a.B; b += warps) write_result(a, b);",
     _log("T0", EXIT, 0)
     + "for (int b = gw; b < a.B; b += warps) write_result(a, b);"),
    ("  while (any_lane(a, kDone, 0)) {",
     "  while (any_lane(a, kDone, 0)) { " + _log("T0", ROUND, 0)),
    ("    tile_item<D>(a, b, q0 + qi, p, nt);",
     _log("T0", ITEM, "b") + "tile_item<D>(a, b, q0 + qi, p, nt);"),
    ("grid.sync();", "{ " + _log("T0", SYNC_BEGIN, 0) + "grid.sync(); "
     + _log("T0", SYNC_END, 0) + "}", 9),
    _parent_tiles("evaluate_tiles<D>(a, 0, points, 0, 0);", 0),
    _parent_tiles("evaluate_tiles<D>(a, 0, 1, kDone, 0);", 1),
    _parent_tiles("evaluate_tiles<D>(a, 1, 1, kDone | kMid, 0);", 2),
    _parent_tiles("evaluate_tiles<D>(a, 1, a.nv, kShrink, kShrink);", 3),
    _parent_step("start_lane(a, b);", 0),
    _parent_step("second_point(a, b);", 1),
    _parent_step("accept(a, b);", 2),
    _parent_step("finish_shrink(a, b);", 3),
]
LOG_CAP = 8192  # events a warp
LOG_WARPS = 132 * 16 * 4  # SMs x blocks an SM x warps a block, at most


def search_stamped(tree=REPO, name="search"):
    """The instrumented copy of ``tree``'s ``ucv_pairs.cu``: this tree's
    stamps, or the parent's (grid barriers) when the source has them; a
    CDLL with ``ucv_search_f32``'s and ``ucv_search_scratch``'s argument
    types read from the source, and ``set_log``."""
    csrc = os.path.join(tree, "pybnesian_tpu_torch", "csrc")
    with open(os.path.join(csrc, "ucv_pairs.cu")) as f:
        text = f.read()
    parent = "while (any_lane(a, kDone, 0))" in text
    stamps = PARENT_SEARCH_STAMPS if parent else SEARCH_STAMPS
    edits = [("namespace cg = cooperative_groups;",
              "namespace cg = cooperative_groups;\n" + SEARCH_HEAD), *stamps]
    lib = variant("ucv_pairs.cu", name, edits, csrc=csrc)[0]
    for fn in ("ucv_search_f32", "ucv_search_scratch"):
        params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
        getattr(lib, fn).argtypes = [
            ctypes.POINTER(ctypes.c_longlong) if "long long*" in p
            else ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in params.group(1).split(",")]
        getattr(lib, fn).restype = ctypes.c_int
    lib.set_log.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.parent = parent
    return lib


class StampedSearches:
    """While active, the UCV search wrapper of the imported package
    launches the instrumented kernel ``lib``; :meth:`run` clears the log,
    calls ``fn`` and returns the events of its launches, per warp (time
    in µs from the first event, tag, arg)."""

    def __init__(self, torch, lib):
        self.torch, self.lib = torch, lib

    def __enter__(self):
        from pybnesian_tpu_torch.ops import ucv_search_kernel as usk

        torch = self.torch
        self._usk, self._load = usk, usk._load_library
        usk._load_library = lambda: self.lib
        self.log = torch.empty(LOG_WARPS * LOG_CAP * 2, dtype=torch.int64,
                               device="cuda")
        self.counts = torch.zeros(LOG_WARPS, dtype=torch.int32,
                                  device="cuda")
        if self.lib.set_log(self.log.data_ptr(), self.counts.data_ptr(),
                            LOG_CAP) != 0:
            raise RuntimeError("set_log failed")
        return self

    def __exit__(self, *exc):
        self._usk._load_library = self._load

    def run(self, fn):
        torch = self.torch
        self.counts.zero_()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        counts = self.counts.cpu().numpy()
        if counts.max() > LOG_CAP:
            raise RuntimeError(f"a warp logged {counts.max()} events, "
                               f"more than {LOG_CAP}")
        warps = int(np.flatnonzero(counts).max()) + 1
        log = self.log[: warps * LOG_CAP * 2].view(warps, LOG_CAP, 2)
        log = log.cpu().numpy().view(np.uint64)
        t0 = min(int(log[w, 0, 0]) for w in range(warps) if counts[w])
        events = []
        for w in range(warps):
            n = int(counts[w])
            t = (log[w, :n, 0].astype(np.int64) - t0) / 1e3
            info = log[w, :n, 1]
            events.append((t, (info >> np.uint64(32)).astype(np.int64),
                           (info & np.uint64(0xffffffff)).astype(np.int64)))
        return out, events


def _pairs(t, tags, begin, end):
    """(starts, ends) of the intervals that tags ``begin`` .. ``end`` of
    one warp's events enclose."""
    return t[tags == begin], t[tags == end]


def _union(intervals):
    """The intervals merged: a sorted list of disjoint (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b):
    """The length of the intersection of two lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def split_parent(events, per_block):
    """The block-time split of the parent's kernel (grid barriers) and its
    rounds: (shares, rounds [(lanes, items, µs)])."""
    blocks = len(events) // per_block
    life = tile = step = wait = 0.0
    marks = None
    lanes_at, items_at = [], []
    for blk in range(blocks):
        t, tags, args = events[blk * per_block]
        begin, end = t[tags == ENTRY][0], t[tags == EXIT][0]
        life += end - begin
        tiles = list(zip(*_pairs(t, tags, TILES_BEGIN, TILES_END)))
        tile += sum(e - s for s, e in tiles)
        steps = []
        for w in range(per_block):
            tw, gw, aw = events[blk * per_block + w]
            s, e = _pairs(tw, gw, WARP_STEP_BEGIN, WARP_STEP_END)
            steps += list(zip(s, e))
            lanes_at += [x for x, a in zip(s, aw[gw == WARP_STEP_BEGIN])
                         if a % 8 == 1]
        steps = _union(steps)
        step += sum(e - s for s, e in steps)
        syncs = _union(zip(*_pairs(t, tags, SYNC_BEGIN, SYNC_END)))
        wait += sum(e - s for s, e in syncs) - _overlap(syncs, steps)
        items_at += list(t[tags == ITEM])
        if blk == 0:
            marks = np.append(t[tags == ROUND], end)
    rounds = []
    lanes_at, items_at = np.array(lanes_at), np.array(items_at)
    for r in range(len(marks) - 1):
        lo, hi = marks[r], marks[r + 1]
        rounds.append((int(((lanes_at >= lo) & (lanes_at < hi)).sum()),
                       int(((items_at >= lo) & (items_at < hi)).sum()),
                       round(float(hi - lo), 1)))
    shares = {"tile": tile / life, "step": step / life, "wait": wait / life,
              "other": (life - tile - step - wait) / life}
    return blocks, life / blocks, shares, rounds


def split_change(events, per_block):
    """The block-time split of this tree's kernel (a work queue), each
    lane's end, and the idle share while k lanes were live."""
    blocks = len(events) // per_block
    life = setup = tile = whiten = step = 0.0
    ends, busy, spans = {}, [], []
    for blk in range(blocks):
        t, tags, args = events[blk * per_block]
        begin, end = t[tags == ENTRY][0], t[tags == EXIT][0]
        life += end - begin
        setup += t[tags == RUN][0] - begin
        items = list(zip(*_pairs(t, tags, ITEM_BEGIN, ITEM_END)))
        steps = list(zip(*_pairs(t, tags, STEP_BEGIN, STEP_END)))
        tile += sum(e - s for s, e in items)
        whiten += float((t[tags == WHITENED] - t[tags == ITEM_BEGIN]).sum())
        step += sum(e - s for s, e in steps)
        for s, e, a in zip(*_pairs(t, tags, STEP_BEGIN, STEP_END),
                           args[tags == STEP_BEGIN]):
            ends[int(a) // 8] = max(ends.get(int(a) // 8, 0.0), float(e))
        busy.append(_union(items + steps))
        spans.append((t[tags == RUN][0], end))
    finish = sorted(ends.values())
    idle_by_live = {}
    lo = min(s for s, _ in spans)
    for k, hi in enumerate(finish):
        live = len(finish) - k
        window = [[lo, hi]]
        span = sum(max(0.0, min(hi, e) - max(lo, s)) for s, e in spans)
        used = sum(_overlap(window, b) for b in busy)
        if span > 0:
            idle_by_live[live] = round(float(1.0 - used / span), 4)
        lo = hi
    shares = {"setup": setup / life, "tile": tile / life, "step": step / life,
              "wait": (life - setup - tile - step) / life,
              "whiten_of_tile": whiten / tile}
    return blocks, life / blocks, shares, [round(f / 1e3, 3)
                                           for f in finish], idle_by_live


def search_split_of(stamps, fn, label, per_block):
    """Runs ``fn`` (one UCV search) through the instrumented kernel of
    ``stamps`` (a :class:`StampedSearches`; ``per_block`` warps a block:
    2, or 4 above 16 columns). Returns the lines of its block-time split,
    each a dict of fields for the caller to print: the shares, then per
    run of rounds the lanes and items (a parent with grid barriers) or
    each lane's end and the idle share while k lanes were live."""
    _out, events = stamps.run(fn)
    events += [(np.zeros(0),) * 3] * (-len(events) % per_block)
    if stamps.lib.parent:
        blocks, block_us, shares, rounds = split_parent(events, per_block)
        groups = []  # runs of rounds with the same lanes
        for lanes, items, us in rounds:
            if groups and groups[-1][0] == lanes:
                groups[-1][1:] = [groups[-1][1] + 1, groups[-1][2] + items,
                                  groups[-1][3] + us]
            else:
                groups.append([lanes, 1, items, us])
        return [
            dict(what="search", tree="parent", search=label, blocks=blocks,
                 block_ms=f"{block_us / 1e3:.4f}",
                 **{f"{k}_share": f"{v:.4f}" for k, v in shares.items()},
                 rounds=len(rounds)),
            dict(what="rounds", tree="parent", search=label,
                 lanes_rounds_items_us=repr(
                     [(g[0], g[1], g[2], round(g[3], 1)) for g in groups]))]
    blocks, block_us, shares, finish, idle = split_change(events, per_block)
    return [
        dict(what="search", tree="change", search=label, blocks=blocks,
             block_ms=f"{block_us / 1e3:.4f}",
             **{f"{k}_share": f"{v:.4f}" for k, v in shares.items()},
             lanes=len(finish)),
        dict(what="lanes", tree="change", search=label,
             lane_end_ms=repr(finish), idle_share_by_live_lanes=repr(idle))]


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def search_child(tree, data):
    """The split of ``tree``'s search kernel at the profile's search and
    phase 9 (b)'s three, on ``data`` (``chip_smoke.py``'s frame, a dict of
    numpy columns), in this process (``tree``'s package imported)."""
    sys.path.insert(0, tree)
    import torch

    import pybnesian_tpu_torch as p
    from pybnesian_tpu_torch.kde import ucv as tucv

    lib = search_stamped(tree, "search" if tree == REPO else "search_parent")
    rng = np.random.default_rng(0)
    white = rng.normal(0, 1.0, (10, 9000, 3))
    knr = (4.0 / (9000 * 5.0)) ** (2.0 / 7.0)
    x0s = np.stack([tucv.vech(np.linalg.cholesky(knr * np.cov(x,
                                                                rowvar=False)))
                    for x in white])
    frame = p.DataFrame.wrap(data)
    names = frame.column_names()
    score = p.CVLikelihood(frame, k=10, seed=0, construction_args=p.Arguments(
        {p.CKDEType(): p.Kwargs(bandwidth_selector=p.UCV())}))
    untyped = [(names[0], [], None), (names[1], [names[0]], None),
               (names[2], [names[0], names[1]], None)]
    with StampedSearches(torch, lib) as stamps:
        searches = [(lambda: tucv.ucv_search_batch(
            white, np.ones(white.shape[:2]), np.full(10, 9000.0), x0s, 3,
            dtype=np.float32, device="cuda"), "profile-10x9000x3", 2)]
        calls, real = [], tucv.ucv_search_cuda

        def recording(*args):
            calls.append(args)
            return real(*args)

        tucv.ucv_search_cuda = recording
        try:
            score._engine._ucv_bandwidths(untyped)
        finally:
            tucv.ucv_search_cuda = real
        for args in calls:
            B, N, d = args[0].shape
            searches.append((lambda args=args: real(*args),
                             f"phase9b-{B}x{N}x{d}", 2 if d <= 16 else 4))
        for fn, label, per_block in searches:
            for fields in search_split_of(stamps, fn, label, per_block):
                say("stamps search", **fields)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "search-child":
        import chip_smoke

        search_child(os.path.abspath(sys.argv[2]), chip_smoke.make_data())
        return
    if sys.argv[1:2] == ["search"] and len(sys.argv) <= 3:
        for tree in [*sys.argv[2:], REPO]:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "search-child", tree], check=True)
        return
    if len(sys.argv) != 2 or sys.argv[1] not in ("stamps", "chunks",
                                                  "stages"):
        raise SystemExit(__doc__)
    import torch

    import chip_smoke
    import whiten_lg_ab as ab

    chip_smoke.phase_environment(torch)
    what = sys.argv[1]
    if what == "stamps":
        with ThreadPoolExecutor(2) as pool:
            wl, ll = pool.map(stamped, ("cv_whiten.cu", "lg_cv.cu"),
                              (WHITEN_STAMPS, LG_STAMPS))
        for dpad in (3, 1):
            args = phase4(torch, ab, dpad)
            for split in (1, 2, 4, 8):
                launch = ab.whiten_call(torch, wl, True, args, split)[0]
                report_stamps(torch, f"whiten dpad {dpad} S {split}", wl,
                              launch, 150 * split, len(WHITEN_STAMPS))
        args = hc_batch(torch, ab, 56)
        for split in (1, 2, 4, 8):
            launch = ab.lg_call(torch, ll, True, args, split, 10)[0]
            report_stamps(torch, f"lg hc chunk 10 S {split}", ll, launch,
                          56 * split, len(LG_STAMPS))
    elif what == "chunks":
        from pybnesian_tpu_torch.ops import cuda_build
        from pybnesian_tpu_torch.ops.lg_cv_kernel import _launch_plan

        lib = cuda_build.load("lg_cv.cu")
        parent = os.path.join(REPO, "_chipwork", "parent")
        old = (ab.build(parent, os.path.join(parent, "_ab_build"))["lg_cv.cu"]
               if os.path.isdir(parent) else None)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for families in (1, 2, 4, 7, 14, 28, 56):
            args = hc_batch(torch, ab, families)
            row = {"plan": _launch_plan(families, 10, 3, 8000, sms)}
            if old is not None:
                row["parent"] = round(chip_smoke.cuda_median_ms(
                    torch, ab.lg_call(torch, old, False, args)[0],
                    batch=chip_smoke.KERNEL_BATCH), 4)
            for chunk in (10, 5, 2, 1):
                for split in (2, 4, 8):
                    launch = ab.lg_call(torch, lib, True, args, split,
                                        chunk)[0]
                    row[f"c{chunk}S{split}"] = round(chip_smoke.cuda_median_ms(
                        torch, launch, batch=chip_smoke.KERNEL_BATCH), 4)
            print(f"[chunks] families={families} {row}", flush=True)
    else:
        builds = {}
        for depth in (2, 4, 8):
            line = STAGES_LINE.replace("return 2;", f"return {depth};")
            lib, ptxas = variant("cv_whiten.cu", f"stages{depth}",
                                 [(STAGES_LINE, line)])
            funcs = chip_smoke.ptxas_functions(ptxas)
            builds[depth] = lib
            print(f"[stages] rows_in_flight={depth} "
                  f"whiten_kernel<3>={funcs.get('whiten_kernel<3>')} "
                  f"whiten_kernel<1>={funcs.get('whiten_kernel<1>')}",
                  flush=True)
        for dpad in (3, 1):
            args = phase4(torch, ab, dpad)
            for depth, lib in builds.items():
                row = {}
                for split in (4, 8):
                    launch = ab.whiten_call(torch, lib, True, args, split)[0]
                    row[f"S{split}"] = round(chip_smoke.cuda_median_ms(
                        torch, launch, batch=chip_smoke.KERNEL_BATCH), 4)
                print(f"[stages] dpad={dpad} rows_in_flight={depth} {row}",
                      flush=True)


if __name__ == "__main__":
    main()
