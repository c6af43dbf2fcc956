#!/usr/bin/env python3
"""Where the time of the CV whitening (``csrc/cv_whiten.cu``) and the
linear-Gaussian kernel (``csrc/lg_cv.cu``) goes, and how their launch
plans were chosen, on one card.

    python3 tools/kernel_sweeps.py stamps   # per-phase times of a block
    python3 tools/kernel_sweeps.py chunks   # LG: folds a program x S
    python3 tools/kernel_sweeps.py stages   # whitening: rows in flight

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

The instrumentation and the variants are text substitutions at lines of
the sources that the script names; it stops if one is missing. Inputs are
random from a seed (``tools/whiten_lg_ab.py``'s). Needs a GPU; imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import ctypes
import os
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
WHITEN_STAMPS = [
    ("  const int f = g / a.K, k = g % a.K;", True),
    ("  cluster_sync(split);  // every leaf's sums are in place", False),
    ("  if (a.rule == 2) {\n    if (split > 1) cluster_arrive();", False),
    ("    cluster_sync(split);  // every leaf's covariance sums are in "
     "place", False),
    ("  // the Cholesky factor and L^-1 by warp 0 of every rank", False),
    ("  if (threadIdx.x < 32) factor_warp(s_L, s_Linv, fam, &s_lndiff);\n"
     "  __syncthreads();", True),
    ("  __syncthreads();  // the resident rows are read: test rows take "
     "the slots", True),
    ("  if (rank == 0 && threadIdx.x == 0) {\n    a.no_ev[g]", False),
    ("  if (split > 1) cluster_wait();  // no block leaves while another "
     "reads it", True),
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


def variant(source, name, edits):
    """Compiles ``source`` with ``edits`` (pairs of a line and its
    replacement, each line found exactly once) into OUT; (CDLL, ptxas)."""
    from pybnesian_tpu_torch.ops import cuda_build

    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{source}: the line {old!r} is not there once")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"{name}_{source}")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"lib{name}_{source}.so")
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build._NVCC_FLAGS, "-o",
                           lib, src], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stderr[-3000:])
    return ctypes.CDLL(lib), proc.stderr


def stamped(source, stamps):
    """The instrumented copy of ``source``: a stamp at each line."""
    edits = [("namespace cg = cooperative_groups;",
              "namespace cg = cooperative_groups;\n" + STAMP_HEAD)]
    for i, (line, after) in enumerate(stamps):
        stamp = STAMP.format(i=i)
        edits.append((line, line + "\n" + stamp if after else stamp + line))
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


def main():
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
