#!/usr/bin/env python3
"""Where one ``hc`` run of the torch port spends its time on the GPU.

    python3 tools/hc_profile.py

Runs ``chip_smoke.py``'s phase-8 call — ``hc`` on a SemiparametricBN over
the 8-column config3b chain (10,000 float32 rows), the default
ValidatedLikelihood and operators, ``patience=5`` — once warm, then once
under ``torch.profiler`` and once under ``cProfile``, and prints:

- the wall time of the profiled run and the median of 3 unprofiled runs,
  the device's busy time in the profiled run (the union of its kernels'
  intervals), and its idle share against each wall time (the profiler's
  own host cost stretches the profiled run, so the unprofiled share is
  the one to read);
- kernels on the device per hc iteration, the kernels by total time,
  and the port's two KDE kernels' time and launches;
- the host's torch operators by self CPU time;
- the port's Python functions by cumulative time (cProfile run).

Needs a GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import cProfile
import os
import pstats
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def busy_ms(kernels):
    """Total length of the union of (start, end) intervals, in ms."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(kernels):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from pybnesian_tpu_torch import DataFrame

    if not torch.cuda.is_available():
        raise SystemExit("hc_profile.py needs a GPU")
    smi = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]).splitlines()[0]
    frame = DataFrame.wrap(chip_smoke.config3b_data(chip_smoke.HC_ROWS,
                                                    seed=2))
    chip_smoke.learn(torch, frame)  # warm: kernel builds, caches
    unprofiled = statistics.median(chip_smoke.learn(torch, frame)[3]
                                   for _ in range(3))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, score, recorder, _ = chip_smoke.learn(torch, frame)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = busy_ms(intervals)
    iters = max(recorder.iterations, 1)
    print(f"[hc profile] device={torch.cuda.get_device_name(0)!r} "
          f"rows={chip_smoke.HC_ROWS} iterations={recorder.iterations} "
          f"families_scored={score.families} wall_ms={wall * 1e3:.4f} "
          f"unprofiled_wall_ms={unprofiled * 1e3:.4f} device_busy_ms={busy:.4f} "
          f"idle_share_profiled={1 - busy / (wall * 1e3):.4f} "
          f"idle_share_unprofiled={1 - busy / (unprofiled * 1e3):.4f} "
          f"kernels={len(kernels)} kernels_per_iteration={len(kernels) / iters:.2f}",
          flush=True)
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + (e.time_range.end - e.time_range.start),
                           count + 1)
    for name, (total, count) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])[:15]:
        print(f"[hc profile kernel] ms={total / 1e3:.4f} launches={count} "
              f"name={name[:110]!r}")
    # the port's own kernels (csrc/ckde_cv.cu): pairs_kernel<D, R, kCv> is
    # kernel #1 with kCv true, kernel #2 with kCv false, as is the wide KDE
    # kernel
    for label, marks in (("ckde_cv_pairs", ("true>",)),
                         ("kde_logl", ("false>", "kde_logl_wide_kernel"))):
        mine = [(t, c) for n, (t, c) in by_name.items()
                if ("pairs_kernel<" in n or "kde_logl_wide_kernel" in n)
                and any(m in n for m in marks)]
        print(f"[hc profile port kernel] name={label} "
              f"ms={sum(t for t, _ in mine) / 1e3:.4f} "
              f"launches={sum(c for _, c in mine)}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"[hc profile host op] self_cpu_ms={e.self_cpu_time_total / 1e3:.4f} "
              f"calls={e.count} name={e.key!r}")

    profiler = cProfile.Profile()
    t0 = time.perf_counter()
    profiler.enable()
    chip_smoke.learn(torch, frame)
    profiler.disable()
    print(f"[hc profile python] cprofile_wall_ms="
          f"{(time.perf_counter() - t0) * 1e3:.4f}", flush=True)
    stats = pstats.Stats(profiler)
    rows = []
    for (path, line, func), (_, ncalls, _, cum, _) in stats.stats.items():
        if "pybnesian_tpu_torch" in path or "scipy" in path:
            rows.append((cum, ncalls, f"{os.path.relpath(path, REPO)}:{line} {func}"))
    for cum, ncalls, where in sorted(rows, reverse=True)[:25]:
        print(f"[hc profile python] cum_ms={cum * 1e3:.4f} calls={ncalls} "
              f"at={where}")
    print(smi, flush=True)


if __name__ == "__main__":
    main()
