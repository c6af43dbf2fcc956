#!/usr/bin/env python3
"""Where the UCV bandwidth search of the torch port spends its time on the
GPU.

    python3 tools/ucv_profile.py

The CV score of a UCV-selected CKDE family of two parents on 10,000 rows
and 10 folds searches 10 bandwidth problems of 9,000 rows × 3 columns at
once (``chip_smoke.py`` phase 9 (b)); every objective evaluation of that
search calls ``ucv_pair_sums_batch`` on a (10, 9000, 3) block. This script

1. times that call on each route (CUDA events, median of 10): float32 on
   the card's kernel (``ucv_pair_sums_cuda``), the plain torch version in
   float32 and in float64 (the float64 search's route), beside the bound
   of the work (``chip_smoke.bound``: one exp per valid pair on the SFU)
   and the time one read and one write of every pair element would take
   at the card's memory rate;
2. profiles three float32 calls under ``torch.profiler``: the device's
   kernels by total time, and the kernels per call;
3. runs one float32 search of that shape (``ucv_search_batch``) with a
   profiled copy of it: per Nelder–Mead iteration its host wall, its
   objective evaluations, the device kernels it launches, its device reads
   (``aten::_local_scalar_dense``: each one a host wait on the card), and
   the share of the device time in the pair-sums kernel, which says what
   sets the search's pace once the pair sums are one kernel.

Needs a GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROBLEMS, ROWS, COLUMNS = 10, 9_000, 3


def device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def route_times(torch, card, white, pairs):
    import chip_smoke
    from pybnesian_tpu_torch.ops.kde import ucv_pair_sums_batch
    from pybnesian_tpu_torch.ops.ucv_kernel import ucv_pair_sums_reference

    w32 = torch.as_tensor(white, dtype=torch.float32, device="cuda")
    w64 = torch.as_tensor(white, dtype=torch.float64, device="cuda")
    routes = {"kernel_f32": lambda: ucv_pair_sums_batch(w32),
              "plain_f32": lambda: ucv_pair_sums_reference(w32),
              "plain_f64": lambda: ucv_pair_sums_batch(w64)}
    bound_ms, bound_by = chip_smoke.bound(
        card, *chip_smoke.ucv_work(w32, None))
    times = {name: chip_smoke.cuda_median_ms(torch, fn)
             for name, fn in routes.items()}
    once_ms = pairs * 2 * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3
    chip_smoke.say(
        "ucv profile", problems=PROBLEMS, rows=ROWS, columns=COLUMNS,
        pairs=pairs, bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        **{f"{k}_ms": f"{v:.4f}" for k, v in times.items()},
        kernel_bound_share=f"{bound_ms / times['kernel_f32']:.4f}",
        plain_f32_over_kernel=f"{times['plain_f32'] / times['kernel_f32']:.1f}",
        f32_pair_pass_ms=f"{once_ms:.4f}")
    return w32


def profile_calls(torch, w32, calls=3):
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from pybnesian_tpu_torch.ops.kde import ucv_pair_sums_batch

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ucv_pair_sums_batch(w32)
        torch.cuda.synchronize()
    events = device_events(prof)
    total_us = sum(e.device_time for e in events)
    chip_smoke.say("ucv profile", profiled_calls=calls,
                   device_ms_per_call=f"{total_us / calls / 1e3:.4f}",
                   kernels_per_call=len(events) // calls)
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.device_time
        entry[1] += 1
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:6]:
        chip_smoke.say("ucv profile kernel", share=f"{us / total_us:.4f}",
                       ms_per_call=f"{us / calls / 1e3:.4f}",
                       launches_per_call=count // calls,
                       name=repr(name[:90]))


def search_profile(torch, white):
    """One float32 search of the (PROBLEMS, ROWS, COLUMNS) block, timed,
    then the same search again under the profiler."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from pybnesian_tpu_torch.kde.ucv import ucv_search_batch, vech

    d = white.shape[2]
    knr = (4.0 / (ROWS * (d + 2.0))) ** (2.0 / (d + 4.0))
    x0s = np.stack([vech(np.linalg.cholesky(knr * np.cov(x, rowvar=False)))
                    for x in white])
    args = (white, np.ones(white.shape[:2]), np.full(len(white), ROWS), x0s,
            d)
    ucv_search_batch(*args, dtype=np.float32, device="cuda")  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search = ucv_search_batch(*args, dtype=np.float32, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = ucv_search_batch(*args, dtype=np.float32, device="cuda")
        torch.cuda.synchronize()
    if not np.array_equal(again.x, search.x):
        raise AssertionError("two float32 searches found different optima")
    events = device_events(prof)
    device_us = sum(e.device_time for e in events)
    pair_us = sum(e.device_time for e in events if "ucv_" in e.name)
    reads = sum(1 for e in prof.events()
                if e.name == "aten::_local_scalar_dense")
    iters = int(search.iterations.max())
    chip_smoke.say(
        "ucv profile search", problems=len(white), rows=ROWS, columns=d,
        wall_s=f"{wall:.4f}", iterations_max=iters,
        evaluations=search.evaluations,
        ms_per_iteration=f"{wall / iters * 1e3:.4f}",
        kernels_per_iteration=f"{len(events) / iters:.1f}",
        device_reads_per_iteration=f"{reads / iters:.2f}",
        device_ms=f"{device_us / 1e3:.4f}",
        device_busy_share_of_wall=f"{device_us / 1e6 / wall:.4f}",
        pair_sums_share_of_device=f"{pair_us / device_us:.4f}",
        pair_sums_share_of_wall=f"{pair_us / 1e6 / wall:.4f}")


def main():
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("ucv_profile.py needs a GPU")
    card = chip_smoke.phase_environment(torch)
    rng = np.random.default_rng(0)
    white = rng.normal(0, 4.0, (PROBLEMS, ROWS, COLUMNS))
    pairs = PROBLEMS * ROWS * (ROWS - 1) // 2
    w32 = route_times(torch, card, white, pairs)
    profile_calls(torch, w32)
    # the search takes raw rows (bench.py's spread), not whitened ones
    search_profile(torch, white / 4.0)
    print(card["smi"], flush=True)


if __name__ == "__main__":
    main()
