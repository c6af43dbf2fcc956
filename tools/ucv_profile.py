#!/usr/bin/env python3
"""Where one UCV objective evaluation of the torch port spends its time
on the GPU.

    python3 tools/ucv_profile.py

The CV score of a UCV-selected CKDE family of two parents on 10,000 rows
and 10 folds searches 10 bandwidth problems of 9,000 rows × 3 columns at
once (``chip_smoke.py`` phase 9 (b)); every step of that search calls
``ucv_pair_sums_batch`` on a (10, 9000, 3) block. This script times that
call in float32 and float64 (CUDA events, median of 10; every row valid,
as for folds of one size without nulls, and with a validity mask),
profiles three
float32 calls under ``torch.profiler``, and prints the device's kernels by
total time with their share, the kernels per call, and the time one
read and one write of every pair element (``pairs × 8`` bytes in float32)
would take at the card's memory rate, with the call's time as a multiple
of such passes, and the bound of the same work done by one fused kernel
(``chip_smoke.bound``: one exp per pair on the SFU).

Needs a GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROBLEMS, ROWS, COLUMNS = 10, 9_000, 3


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from pybnesian_tpu_torch.ops.kde import ucv_pair_sums_batch

    if not torch.cuda.is_available():
        raise SystemExit("ucv_profile.py needs a GPU")
    card = chip_smoke.phase_environment(torch)
    rng = np.random.default_rng(0)
    white = rng.normal(0, 4.0, (PROBLEMS, ROWS, COLUMNS))
    pairs = PROBLEMS * ROWS * (ROWS - 1) // 2
    # what a fused kernel would need: one exp and ~3 ops per column per
    # pair, the rows read once
    bound_ms, bound_by = chip_smoke.bound(
        card, pairs, pairs * (3 * COLUMNS + 4), 4 * PROBLEMS * ROWS * COLUMNS)
    chip_smoke.say("ucv profile", problems=PROBLEMS, rows=ROWS,
                   columns=COLUMNS, pairs=pairs,
                   fused_kernel_bound_ms=f"{bound_ms:.4f}",
                   bound_by=bound_by)
    for dtype in (torch.float32, torch.float64):
        w = torch.as_tensor(white, dtype=dtype, device="cuda")
        ms = chip_smoke.cuda_median_ms(torch,
                                       lambda: ucv_pair_sums_batch(w))
        valid = torch.ones_like(w[:, :, 0])
        masked_ms = chip_smoke.cuda_median_ms(
            torch, lambda: ucv_pair_sums_batch(w, valid))
        size = w.element_size()
        once_ms = pairs * 2 * size / chip_smoke.HBM_BYTES_PER_S * 1e3
        chip_smoke.say("ucv profile", dtype=str(dtype).replace("torch.", ""),
                       pair_sums_ms=f"{ms:.4f}",
                       with_validity_mask_ms=f"{masked_ms:.4f}",
                       gpairs_per_s=f"{pairs / ms / 1e6:.3f}",
                       one_read_one_write_ms=f"{once_ms:.4f}",
                       passes_equivalent=f"{ms / once_ms * 2:.2f}")

    w = torch.as_tensor(white, dtype=torch.float32, device="cuda")
    calls = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ucv_pair_sums_batch(w)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    total_us = sum(e.device_time for e in events)
    by_name: dict[str, list] = {}
    for e in events:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.device_time
        entry[1] += 1
    chip_smoke.say("ucv profile", profiled_calls=calls,
                   device_ms_per_call=f"{total_us / calls / 1e3:.4f}",
                   kernels_per_call=len(events) // calls)
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        chip_smoke.say("ucv profile kernel", share=f"{us / total_us:.4f}",
                       ms_per_call=f"{us / calls / 1e3:.4f}",
                       launches_per_call=count // calls,
                       name=repr(name[:90]))
    print(card["smi"], flush=True)


if __name__ == "__main__":
    main()
