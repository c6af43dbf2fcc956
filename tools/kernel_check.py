#!/usr/bin/env python3
"""A short first check of the port's CUDA kernels on the card: the call to
make after a kernel's source changes, before the full ``chip_smoke.py``.

    python3 tools/kernel_check.py

1. builds every source of ``csrc/`` at once and prints nvcc's register,
   shared-memory and spill lines;
2. holds the UCV pair-sums kernel to its plain version (relative
   difference per sum) on the search's shape (10, 9,000, 3) and on ragged,
   narrow, wide, masked, one-row and NaN problems;
3. checks one problem's UCV sums bit-equal alone, inside 30 problems,
   padded with invalid rows, and run again;
4. times the UCV kernel and its plain version at (10, 9,000, 3), 10
   launches in one CUDA-event window each;
5. checks kernels #1 and #2 bit-equal for program 0 alone (G 1) and inside
   G 150, and for every forced split 1 to 8, with their max abs error
   against the plain version.

Needs a GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build():
    from pybnesian_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cuda_build.SOURCES)) as pool:
        infos = list(pool.map(cuda_build.build, cuda_build.SOURCES))
    for source, info in zip(cuda_build.SOURCES, infos):
        print("build", source, f"{info['seconds']:.1f}s")
        print("\n".join(line for line in info["ptxas"].splitlines()
                        if "Used" in line or "spill" in line
                        or "Compiling" in line))
    print("build wall", f"{time.perf_counter() - t0:.1f}s", flush=True)


def rel_err(got, want):
    return max(float(((g.double() - w.double()).abs()
                      / w.double().abs().clamp_min(1e-30)).max().cpu())
               for g, w in zip(got, want))


def ucv_checks(torch, rng):
    from pybnesian_tpu_torch.ops import ucv_kernel as uk

    def case(label, B, N, d, valid=None, scale=1.0, nan=None):
        w = torch.as_tensor(rng.normal(0, scale, (B, N, d)),
                            dtype=torch.float32, device="cuda")
        v = None if valid is None else torch.as_tensor(valid, device="cuda")
        if nan is not None:
            w[nan] = math.nan
        got = uk.ucv_pair_sums_cuda(w, v)
        want = uk.ucv_pair_sums_reference(w, v)
        torch.cuda.synchronize()
        print("ucv", label, (B, N, d), "rel", f"{rel_err(got, want):.3e}",
              "got", [g[:2].tolist() for g in got],
              "want", [x[:2].tolist() for x in want], flush=True)

    case("basic", 3, 1000, 3)
    case("search", 10, 9000, 3, scale=4.0)
    case("odd", 2, 1001, 2)
    case("d1", 2, 777, 1)
    case("d16", 2, 600, 16)
    case("d20", 2, 300, 20)
    case("d40", 2, 300, 40)
    valid = np.ones((3, 700), np.float32)
    valid[0] = 0.0             # all invalid
    valid[1, [5, 400]] = 0.0   # two invalid rows
    valid[2, 650:] = 0.0
    case("invalid", 3, 700, 3, valid=valid)
    case("N1", 1, 1, 2)
    case("N1-nan", 1, 1, 2, nan=(0, 0, 0))
    case("nan-row", 2, 500, 3, nan=(1, 17, 1))

    w = torch.as_tensor(rng.normal(0, 4.0, (30, 9000, 3)),
                        dtype=torch.float32, device="cuda")
    alone = uk.ucv_pair_sums_cuda(w[:1].contiguous())
    batch = uk.ucv_pair_sums_cuda(w)
    again = uk.ucv_pair_sums_cuda(w)
    pad = torch.cat([w[:1], torch.zeros((1, 1000, 3), device="cuda")], 1)
    pad_valid = torch.ones((1, 10_000), device="cuda")
    pad_valid[:, 9000:] = 0.0
    padded = uk.ucv_pair_sums_cuda(pad.contiguous(), pad_valid)
    print("ucv bit-equal alone/in 30", all(
        torch.equal(alone[i], batch[i][:1]) for i in range(2)),
        "rerun", all(torch.equal(batch[i], again[i]) for i in range(2)),
        "padded", all(torch.equal(alone[i], padded[i]) for i in range(2)),
        flush=True)

    w10 = w[:10].contiguous()
    for name, fn in (("kernel", lambda: uk.ucv_pair_sums_cuda(w10)),
                     ("plain", lambda: uk.ucv_pair_sums_reference(w10))):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        print("ucv time", name, f"{start.elapsed_time(end) / 10:.4f} ms",
              flush=True)


def kde_checks(torch):
    import chip_smoke
    from pybnesian_tpu_torch.ops import ckde_cv_kernel as ck
    from pybnesian_tpu_torch.ops import kde_kernel as kk

    args = chip_smoke.pair_inputs(torch, 150, 9000, 1000, 3, seed=1)
    full = ck.ckde_cv_pairs(*args)
    one = ck.ckde_cv_pairs(*[a[:1].contiguous() for a in args])
    splits = [ck._launch(*args, (2, 16, s)) for s in range(1, 9)]
    want = ck.ckde_cv_pairs_reference(*[a[:3].contiguous() for a in args])
    torch.cuda.synchronize()
    print("#1 G1 == G150", torch.equal(full[:1], one), "splits 1-8 equal",
          [torch.equal(full, x) for x in splits], "max abs err",
          float((full[:3] - want).abs().max()), flush=True)
    t = chip_smoke.kde_inputs(torch, 1, 10_240, 10_240, 3, seed=2)
    alone = kk.kde_logl(*t)
    batch = kk.kde_logl(*[a.expand(150, *a.shape[1:]).contiguous()
                          for a in t])
    splits = [kk._launch(*t, (2, 16, s)) for s in range(1, 9)]
    want = kk.kde_logl_reference(*t)
    torch.cuda.synchronize()
    print("#2 G1 == G150", torch.equal(alone, batch[:1]), "splits 1-8 equal",
          [torch.equal(alone, x) for x in splits], "max abs err",
          float((alone - want).abs().max()), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_check.py needs a GPU")
    build()
    ucv_checks(torch, np.random.default_rng(0))
    kde_checks(torch)


if __name__ == "__main__":
    main()
