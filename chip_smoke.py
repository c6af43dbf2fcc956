#!/usr/bin/env python3
"""Smoke run of the torch port (pybnesian_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints its findings, and a failing phase raises, so
the script exits non-zero and prints no result:

0. environment: torch, CUDA, nvcc and the card (name, power limit);
1. build: nvcc compiles csrc/ckde_cv.cu for sm_90a;
2. the kernel against its plain torch version on the card: small ragged
   cases, the bench shape, and the main path's own inputs;
3. the port's ``flash_cv_selfcheck`` on the card;
4. the main path: ``CVLikelihood.local_score_batch`` on bench.py's workload
   (10,000 rows × 5 float32 columns, 15 CKDE families, 10 folds, normal
   reference bandwidth) — one warm call and 3 timed calls through the
   kernel, scores held against the port's float64 path — then a
   semiparametric mix of linear-Gaussian and CKDE families.

The line before the last is a JSON object with the kernel's launch count
on the main path, its error against the plain version and both times; the
last line is ``{"ok": true, "device": {...}}``. Needs CUDA; imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

KERNEL_SOURCE = "pybnesian_tpu_torch/csrc/ckde_cv.cu"
KERNEL_REPLACES = "pybnesian_tpu/ops/pallas_kde.py:77"
PAIR_TOL = 1e-3       # max abs difference per test row, kernel vs plain
SCORE_RTOL = 1e-4     # float32 kernel route vs float64 plain route
TIMED_RUNS = 10


def make_data(n=10_000, d=5, seed=0, dtype=np.float32):
    """bench.py's data (bench.py:31), as a dict of numpy columns."""
    rng = np.random.default_rng(seed)
    cols = {}
    base = rng.normal(0, 1, n)
    for i in range(d):
        noise = rng.normal(0, 0.6, n)
        if i == 0:
            cols[f"x{i}"] = base + noise
        else:
            prev = cols[f"x{i-1}"]
            cols[f"x{i}"] = np.sin(0.8 * prev) + 0.5 * prev + noise
    return {k: v.astype(dtype) for k, v in cols.items()}


def families(d, shift=1):
    """bench.py's 15 candidate families (bench.py:47)."""
    fams = []
    names = [f"x{i}" for i in range(d)]
    for i, v in enumerate(names):
        fams.append((v, []))
        fams.append((v, [names[(i + shift) % d]]))
        fams.append((v, [names[(i + shift) % d], names[(i + shift + 1) % d]]))
    return fams


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return proc.stdout.strip()


def phase_environment(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _nvcc

    nvcc = _nvcc()
    nvcc_version = run([nvcc, "--version"]).splitlines()[-1]
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    say("0 environment", python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc_version),
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())
    print(smi, flush=True)
    return smi


def phase_build():
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import (
        _load_library, build_kernel)

    info = build_kernel()
    _load_library()
    regs = sorted({
        line.split("Used", 1)[1].split(",")[0].strip()
        for line in info["ptxas"].splitlines() if "Used" in line
    })
    say("1 build", built=info["built"], seconds=f"{info['seconds']:.2f}",
        ptxas_used=repr(regs), library=os.path.basename(info["path"]))


def pair_inputs(torch, G, ntr, nte, dpad, seed, scale=3.0):
    """Random kernel inputs on the card: ~10% null train rows, every third
    program evidence-free."""
    rng = np.random.default_rng(seed)
    jtr = rng.normal(0, scale, (G, ntr, dpad)).astype(np.float32)
    jte = rng.normal(0, scale, (G, nte, dpad)).astype(np.float32)
    neg = np.where(rng.random((G, ntr)) < 0.1, -np.inf, 0.0).astype(np.float32)
    no_ev = (np.arange(G) % 3 == 1).astype(np.float32)
    lm_const = np.log(np.maximum((neg == 0).sum(1), 1)).astype(np.float32)
    arrays = [jtr, neg, np.ascontiguousarray(jtr[..., -1]), jte,
              np.ascontiguousarray(jte[..., -1]), no_ev, lm_const]
    return [torch.as_tensor(a, device="cuda") for a in arrays]


def cuda_median_ms(torch, fn, runs=TIMED_RUNS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_pairs(torch, args, label, timed=False):
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import (
        ckde_cv_pairs, ckde_cv_pairs_reference)

    got = ckde_cv_pairs(*args)
    want = ckde_cv_pairs_reference(*args)
    torch.cuda.synchronize()
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError(f"{label}: NaN in kernel or plain output")
    err = float((got - want).abs().max())
    if not err <= PAIR_TOL:
        raise AssertionError(f"{label}: max abs diff {err} > {PAIR_TOL}")
    G, ntr, dpad = args[0].shape
    nte = args[3].shape[1]
    fields = {"case": label, "G_ntr_nte_dpad": f"{G}x{ntr}x{nte}x{dpad}",
              "max_abs_err": f"{err:.3e}"}
    ms = plain_ms = None
    if timed:
        ms = cuda_median_ms(torch, lambda: ckde_cv_pairs(*args))
        plain_ms = cuda_median_ms(torch,
                                  lambda: ckde_cv_pairs_reference(*args))
        fields.update(kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    say("2 kernel", **fields)
    return err, ms, plain_ms


def phase_kernel(torch, frame32, k):
    # (a) small cases: ragged ntr and nte, evidence-free programs, a program
    # whose second 256-row train tile is all padding, dpad 1/2/4/8
    for dpad in (1, 2, 4, 8):
        args = pair_inputs(torch, 4, 600, 77, dpad, seed=dpad)
        args[1][2, 256:512] = -math.inf
        compare_pairs(torch, args, f"small-dpad{dpad}")
    # (b) the bench shape: 150 (family, fold) programs, 9000 × 1000 rows
    compare_pairs(torch, pair_inputs(torch, 150, 9000, 1000, 4, seed=7),
                  "bench-shape", timed=True)
    # (c) the main path's own inputs: the whitened parts of its first batch
    return compare_pairs(torch, main_path_pair_inputs(torch, frame32, k),
                         "main-path-inputs", timed=True)


def main_path_pair_inputs(torch, frame32, k):
    """The kernel's arguments for the main path's first batch, built by the
    score's own cache and the flash route's own helpers."""
    from pybnesian_tpu_torch import CVLikelihood
    from pybnesian_tpu_torch.learning.scores.likelihood import _family_columns
    from pybnesian_tpu_torch.ops.kde import (
        ckde_cv_pair_args, ckde_cv_whitened_parts)

    engine = CVLikelihood(frame32, k=k, seed=0)._engine
    pos, data, null_mask, tr_idx, tr_mask, te_idx, te_mask = (
        engine._device_cv_cache()
    )
    col_idx, col_mask = _family_columns(families(frame32.num_columns), pos)
    col_mask = torch.as_tensor(col_mask, dtype=torch.float32, device="cuda")
    parts = ckde_cv_whitened_parts(
        data, null_mask, torch.as_tensor(col_idx, device="cuda"), col_mask,
        tr_idx, tr_mask, te_idx, te_mask, rule="nr",
    )
    return list(ckde_cv_pair_args(*parts[:5], col_mask))


def phase_selfcheck():
    from pybnesian_tpu_torch.ops.kde import flash_cv_selfcheck

    ok, diff = flash_cv_selfcheck(device="cuda")
    if not ok:
        raise AssertionError(f"flash_cv_selfcheck failed: max abs diff {diff}")
    say("3 selfcheck", ok=ok, max_abs_diff=f"{diff:.3e}")


def check_scores(got, want, label):
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{label}: non-finite scores {got}")
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if not rel <= SCORE_RTOL:
        raise AssertionError(f"{label}: max rel diff {rel} > {SCORE_RTOL}")
    return rel


def phase_main_path(torch, frame32, frame64, k):
    from pybnesian_tpu_torch import (
        CKDEType, CVLikelihood, KDENetwork, LinearGaussianCPDType,
        SemiparametricBN)
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs

    cols = frame32.column_names()
    d = len(cols)
    score = CVLikelihood(frame32, k=k, seed=0)
    reference = CVLikelihood(frame64, k=k, seed=0)
    if score.device.type != "cuda":
        raise AssertionError(f"score runs on {score.device}, not cuda")
    model = KDENetwork(cols)
    ckde = CKDEType()
    # warm call + 3 timed calls, the family set rotated as in bench.py:67-88;
    # valid shifts are 1..d-2, so with d = 5 the third timed call reuses
    # the warm call's families (nothing caches scores)
    shifts = [1, 2, 3, 1]
    batches = [[(v, ps, ckde) for v, ps in families(d, s)] for s in shifts]
    results, elapsed, grew = [], [], []
    ckde_cv_pairs.launches = 0
    for batch in batches:
        before = ckde_cv_pairs.launches
        t0 = time.perf_counter()
        results.append(score.local_score_batch(model, batch))
        elapsed.append(time.perf_counter() - t0)
        grew.append(ckde_cv_pairs.launches - before)
    launches = ckde_cv_pairs.launches
    if not all(g > 0 for g in grew):
        raise AssertionError(f"kernel launches per call {grew}: a call "
                             "did not go through the kernel")
    rel = max(
        check_scores(got, reference.local_score_batch(model, batch),
                     f"kde shift {s}")
        for got, batch, s in zip(results, batches, shifts)
    )
    timed = elapsed[1:]
    rate = len(batches[0]) / (sum(timed) / len(timed))
    say("4 main path", network="KDENetwork", families=len(batches[0]),
        folds=k, rows=frame32.num_rows, launches_per_call=grew,
        warm_s=f"{elapsed[0]:.4f}",
        timed_s=repr([round(t, 6) for t in timed]),
        family_scores_per_s=f"{rate:.2f}", max_rel_vs_f64=f"{rel:.3e}")

    # semiparametric mix: linear-Gaussian and CKDE families in one batch
    lg = LinearGaussianCPDType()
    spbn = SemiparametricBN(cols)
    mix = [(v, ps, lg if f % 2 else ckde)
           for f, (v, ps) in enumerate(families(d, 1))]
    before = ckde_cv_pairs.launches
    got = score.local_score_batch(spbn, mix)
    if ckde_cv_pairs.launches == before:
        raise AssertionError("the semiparametric batch did not launch "
                             "the kernel")
    rel = check_scores(got, reference.local_score_batch(spbn, mix),
                       "semiparametric mix")
    say("4 main path", network="SemiparametricBN", families=len(mix),
        lg=sum(1 for _, _, t in mix if t == lg),
        ckde=sum(1 for _, _, t in mix if t == ckde),
        max_rel_vs_f64=f"{rel:.3e}")
    return launches


def main():
    import torch

    smi = phase_environment(torch)
    from pybnesian_tpu_torch import DataFrame

    phase_build()
    k = 10
    data = make_data()
    frame32 = DataFrame.wrap(data)
    frame64 = DataFrame.wrap(
        {c: v.astype(np.float64) for c, v in data.items()})
    err, ms, plain_ms = phase_kernel(torch, frame32, k)
    phase_selfcheck()
    launches = phase_main_path(torch, frame32, frame64, k)
    print(json.dumps({"kernels": [{
        "name": "ckde_cv_pairs", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
