#!/usr/bin/env python3
"""Smoke run of the torch port (pybnesian_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints its findings, and a failing phase raises, so
the script exits non-zero and prints no result:

0. environment: torch, CUDA, nvcc and the card (name, power limit);
1. build: nvcc compiles every source of csrc/ for sm_90a, all at once;
2. the CV pairs kernel (``ckde_cv_pairs``) against its plain torch version
   on the card: small ragged cases, the bench shape, and the main path's
   own inputs;
3. the port's ``flash_cv_selfcheck`` on the card;
4. the CV path: ``CVLikelihood.local_score_batch`` on bench.py's workload
   (10,000 rows × 5 float32 columns, 15 CKDE families, 10 folds, normal
   reference bandwidth) — one warm call and 3 timed calls through the
   kernel, scores held against the port's float64 path — then a
   semiparametric mix of linear-Gaussian and CKDE families;
5. the KDE kernel (``kde_logl``) against its plain version: small ragged
   cases (G 1 and 2, d 1 to 20, an all-invalid first train tile) and the
   TPU kernel's own shape (10,240 × 10,240 rows, d 3), both timed;
6. the exp-chain probe (``exp_chain``) against its plain version, its rate
   (the card's float32 exp ceiling), and the two KDE kernels' exp rates as
   shares of that ceiling;
7. the fitted-model path at config3b's size: an 8-node SemiparametricBN
   chain (CKDE at x0, x2, x4, x6; linear-Gaussian at the odd nodes) fitted
   on 10,000 float32 rows, ``model.slogl`` on 10,000 more (warm, then 6
   timed calls through the pairs kernel), ``model.logl`` against the
   port's float64 path, every CKDE ``cpd.logl`` and a 3-variable KDE
   through the KDE kernel, and ``model.sample``.

Each path (4, 6, 7) runs with every launch count set to 0 just before it
and read just after. The line before the last is a JSON object with each
kernel's launches on those paths, its error against its plain version and
both times; the last line is ``{"ok": true, "device": {...}}``. Needs
CUDA; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

KERNELS = {  # wrapper name: (source, the TPU kernel it replaces)
    "ckde_cv_pairs": ("pybnesian_tpu_torch/csrc/ckde_cv.cu",
                      "pybnesian_tpu/ops/pallas_kde.py:77"),
    "kde_logl": ("pybnesian_tpu_torch/csrc/ckde_cv.cu",
                 "pybnesian_tpu/ops/pallas_kde.py:36"),
    "exp_chain": ("pybnesian_tpu_torch/csrc/exp_chain.cu",
                  "benchmarks/micro_exp_roofline.py:90"),
}
PAIR_TOL = 1e-3       # max abs difference per test row, kernel vs plain
SCORE_RTOL = 1e-4     # float32 kernel route vs float64 plain route
EXP_TOL = 1e-5        # max abs difference of the exp chain, kernel vs plain
ROW_TOL = 1e-3        # per-row logl: float32 kernel routes vs float64 plain,
                      # and the model's batched route vs its factors' routes
TIMED_RUNS = 10
MODEL_RUNS = 6
# (G, ntr, nte, d) of the Pallas KDE kernel's measured shape (pallas_kde.py:11)
KDE_TPU_SHAPE = (1, 10_240, 10_240, 3)


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


def config3b_data(n, seed, d=8):
    """benchmarks/config3b_logl_evals.py's data (:34-49), as a dict of
    float32 numpy columns."""
    rng = np.random.default_rng(seed)
    cols = {}
    prev = rng.normal(0, 1, n)
    cols["x0"] = prev
    for i in range(1, d):
        prev = np.sin(0.8 * prev) + 0.5 * prev + rng.normal(0, 0.6, n)
        cols[f"x{i}"] = prev
    return {k: v.astype(np.float32) for k, v in cols.items()}


def counters():
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs
    from pybnesian_tpu_torch.ops.exp_chain import exp_chain
    from pybnesian_tpu_torch.ops.kde_kernel import kde_logl

    return {"ckde_cv_pairs": ckde_cv_pairs, "kde_logl": kde_logl,
            "exp_chain": exp_chain}


def reset_counts():
    for wrapper in counters().values():
        wrapper.launches = 0


def read_counts():
    return {name: w.launches for name, w in counters().items()}


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return proc.stdout.strip()


def phase_environment(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    from pybnesian_tpu_torch.ops.cuda_build import nvcc as find_nvcc

    nvcc = find_nvcc()
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
    """One nvcc per source, all started together."""
    from pybnesian_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cuda_build.SOURCES)) as pool:
        infos = list(pool.map(cuda_build.build, cuda_build.SOURCES))
    wall = time.perf_counter() - t0
    for source, info in zip(cuda_build.SOURCES, infos):
        cuda_build.load(source)
        regs = sorted({
            line.split("Used", 1)[1].split(",")[0].strip()
            for line in info["ptxas"].splitlines() if "Used" in line
        })
        say("1 build", source=source, built=info["built"],
            seconds=f"{info['seconds']:.2f}", ptxas_used=repr(regs),
            library=os.path.basename(info["path"]))
    say("1 build", sources=len(infos), wall_s=f"{wall:.2f}")


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


def phase_kernel(torch, main_args):
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
    return compare_pairs(torch, main_args, "main-path-inputs", timed=True)


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
    reset_counts()
    for batch in batches:
        before = ckde_cv_pairs.launches
        t0 = time.perf_counter()
        results.append(score.local_score_batch(model, batch))
        elapsed.append(time.perf_counter() - t0)
        grew.append(ckde_cv_pairs.launches - before)
    launches = read_counts()
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
        family_scores_per_s=f"{rate:.2f}", max_rel_vs_f64=f"{rel:.3e}",
        launches=launches)

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


def kde_inputs(torch, G, ntr, nte, d, seed, scale=2.0):
    """Random KDE-kernel inputs on the card: ~10% invalid train rows."""
    rng = np.random.default_rng(seed)
    train = rng.normal(0, scale, (G, ntr, d)).astype(np.float32)
    test = rng.normal(0, scale, (G, nte, d)).astype(np.float32)
    valid = (rng.random((G, ntr)) > 0.1).astype(np.float32)
    lognorm = rng.normal(-3.0, 0.5, G).astype(np.float32)
    return [torch.as_tensor(a, device="cuda")
            for a in (train, valid, test, lognorm)]


def compare_kde(torch, args, label, timed=False):
    from pybnesian_tpu_torch.ops.kde_kernel import (
        kde_logl, kde_logl_reference)

    got = kde_logl(*args)
    want = kde_logl_reference(*args)
    torch.cuda.synchronize()
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError(f"{label}: NaN in kernel or plain output")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    err = float((got - want).abs().max())
    if not err <= PAIR_TOL:
        raise AssertionError(f"{label}: max abs diff {err} > {PAIR_TOL}")
    G, ntr, d = args[0].shape
    fields = {"case": label,
              "G_ntr_nte_d": f"{G}x{ntr}x{args[2].shape[1]}x{d}",
              "max_abs_err": f"{err:.3e}"}
    ms = plain_ms = None
    if timed:
        ms = cuda_median_ms(torch, lambda: kde_logl(*args))
        plain_ms = cuda_median_ms(torch, lambda: kde_logl_reference(*args))
        fields.update(kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    say("5 kde kernel", **fields)
    return err, ms, plain_ms


def phase_kde_kernel(torch):
    """Small ragged cases, then the TPU kernel's shape (pallas_kde.py:11)."""
    errs = []
    for G in (1, 2):
        for d in (1, 2, 3, 8, 16, 20):
            args = kde_inputs(torch, G, 600, 77, d, seed=10 * G + d)
            args[1][0, :256] = 0.0  # an all-invalid first train tile
            errs.append(compare_kde(torch, args, f"small-G{G}-d{d}")[0])
    err, ms, plain_ms = compare_kde(
        torch, kde_inputs(torch, *KDE_TPU_SHAPE, seed=1),
        "tpu-docstring-shape", timed=True)
    return max(errs + [err]), ms, plain_ms


def pairs_exps(args):
    """Exps of one ckde_cv_pairs launch: 2 per pair, 1 for evidence-free
    (no_ev) programs."""
    G, ntr, _ = args[0].shape
    n_no_ev = int((args[5] > 0.5).sum())
    return ntr * args[3].shape[1] * (2 * (G - n_no_ev) + n_no_ev)


def phase_exp_chain(torch, timed_kernels):
    """The probe against its plain version, then its rate as the exp
    ceiling; the KDE kernels' exp rates (``timed_kernels``: name → (exps
    per launch, ms per launch)) as shares of it."""
    from pybnesian_tpu_torch.ops.exp_chain import (
        CHAIN, REPEATS, SHAPE, exp_chain, exp_chain_reference)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(-np.abs(rng.normal(size=SHAPE)).astype(np.float32),
                        device="cuda")
    got = exp_chain(x)
    want = exp_chain_reference(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= EXP_TOL):
        raise AssertionError(f"exp chain: max abs diff {err} > {EXP_TOL}")
    plain_ms = cuda_median_ms(torch, lambda: exp_chain_reference(x))
    reset_counts()
    ms = cuda_median_ms(torch, lambda: exp_chain(x))
    launches = read_counts()
    if launches["exp_chain"] == 0:
        raise AssertionError("the probe did not launch its kernel")
    exps = SHAPE[0] * SHAPE[1] * CHAIN * REPEATS
    ceiling = exps / (ms * 1e-3)
    say("6 exp chain", shape=f"{SHAPE[0]}x{SHAPE[1]}", chain=CHAIN,
        repeats=REPEATS, max_abs_err=f"{err:.3e}", kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", gexp_per_s=f"{ceiling / 1e9:.2f}",
        launches=launches)
    for name, (n_exps, kms) in timed_kernels.items():
        rate = n_exps / (kms * 1e-3)
        say("6 exp-ceiling share", kernel=name, exps=n_exps,
            kernel_ms=f"{kms:.4f}", gexp_per_s=f"{rate / 1e9:.2f}",
            exp_ceiling_share=f"{rate / ceiling:.4f}")
    return err, ms, plain_ms, launches


def phase_model_path(torch):
    """config3b's workload (benchmarks/config3b_logl_evals.py:34-49): an
    8-node SemiparametricBN chain with CKDE at the even nodes, fitted on
    10,000 float32 rows and evaluated on 10,000 more."""
    from pybnesian_tpu_torch import (
        KDE, CKDEType, DataFrame, SemiparametricBN, interop)
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs

    d, n = 8, 10_000
    train, test = config3b_data(n, 0), config3b_data(n, 1)
    train32, test32 = DataFrame.wrap(train), DataFrame.wrap(test)
    train64 = DataFrame.wrap({k: v.astype(np.float64)
                              for k, v in train.items()})
    test64 = DataFrame.wrap({k: v.astype(np.float64)
                             for k, v in test.items()})
    names = list(train)
    ckde_nodes = names[0::2]
    model = SemiparametricBN(
        names, [(names[i], names[i + 1]) for i in range(d - 1)],
        [(v, CKDEType()) for v in ckde_nodes],
    )
    model.fit(train32)
    # the same fitted model in float64, the plain route's reference
    state = interop.network_state(model)
    for v in ckde_nodes:
        state["cpds"][v]["dtype"] = "float64"
    model64 = interop.fitted_network(**state)

    reset_counts()
    model.slogl(test32)  # warm
    elapsed, grew, values = [], [], []
    for _ in range(MODEL_RUNS):
        before = ckde_cv_pairs.launches
        t0 = time.perf_counter()
        values.append(model.slogl(test32))
        elapsed.append(time.perf_counter() - t0)
        grew.append(ckde_cv_pairs.launches - before)
    if not all(g > 0 for g in grew):
        raise AssertionError(f"pairs-kernel launches per slogl {grew}")
    rate = d * n / statistics.mean(elapsed)

    logl = model.logl(test32)
    logl64 = model64.logl(test64)
    if not np.all(np.isfinite(logl)):
        raise AssertionError("model.logl: non-finite rows")
    err_model = float(np.max(np.abs(logl - logl64)))
    if not err_model <= ROW_TOL:
        raise AssertionError(f"model.logl vs float64: {err_model} > {ROW_TOL}")
    slogl64 = model64.slogl(test64)
    say("7 model path", network="SemiparametricBN", nodes=d,
        ckde=len(ckde_nodes), train_rows=n, test_rows=n,
        slogl_s=repr([round(t, 6) for t in elapsed]),
        factor_row_evals_per_s=f"{rate:.2f}",
        slogl=f"{values[-1]:.6f}", slogl_f64=f"{slogl64:.6f}",
        logl_max_abs_vs_f64=f"{err_model:.3e}", pairs_launches=grew)

    from pybnesian_tpu_torch.ops.kde_kernel import kde_logl

    before = kde_logl.launches
    factors = sum(np.asarray(model.cpd(v).logl(test32)) for v in names)
    if kde_logl.launches - before != len(ckde_nodes):
        raise AssertionError("cpd.logl of the CKDE nodes launched the KDE "
                             f"kernel {kde_logl.launches - before} times")
    err_factors = float(np.max(np.abs(factors - logl)))
    if not err_factors <= ROW_TOL:
        raise AssertionError(
            f"Σ cpd.logl vs model.logl: {err_factors} > {ROW_TOL}")
    kde32, kde64 = KDE(["x0", "x1", "x2"]), KDE(["x0", "x1", "x2"])
    kde32.fit(train32)
    kde64.fit(train64)
    before = kde_logl.launches
    got = kde32.logl(test32)
    if kde_logl.launches == before:
        raise AssertionError("KDE.logl did not launch the KDE kernel")
    err_kde = float(np.max(np.abs(got - kde64.logl(test64))))
    if not (np.all(np.isfinite(got)) and err_kde <= ROW_TOL):
        raise AssertionError(f"KDE.logl vs float64: {err_kde} > {ROW_TOL}")

    t0 = time.perf_counter()
    sample = model.sample(1000, seed=0)
    sample_s = time.perf_counter() - t0
    cols = sample.to_pandas()
    if cols.shape != (1000, d) or not np.all(np.isfinite(cols.to_numpy())):
        raise AssertionError("model.sample: wrong shape or non-finite")
    launches = read_counts()
    say("7 model path", factors_vs_model_max_abs=f"{err_factors:.3e}",
        kde3_max_abs_vs_f64=f"{err_kde:.3e}", sample_rows=len(cols),
        sample_s=f"{sample_s:.4f}", launches=launches)
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
    pairs_args = main_path_pair_inputs(torch, frame32, k)
    pairs = phase_kernel(torch, pairs_args)
    phase_selfcheck()
    cv_launches = phase_main_path(torch, frame32, frame64, k)
    kde = phase_kde_kernel(torch)
    G, ntr, nte, _ = KDE_TPU_SHAPE
    *probe, probe_launches = phase_exp_chain(torch, {
        "ckde_cv_pairs": (pairs_exps(pairs_args), pairs[1]),
        "kde_logl": (G * ntr * nte, kde[1]),
    })
    model_launches = phase_model_path(torch)
    paths = {"cv": cv_launches, "probe": probe_launches,
             "model": model_launches}
    results = {"ckde_cv_pairs": pairs, "kde_logl": kde, "exp_chain": probe}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        by_path = {p: counts[name] for p, counts in paths.items()
                   if counts[name]}
        if not by_path:
            raise AssertionError(f"{name}: launched on no path")
        err, ms, plain_ms = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
