#!/usr/bin/env python3
"""Times the CV whitening and fold-reduce kernels (``csrc/cv_whiten.cu``)
and the linear-Gaussian kernel (``csrc/lg_cv.cu``) of two trees against
each other in one process on one card.

    python3 tools/whiten_lg_ab.py PARENT_TREE [OUT_JSON] [--only KERNEL ...]

``--only`` (whiten, lg, reduce) runs those kernels' cases alone.

PARENT_TREE is the root of another checkout (or of a ``git archive`` of
one), typically the parent commit unpacked into an ignored directory. Both
trees' sources are compiled side by side with the port's nvcc flags into
``PARENT_TREE/_ab_build`` and this tree's ``_chipwork/ab_build``, loaded
with ctypes and launched on the same inputs. An entry point that ends in
``(..., split, stream)`` gets this tree's launch plan; one without the
plan argument is called without it, so a parent from before the cluster
redesign runs as it was. At each shape the two run in turns, parent,
change, change, parent, each the median of 10 CUDA-event windows of one
launch (``ms``) and of 20 launches (``batched_ms``) (for the fold reduce
also each launch's own device time under ``torch.profiler``,
``device_ms``), beside
``chip_smoke.bound`` of the work, and the change's outputs are held to the
parent's (one float32 rounding apart: 2e-6 for the whitening, 1e-6
relative for the LG scores, BICs and Grams, the NaN and -inf places
exactly; the fold sums bit for bit); the change alone is also timed
(batched) at every cluster size S it takes, each S bit-equal to S = 1.
Shapes (inputs random from a seed):

- whitening: phase 4's (15 families × 10 folds, 9,000 × 1,000 rows, dpad
  3: widths 1-3), dpad 1 and dpad 16 at the same rows, and 100,000 rows
  (90,000 × 10,000, dpad 3);
- LG: ``hc``'s one-parent CV batch (56 families × 10 folds of 8,000 rows),
  its holdout batch (one fold of 8,000 rows, 2,000 test rows), phase 4's
  7 families and 20 one-parent families (10,000 rows, 10 folds), and one
  family of 15 parents (W 17) and one of 18 (W 20, the runtime width);
- fold reduce (``chip_smoke.reduce_rows``: -inf and NaN rows of weight 0,
  one degenerate fold): phase 4's (F 15, K 10, 1,000 test rows a fold),
  ``hc``'s CV batch (F 8, K 10, 800), one family (F 1, K 10, 800), the
  holdout (F 8, K 1, 2,000), 100,000 rows (F 15, K 10, 10,000) and a wide
  batch (F 80, K 10, 800).

Prints one line per shape and writes every number to OUT_JSON when given.
Needs a GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SOURCES = ("cv_whiten.cu", "lg_cv.cu")
ORDER = ("parent", "change", "change", "parent")
KERNELS = ("whiten", "lg", "reduce")
WHITEN_TOL = 2e-6
LG_RTOL = 1e-6


def build(tree, out_dir):
    """Compiles ``tree``'s two sources into ``out_dir``; {source: CDLL}."""
    from pybnesian_tpu_torch.ops import cuda_build

    os.makedirs(out_dir, exist_ok=True)

    def one(source):
        out = os.path.join(out_dir, "lib" + source.replace(".cu", ".so"))
        src = os.path.join(tree, "pybnesian_tpu_torch", "csrc", source)
        subprocess.run([cuda_build.nvcc(), *cuda_build._NVCC_FLAGS, "-o", out,
                        src], check=True, capture_output=True, text=True)
        return source, ctypes.CDLL(out)

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(pool.map(one, SOURCES))


def takes_split(tree, entry):
    """Whether ``entry`` of ``tree``'s sources ends in (..., split,
    stream)."""
    import re

    source = "lg_cv.cu" if entry.startswith("lg") else "cv_whiten.cu"
    with open(os.path.join(tree, "pybnesian_tpu_torch", "csrc",
                           source)) as f:
        params = re.search(entry + r"\(([^)]*)\)", f.read()).group(1)
    return [p.split()[-1] for p in params.split(",")][-2] == "split"


def bind(lib, entry, pointers, ints):
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def whiten_inputs(torch, n, ntr, nte, widths, seed, K=10):
    """A whitening call's arguments: n rows of max(widths) + 1 correlated
    float32 columns (5% null), K folds of ntr train and nte test rows, one
    family per entry of ``widths``, evidence first, padded to the widest."""
    rng = np.random.default_rng(seed)
    dpad = max(widths)
    D = dpad + 1
    data = rng.normal(0, 1.5, (n, D))
    for j in range(1, D):
        data[:, j] += 0.6 * data[:, j - 1]
    null = (rng.random((n, D)) < 0.05).astype(np.float64)
    data[null > 0] = 0.0
    perm = rng.permutation(n)
    te_idx = np.stack([perm[k * nte:(k + 1) * nte] for k in range(K)])
    tr_idx = np.stack([np.concatenate([perm[:k * nte],
                                       perm[(k + 1) * nte:]])[:ntr]
                       for k in range(K)])
    col_idx = np.zeros((len(widths), dpad), np.int64)
    col_mask = np.zeros((len(widths), dpad))
    for f, w in enumerate(widths):
        col_idx[f, :w] = rng.choice(D, w, replace=False)
        col_mask[f, :w] = 1.0

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()

    return [t(data), t(null), t(col_idx, torch.int64), t(col_mask),
            t(tr_idx, torch.int64), t(np.ones((K, ntr))),
            t(te_idx, torch.int64), t(np.ones((K, nte)))]


def whiten_call(torch, lib, split_of, args, split=None):
    """A launcher of ``lib``'s whitening on ``args`` into fixed outputs:
    (launch, outputs, split); ``split`` forces the cluster size of a source
    that takes one, else the plan's."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import _launch_plan
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _sm_count

    data, null, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask = args
    n, D = data.shape
    F, dpad = col_idx.shape
    K, ntr = tr_idx.shape
    nte = te_idx.shape[1]
    G = F * K

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="cuda")

    outs = (empty(G, ntr, dpad), empty(G, ntr), empty(G, ntr),
            empty(G, nte, dpad), empty(G, nte), empty(G), empty(G),
            empty(F, K, nte), empty(F, K, dtype=torch.float64), empty(F, K))
    if split_of and split is None:
        split = _launch_plan(G, ntr, dpad, _sm_count(data.device))
    fn = bind(lib, "ckde_cv_whiten_f32", 19, 9 if split_of else 8)
    ptrs = [t.data_ptr() for t in args] + [None] + [t.data_ptr() for t in outs]
    ints = [n, D, F, K, ntr, nte, dpad, 0] + ([split] if split_of else [])
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*ptrs, *ints, stream)
        if err:
            raise RuntimeError(f"whitening launch failed: CUDA error {err}")

    return launch, outs, split


def reduce_call(torch, lib, split_of, args, split=None):
    """A launcher of ``lib``'s fold reduce on (rows, wte, lndiff, ok) into
    a fixed output: (launch, (out,), split); ``split`` forces the cluster
    size of a source that takes one, else the plan's."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _sm_count
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import _reduce_plan

    F, K, nte = args[0].shape
    out = torch.empty(F, dtype=torch.float32, device="cuda")
    if split_of and split is None:
        split = _reduce_plan(F, K, _sm_count(args[0].device))
    fn = bind(lib, "ckde_cv_fold_reduce_f32", 5, 4 if split_of else 3)
    ptrs = [t.data_ptr() for t in (*args, out)]
    ints = [F, K, nte] + ([split] if split_of else [])
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*ptrs, *ints, stream)
        if err:
            raise RuntimeError(f"fold reduce launch failed: CUDA error {err}")

    return launch, (out,), split


def bits_equal(torch, a, b):
    """Whether two float32 tensors hold the same bits (NaN payloads too)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def lg_call(torch, lib, split_of, args, split=None, chunk=None):
    """A launcher of ``lib``'s LG kernel on ``lg_cv_stats``'s arguments
    into fixed outputs: (launch, (gram, bic, out), (chunk, split));
    ``split`` and ``chunk`` force the plan of a source that takes one."""
    from pybnesian_tpu_torch.ops.ckde_cv_kernel import _sm_count
    from pybnesian_tpu_torch.ops.lg_cv_kernel import _launch_plan

    tr_values, tr_valid, train, vi, pi, pm, te_values, te_valid, test = args
    n_tr, D = tr_values.shape
    F, P = pi.shape
    K = 1 if train is None else train.shape[0]
    n_te = te_values.shape[0]
    G, W = F * K, P + 2
    gram = torch.empty((G, W, W), dtype=torch.float64, device="cuda")
    bic = torch.empty(G, dtype=torch.float64, device="cuda")
    fold_ll = torch.empty(G, dtype=torch.float64, device="cuda")
    out = torch.empty(F, dtype=torch.float32, device="cuda")
    if split_of:
        planned = _launch_plan(F, K, W, n_tr, _sm_count(tr_values.device))
        chunk = planned[0] if chunk is None else chunk
        split = planned[1] if split is None else split
    fn = bind(lib, "lg_cv_f32", 13, 8 if split_of else 6)
    ptrs = [None if t is None else t.data_ptr()
            for t in (tr_values, tr_valid, train, te_values, te_valid, test,
                      vi, pi, pm, gram, bic, fold_ll, out)]
    ints = [n_tr, n_te, D, F, K, P] + ([chunk, split] if split_of else [])
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*ptrs, *ints, stream)
        if err:
            raise RuntimeError(f"LG launch failed: CUDA error {err}")

    launch.fold_ll = fold_ll  # the kernel writes it: keep it alive
    return launch, (gram, bic, out), (chunk, split)


def lg_frame(torch, n, D, seed, folds=10):
    """(values, valid, train, test): n rows of a chain of D float32
    columns, every row valid, ``folds`` dense fold masks."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, D))
    x[:, 0] = rng.normal(size=n)
    for c in range(1, D):
        x[:, c] = 0.8 * x[:, c - 1] + rng.normal(size=n)
    fold = np.empty(n, np.int64)
    fold[rng.permutation(n)] = np.arange(n) % folds
    test = (fold[None] == np.arange(folds)[:, None]).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    return t(x), t(np.ones((n, D))), t(1.0 - test), t(test)


def same(torch, a, b, rtol, atol, label):
    """Holds b to a: NaN and infinities in the same places, the rest within
    rtol relative (plus atol); returns the largest difference."""
    a, b = a.double(), b.double()
    if not (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.isinf(), b.isinf())
            and torch.equal(a[a.isinf()], b[b.isinf()])):
        raise AssertionError(f"{label}: NaN or infinities differ")
    fin = a.isfinite()
    diff = (a[fin] - b[fin]).abs()
    if diff.numel() and not bool((diff <= atol + rtol * a[fin].abs()).all()):
        raise AssertionError(f"{label}: max diff {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def device_ms(torch, launch, runs=20):
    """The median device duration of one launch, in ms: ``runs`` launches
    back to back under ``torch.profiler``, each kernel's own start to end
    on the card (no launch gap, no host time)."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            launch()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if len(spans) != runs:
        raise AssertionError(f"{len(spans)} device operations traced for "
                             f"{runs} launches")
    return statistics.median(spans) / 1e3


def alternate(torch, chip_smoke, launches, device=False):
    """{impl: [timings]} in the order parent, change, change, parent; with
    ``device``, each timing also holds :func:`device_ms`."""
    times = {"parent": [], "change": []}
    for impl in ORDER:
        t = chip_smoke.time_kernel(torch, launches[impl])
        if device:
            t["device_ms"] = device_ms(torch, launches[impl])
        times[impl].append(t)
    return times


def split_times(torch, chip_smoke, call, splits, equal=None, device=False):
    """{"S<n>_ms": batched ms} of the change's kernel at every cluster
    size (and {"S<n>_device_ms": :func:`device_ms`} with ``device``), each
    launch's outputs the same bits as S = 1's (by ``equal``, default:
    equal values, NaN in the same places)."""
    equal = equal or (lambda a, b: torch.equal(a.nan_to_num(),
                                               b.nan_to_num()))
    out, first = {}, None
    for split in splits:
        launch, outs, _ = call(split)
        launch()
        torch.cuda.synchronize()
        outs = [o.clone() for o in outs]
        if first is None:
            first = outs
        elif not all(equal(a, b) for a, b in zip(first, outs)):
            raise AssertionError(f"S {split} is not bit-equal to S 1")
        out[f"S{split}_batched_ms"] = round(chip_smoke.cuda_median_ms(
            torch, launch, batch=chip_smoke.KERNEL_BATCH), 4)
        if device:
            out[f"S{split}_device_ms"] = round(device_ms(torch, launch), 5)
    return out


def main():
    import argparse

    parser = argparse.ArgumentParser(usage=__doc__)
    parser.add_argument("parent")
    parser.add_argument("out_json", nargs="?")
    parser.add_argument("--only", nargs="+", choices=KERNELS,
                        default=KERNELS)
    opts = parser.parse_args()
    import torch

    import chip_smoke
    from pybnesian_tpu_torch.ops.gaussian import family_tensors

    parent = os.path.abspath(opts.parent)
    card = chip_smoke.phase_environment(torch)
    libs = {"parent": build(parent, os.path.join(parent, "_ab_build")),
            "change": build(REPO, os.path.join(REPO, "_chipwork",
                                               "ab_build"))}
    entries = ("ckde_cv_whiten_f32", "lg_cv_f32", "ckde_cv_fold_reduce_f32")
    splits = {impl: {e: takes_split(tree, e) for e in entries}
              for impl, tree in (("parent", parent), ("change", REPO))}
    results = []

    def report(kernel, label, shape, times, split, err, work, sweep):
        bound_ms, by = chip_smoke.bound(card, *work)
        row = {"kernel": kernel, "case": label, "shape": shape,
               "change_split": split, "max_diff": err, "bound_ms": bound_ms,
               "bound_by": by,
               **{f"{impl}_{key}": [round(t[key], 5) for t in times[impl]]
                  for impl in times for key in ("ms", "batched_ms",
                                                "device_ms")
                  if key in times[impl][0]},
               **sweep}
        results.append(row)
        print("[ab] " + " ".join(f"{k}={v}" for k, v in row.items()),
              flush=True)

    reduce_cases = [("phase4", 15, 10, 1000), ("hc-cv", 8, 10, 800),
                    ("one-family", 1, 10, 800), ("holdout", 8, 1, 2000),
                    ("rows-100k", 15, 10, 10_000), ("wide", 80, 10, 800)]
    entry = "ckde_cv_fold_reduce_f32"
    for label, F, K, nte in reduce_cases if "reduce" in opts.only else []:
        args = chip_smoke.reduce_rows(torch, F, K, nte, seed=F * K + nte)
        calls = {impl: reduce_call(torch, libs[impl]["cv_whiten.cu"],
                                   splits[impl][entry], args)
                 for impl in libs}
        for impl in libs:
            calls[impl][0]()
        torch.cuda.synchronize()
        if not bits_equal(torch, calls["parent"][1][0],
                          calls["change"][1][0]):
            raise AssertionError(f"fold reduce {label}: the change is not "
                                 "bit-equal to the parent")
        times = alternate(torch, chip_smoke,
                          {impl: c[0] for impl, c in calls.items()},
                          device=True)
        sweep = split_times(torch, chip_smoke, lambda sp: reduce_call(
            torch, libs["change"]["cv_whiten.cu"], True, args, sp),
            range(1, min(K, 8) + 1), lambda a, b: bits_equal(torch, a, b),
            device=True) if splits["change"][entry] else {}
        report("ckde_cv_fold_reduce", label, f"F{F}xK{K}x{nte}", times,
               calls["change"][2], 0.0, chip_smoke.reduce_work(args), sweep)
        del args, calls

    cases = [
        ("phase4-dpad3", 10_000, 9000, 1000, [1 + f % 3 for f in range(15)]),
        ("dpad1", 10_000, 9000, 1000, [1] * 15),
        ("dpad16", 10_000, 9000, 1000, [16] + [1 + f for f in range(14)]),
        ("rows-100k", 100_000, 90_000, 10_000, [1 + f % 3 for f in range(15)]),
    ]
    for label, n, ntr, nte, widths in cases if "whiten" in opts.only else []:
        args = whiten_inputs(torch, n, ntr, nte, widths, seed=n + len(widths))
        calls = {impl: whiten_call(torch, libs[impl]["cv_whiten.cu"],
                                   splits[impl]["ckde_cv_whiten_f32"], args)
                 for impl in libs}
        for impl in libs:
            calls[impl][0]()
        torch.cuda.synchronize()
        err = max(same(torch, a, b, WHITEN_TOL, WHITEN_TOL,
                       f"whiten {label}")
                  for a, b in zip(calls["parent"][1], calls["change"][1]))
        times = alternate(torch, chip_smoke,
                          {impl: c[0] for impl, c in calls.items()})
        sweep = split_times(torch, chip_smoke, lambda sp: whiten_call(
            torch, libs["change"]["cv_whiten.cu"], True, args, sp),
            (1, 2, 4, 8)) if splits["change"]["ckde_cv_whiten_f32"] else {}
        report("ckde_cv_whiten", label,
               f"F{len(widths)}xK10x{ntr}x{nte}xd{max(widths)}", times,
               calls["change"][2], err, chip_smoke.whiten_work(args), sweep)
        del args, calls

    one_parent8 = [(t, [s]) for t in range(8) for s in range(8) if s != t]
    mix5 = [(0, []), (1, [0]), (2, [0, 1]), (3, []), (4, [3]), (1, [2, 3]),
            (2, [4])]
    one_parent5 = [(t, [s]) for t in range(5) for s in range(5) if s != t]
    v8, m8, _, _ = lg_frame(torch, 10_000, 8, seed=0)
    tr8, te8 = lg_frame(torch, 8_000, 1, seed=1)[2:]
    tv, tm = v8[:8000].contiguous(), m8[:8000].contiguous()
    sv, sm = v8[8000:].contiguous(), m8[8000:].contiguous()
    v5, m5, tr5, te5 = lg_frame(torch, 10_000, 5, seed=2)
    v20, m20, tr20, te20 = lg_frame(torch, 10_000, 20, seed=3)
    lg_cases = [
        ("hc-cv-one-parent", one_parent8, [tv, tm, tr8], [tv, tm, te8]),
        ("hc-holdout-one-parent", one_parent8, [tv, tm, None],
         [sv, sm, None]),
        ("cv-mix-families", mix5, [v5, m5, tr5], [v5, m5, te5]),
        ("cv-one-parent", one_parent5, [v5, m5, tr5], [v5, m5, te5]),
        ("w17", [(19, list(range(15)))], [v20, m20, tr20], [v20, m20, te20]),
        ("w20", [(19, list(range(18)))], [v20, m20, tr20], [v20, m20, te20]),
    ]
    for label, fams, tr, te in lg_cases if "lg" in opts.only else []:
        args = [*tr, *family_tensors(fams, np.float32, "cuda"), *te]
        calls = {impl: lg_call(torch, libs[impl]["lg_cv.cu"],
                               splits[impl]["lg_cv_f32"], args)
                 for impl in libs}
        for impl in libs:
            calls[impl][0]()
        torch.cuda.synchronize()
        err = max(same(torch, a, b, LG_RTOL, 0.0, f"lg {label}")
                  for a, b in zip(calls["parent"][1], calls["change"][1]))
        times = alternate(torch, chip_smoke,
                          {impl: c[0] for impl, c in calls.items()})
        sweep = split_times(torch, chip_smoke, lambda sp: lg_call(
            torch, libs["change"]["lg_cv.cu"], True, args, sp),
            (1, 2, 4, 8)) if splits["change"]["lg_cv_f32"] else {}
        K = 1 if tr[2] is None else tr[2].shape[0]
        report("lg_cv_stats", label,
               f"F{len(fams)}xK{K}xP{args[4].shape[1]}x{tr[0].shape[0]}"
               f"x{te[0].shape[0]}", times, calls["change"][2], err,
               chip_smoke.lg_work(args), sweep)
    out = {"card": card["smi"], "parent": parent, "results": results}
    if opts.out_json:
        with open(opts.out_json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
