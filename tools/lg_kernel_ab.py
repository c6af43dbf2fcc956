#!/usr/bin/env python3
"""Times the linear-Gaussian kernel (``lg_cv_stats``, ``csrc/lg_cv.cu``) of
one tree of the torch port, to compare two trees on one card.

    python3 tools/lg_kernel_ab.py TREE

TREE is the root of a checkout (or of a ``git archive`` of one) holding
``pybnesian_tpu_torch``; its kernel is built into its own ``_build`` and
imported from there. Run it on each tree in turns inside one call to the
card (parent, change, change, parent), since two calls may land on two
cards. Each case prints the median of 10 CUDA-event windows of one launch
(``ms``) and of 20 launches (``batched_ms``) beside ``chip_smoke.bound``
of its work (``chip_smoke.lg_work``), and the host ms of one whole float32
CV call (``batched_lg_cv_loglik`` from the families' index lists to its
scores on the host, as ``_KFoldEngine.lg_batch`` makes it; median of 10
after a warm call), at the shapes ``chip_smoke.py`` times:

- phase 8's ``hc`` (config3b's 8 columns, 8,000 training rows, 10 folds):
  every one-parent family (F 56) on the CV channel and on the holdout one
  (one fold of 8,000 rows, 2,000 test rows);
- phase 4's CV workload (5 columns, 10,000 rows, 10 folds): 7 families of
  0–2 parents, and every one-parent family (F 20).

Inputs are random (a seeded chain of normal columns, every row valid,
folds from a seeded permutation). Needs a GPU; imports neither JAX nor
the JAX package.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLDS = 10


def frame(torch, n, D, seed):
    """(values, valid) (n, D) float32 on the card: a chain of columns."""
    rng = np.random.default_rng(seed)
    x = np.empty((n, D))
    x[:, 0] = rng.normal(size=n)
    for c in range(1, D):
        x[:, c] = 0.8 * x[:, c - 1] + rng.normal(size=n)
    values = torch.as_tensor(x, dtype=torch.float32, device="cuda")
    return values, torch.ones_like(values)


def fold_masks(torch, n, seed):
    """(train, test) (K, n) float32 0/1 masks of K folds of a permutation."""
    fold = np.empty(n, np.int64)
    fold[np.random.default_rng(seed).permutation(n)] = np.arange(n) % FOLDS
    test = (fold[None] == np.arange(FOLDS)[:, None]).astype(np.float32)
    as_t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    return as_t(1.0 - test), as_t(test)


def main():
    import torch

    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    sys.path.insert(1, REPO)
    import chip_smoke
    from pybnesian_tpu_torch.ops import gaussian
    from pybnesian_tpu_torch.ops.lg_cv_kernel import lg_cv_stats

    card = chip_smoke.phase_environment(torch)
    t0 = time.perf_counter()
    from pybnesian_tpu_torch.ops import cuda_build

    built = cuda_build.build("lg_cv.cu")
    print(f"[lg ab] tree={tree} built={built['built']} "
          f"build_s={time.perf_counter() - t0:.2f} "
          f"spilling={chip_smoke.ptxas_spills(built['ptxas'])!r}", flush=True)

    one_parent8 = [(t, [s]) for t in range(8) for s in range(8) if s != t]
    mix5 = [(0, []), (1, [0]), (2, [0, 1]), (3, []), (4, [3]), (1, [2, 3]),
            (2, [4])]
    one_parent5 = [(t, [s]) for t in range(5) for s in range(5) if s != t]
    cases = []
    values, valid = frame(torch, 10_000, 8, seed=0)
    train, test = fold_masks(torch, 8_000, seed=1)
    tv, tvalid = values[:8_000].contiguous(), valid[:8_000].contiguous()
    cases.append(("hc-cv-one-parent", one_parent8,
                  [tv, tvalid, train], [tv, tvalid, test]))
    cases.append(("hc-holdout-one-parent", one_parent8,
                  [tv, tvalid, None],
                  [values[8_000:].contiguous(), valid[8_000:].contiguous(),
                   None]))
    values, valid = frame(torch, 10_000, 5, seed=2)
    train, test = fold_masks(torch, 10_000, seed=3)
    for label, fams in (("cv-mix-families", mix5),
                        ("cv-one-parent", one_parent5)):
        cases.append((label, fams, [values, valid, train],
                      [values, valid, test]))

    for label, fams, tr, te in cases:
        fam_t = gaussian.family_tensors(fams, np.float32, "cuda")
        args = [*tr, *fam_t, *te]
        t = chip_smoke.time_kernel(torch, lambda: lg_cv_stats(*args))
        bound_ms, by = chip_smoke.bound(card, *chip_smoke.lg_work(args))
        fields = {}
        if tr[2] is not None:
            def call():
                ft = gaussian.family_tensors(fams, np.float32, "cuda")
                return gaussian.batched_lg_cv_loglik(
                    tr[0], tr[1], tr[2], te[2], *ft).cpu()

            call()
            times = []
            for _ in range(10):
                t1 = time.perf_counter()
                call()
                times.append(time.perf_counter() - t1)
            fields["cv_call_host_ms"] = (
                f"{statistics.median(times) * 1e3:.4f}")
        P = fam_t[1].shape[1]
        print(f"[lg ab] tree={os.path.basename(tree)} case={label} "
              f"F_K_P_ntr_nte={len(fams)}x{1 if tr[2] is None else FOLDS}x"
              f"{P}x{tr[0].shape[0]}x{te[0].shape[0]} ms={t['ms']:.4f} "
              f"batched_ms={t['batched_ms']:.4f} bound_ms={bound_ms:.4f} "
              f"bound_by={by} "
              + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


if __name__ == "__main__":
    main()
