#!/usr/bin/env python3
"""Times kernels #1 (``ckde_cv_pairs``) and #2 (``kde_logl``) of one tree of
the torch port, to compare two trees on one card.

    python3 tools/kernel_ab.py TREE

TREE is the root of a checkout (or of a ``git archive`` of one) holding
``pybnesian_tpu_torch``; its kernels are built into its own ``_build`` and
imported from there. Run it on each tree in turns inside one call to the
card (parent, change, change, parent), since two calls may land on two
cards. Each shape prints the launch plan and the median of 10 CUDA-event
windows of one launch (``ms``) and of 20 launches (``batched_ms``):

- the CV path's inputs (G 150, 9,000 × 1,000, dpad 3) and the Pallas KDE
  kernel's shape (G 1, 10,240², d 3), where the plan splits the train
  axis 8 ways;
- G 600 at the CV shape and ``hc``'s cache pass (G 640, 7,200 × 800, dpad
  2), which the plan splits 4 ways, and the CV path at 100,000 rows (G
  150, 90,000 × 10,000), split 2 ways.

Inputs are random (``chip_smoke.pair_inputs``'s recipe, seeded). Needs a
GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np

SHAPES = {"cv-G150": (150, 9000, 1000, 3), "cv-G600": (600, 9000, 1000, 3),
          "cv-100k": (150, 90_000, 10_000, 3),
          "hc-G640": (640, 7200, 800, 2)}
KDE_SHAPE = (1, 10_240, 10_240, 3)


def pair_inputs(torch, G, ntr, nte, dpad, seed):
    """~10% null train rows, every third program evidence-free."""
    r = np.random.default_rng(seed)
    jtr = r.normal(0, 3, (G, ntr, dpad)).astype(np.float32)
    jte = r.normal(0, 3, (G, nte, dpad)).astype(np.float32)
    neg = np.where(r.random((G, ntr)) < 0.1, -np.inf, 0.0).astype(np.float32)
    no_ev = (np.arange(G) % 3 == 1).astype(np.float32)
    lm = np.log(np.maximum((neg == 0).sum(1), 1)).astype(np.float32)
    arrays = [jtr, neg, np.ascontiguousarray(jtr[..., -1]), jte,
              np.ascontiguousarray(jte[..., -1]), no_ev, lm]
    return [torch.as_tensor(a, device="cuda") for a in arrays]


def median_ms(torch, fn, runs=10, batch=1):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    import torch

    from pybnesian_tpu_torch.ops import ckde_cv_kernel as ck
    from pybnesian_tpu_torch.ops import kde_kernel as kk

    if not ck.__file__.startswith(os.path.join(tree, "pybnesian_tpu_torch")):
        raise SystemExit(f"imported {ck.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a GPU")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, shape in SHAPES.items():
        args = pair_inputs(torch, *shape, seed=1)

        def call():
            return ck.ckde_cv_pairs(*args)

        out[label] = {"plan": ck._launch_plan(*shape, sms),
                      "ms": median_ms(torch, call),
                      "batched_ms": median_ms(torch, call, batch=20)}
        del args
    t = pair_inputs(torch, *KDE_SHAPE, seed=2)
    kargs = [t[0], (t[1] == 0).float(), t[3], t[6]]
    out["kde-10240"] = {"plan": ck._launch_plan(*KDE_SHAPE, sms),
                        "ms": median_ms(torch, lambda: kk.kde_logl(*kargs)),
                        "batched_ms": median_ms(
                            torch, lambda: kk.kde_logl(*kargs), batch=20)}
    print("kernel_ab", tree, json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
