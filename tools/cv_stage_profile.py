#!/usr/bin/env python3
"""The float32 CV path of one tree of the torch port, by stage, to compare
two trees on one card.

    python3 tools/cv_stage_profile.py TREE

TREE is the root of a checkout (or of a ``git archive`` of one) holding
``pybnesian_tpu_torch``; its kernels are built into its own ``_build`` and
imported from there. Run it on each tree in turns inside one call to the
card (parent, change, change, parent), since two calls may land on two
cards. On ``chip_smoke.py`` phase 4's workload (bench.py's data: 10,000
rows × 5 float32 columns, 15 CKDE families, 10 folds, normal-reference
rule) it prints:

- ``median_call_ms``: the median of 30 timed ``local_score_batch`` calls
  after 4 untimed ones, the family set rotated as in phase 4 (host clock,
  each call ends in a device read);
- one ``ckde_cv_alldevice_flash`` call on the first batch's inputs under
  ``torch.profiler``: its device operations and their device ms in three
  stages — the whitening (every operation before the first launch of the
  pairs kernel), the pairs kernel, the fold sums (every operation after
  its last launch) — and the names of the first two stages' operations.

Needs a GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = 30


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import pybnesian_tpu_torch as p
    from pybnesian_tpu_torch.learning.scores.likelihood import (
        _family_columns)
    from pybnesian_tpu_torch.ops.kde import ckde_cv_alldevice_flash

    if not p.__file__.startswith(os.path.join(tree, "pybnesian_tpu_torch")):
        raise SystemExit(f"imported {p.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("cv_stage_profile.py needs a GPU")
    sys.path.insert(1, REPO)
    from chip_smoke import families, make_data

    frame = p.DataFrame.wrap(make_data())
    d = frame.num_columns
    score = p.CVLikelihood(frame, k=10, seed=0)
    model = p.KDENetwork(frame.column_names())
    shifts = [1 + c % (d - 2) for c in range(4 + RUNS)]
    times = []
    for c, s in enumerate(shifts):
        batch = [(v, ps, p.CKDEType()) for v, ps in families(d, s)]
        t0 = time.perf_counter()
        score.local_score_batch(model, batch)
        if c >= 4:
            times.append(time.perf_counter() - t0)

    pos, data, null, tr_idx, tr_mask, te_idx, te_mask = (
        score._engine._device_cv_cache())
    col_idx, col_mask = _family_columns(families(d, 1), pos)
    args = (data, null, torch.as_tensor(col_idx, device="cuda"),
            torch.as_tensor(col_mask, dtype=torch.float32, device="cuda"),
            tr_idx, tr_mask, te_idx, te_mask)
    ckde_cv_alldevice_flash(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ckde_cv_alldevice_flash(*args)
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    pairs = [i for i, e in enumerate(ops) if "pairs_kernel" in e.name]
    if not pairs:
        raise SystemExit("the call launched no pairs kernel")
    stages = {"whitening": ops[:pairs[0]],
              "pairs": ops[pairs[0]:pairs[-1] + 1],
              "fold_sums": ops[pairs[-1] + 1:]}

    def ms(es):
        return sum(e.time_range.end - e.time_range.start for e in es) / 1e3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    out = {"tree": tree, "card": smi,
           "median_call_ms": statistics.median(times) * 1e3,
           "call_ms_min_max": [min(times) * 1e3, max(times) * 1e3],
           "stages": {name: {"device_ops": len(es), "device_ms": ms(es)}
                      for name, es in stages.items()},
           "whitening_ops": [e.name[:60] for e in stages["whitening"]],
           "fold_sum_ops": [e.name[:60] for e in stages["fold_sums"]]}
    print("cv_stage_profile", json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
