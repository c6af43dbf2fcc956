#!/usr/bin/env python3
"""The float32 UCV search of this tree against another tree's, on one GPU.

    python3 tools/ucv_search_ab.py PARENT [OUT.json]

PARENT is another checkout of the repository (for example ``git archive
<commit> | tar -x -C _chipwork/parent``). The script runs four child
processes in turn — PARENT, this tree, this tree, PARENT — each importing
its own tree's package and building its own kernels, and each times on
the same data made from a seed:

1. ``chip_smoke.py`` phase 9 (b)'s float32 batch: ``CVLikelihood`` with
   UCV as the CKDE selector, ``local_score_batch`` of one family each of
   0, 1 and 2 parents on bench.py's 10,000 rows, 10 folds (a warm call,
   then the median wall of 3 calls);
2. those families' searches alone (``_ucv_bandwidths``: one batched search
   per family width, 10 problems of 9,000 rows each): the median wall of
   3, with their iterations and evaluations;
3. one search of ``tools/ucv_profile.py``'s (10, 9000, 3) problems
   (``ucv_search_batch``): the median wall of 3 and the median of 3
   CUDA-event windows.

Each child prints one line ``AB {json}``; the parent process prints them
again with the card's name and power limit, and writes them to OUT.json
when given. Needs a GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = 3


def child(tree):
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    import pybnesian_tpu_torch as p
    from pybnesian_tpu_torch.kde.ucv import ucv_search_batch, vech

    def median_wall(fn):
        walls = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    frame = p.DataFrame.wrap(chip_smoke.make_data())
    names = frame.column_names()
    fams = [(names[0], []), (names[1], [names[0]]),
            (names[2], [names[0], names[1]])]
    score = p.CVLikelihood(frame, k=10, seed=0, construction_args=p.Arguments(
        {p.CKDEType(): p.Kwargs(bandwidth_selector=p.UCV())}))
    model = p.KDENetwork(names)
    typed = [(v, ps, p.CKDEType()) for v, ps in fams]
    score.local_score_batch(model, typed)                  # warm, and builds
    batch_s = median_wall(lambda: score.local_score_batch(model, typed))
    untyped = [(v, ps, None) for v, ps in fams]
    _maps, searches = score._engine._ucv_bandwidths(untyped)
    searches_s = median_wall(lambda: score._engine._ucv_bandwidths(untyped))

    rng = np.random.default_rng(0)
    white = rng.normal(0, 1.0, (10, 9000, 3))
    knr = (4.0 / (9000 * 5.0)) ** (2.0 / 7.0)
    x0s = np.stack([vech(np.linalg.cholesky(knr * np.cov(x, rowvar=False)))
                    for x in white])
    args = (white, np.ones(white.shape[:2]), np.full(10, 9000.0), x0s, 3)

    def one():
        return ucv_search_batch(*args, dtype=np.float32, device="cuda")

    found = one()
    one_s = median_wall(one)
    one_ms = chip_smoke.cuda_median_ms(torch, one, runs=RUNS)
    print("AB " + json.dumps({
        "tree": tree, "batch_s": batch_s, "searches_s": searches_s,
        "searches_evaluations": [s.evaluations for s in searches],
        "searches_iterations_max": [int(s.iterations.max())
                                    for s in searches],
        "one_search_s": one_s, "one_search_event_ms": one_ms,
        "one_search_iterations_max": int(found.iterations.max()),
        "one_search_evaluations": found.evaluations}), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(os.path.abspath(sys.argv[2]))
        return
    parent = os.path.abspath(sys.argv[1])
    out = sys.argv[2] if len(sys.argv) > 2 else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lines = []
    for tree in (parent, HERE, HERE, parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree],
            capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        row = json.loads(line[-1][3:])
        row["role"] = "parent" if tree == parent else "change"
        lines.append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    if out:
        with open(out, "w") as f:
            json.dump({"card": smi, "runs": lines}, f, indent=1)


if __name__ == "__main__":
    main()
