#!/usr/bin/env python3
"""What limits the UCV pair-sums kernel (``csrc/ucv_pairs.cu``) on the GPU.

    python3 tools/ucv_sweep.py [--label NAME] [--sass-dir DIR]

1. Builds the kernel's library and reads its SASS (``cuobjdump -sass``):
   for the templated kernel at d 1, 3 and 16, the innermost loops that
   hold the ``ex2`` (``MUFU.EX2``) instructions, each with its instruction
   counts by opcode and its instructions per ``ex2``, i.e. per pair.
2. Times one ``ucv_pair_sums_cuda`` launch per CUDA-event window (``ms``)
   and windows of 20 back-to-back launches (``batched_ms``), medians of
   10: over d in 1, 2, 3, 4, 6, 8, 12, 16 at (10, 9000, d), and over N in
   2,000, 4,500, 9,000 and 18,000 at (10, N, 3) and (1, N, 3); each beside
   ``chip_smoke.bound`` (one ``ex2`` per pair on the SFU; the FP32
   operations of the form that runs, ``chip_smoke.ucv_work``'s count, at
   67 TFLOP/s) and the pairs per second.

Time that grows with d at small d says the FP32 instructions set the pace;
time flat in d says the SFU does. ``--label`` tags the lines, so that two
trees' runs can be told apart in one call. With ``--sass-dir``, the d 3
kernels' SASS goes to ``DIR/ucv_sass_<label>.txt``.
Needs a GPU; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WIDTHS = (1, 2, 3, 4, 6, 8, 12, 16)
ROWS = (2_000, 4_500, 9_000, 18_000)


def cuobjdump():
    from pybnesian_tpu_torch.ops.cuda_build import nvcc

    return os.path.join(os.path.dirname(nvcc()), "cuobjdump")


def sass_functions(path):
    """{mangled function name: [SASS lines]} of a shared library."""
    out = subprocess.run([cuobjdump(), "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def instructions(lines):
    """[(address, instruction text)] of a function's SASS lines."""
    out = []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m:
            out.append((int(m.group(1), 16), m.group(2)))
    return out


def loops(lines):
    """The instruction lists of the function's loops, from the target of a
    backward branch to the branch, innermost first. cuobjdump prints a
    branch's target as an address (``BRA 0x1a0``) or a label
    (``BRA `(.L_x_3)``) whose line holds the address."""
    body = instructions(lines)
    labels = {}
    for i, line in enumerate(lines):
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            nxt = instructions(lines[i + 1: i + 3])
            if nxt:
                labels[lab.group(1)] = nxt[0][0]
    found = []
    for i, (addr, ins) in enumerate(body):
        br = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)", ins)
        if not br:
            continue
        tgt = br.group(1)
        tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
        if tgt is not None and tgt <= addr:
            found.append([t for a, t in body[:i + 1] if a >= tgt])
    return sorted(found, key=len)


def opcode(ins):
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
    return ins.split()[0]


def sass_report(label, sass_dir):
    from pybnesian_tpu_torch.ops import cuda_build

    path = cuda_build.build("ucv_pairs.cu")["path"]
    if not os.path.exists(cuobjdump()):
        print(f"[ucv sass] label={label} no cuobjdump beside nvcc",
              flush=True)
        return
    funcs = sass_functions(path)
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        with open(os.path.join(sass_dir, f"ucv_sass_{label}.txt"), "w") as f:
            for name, lines in funcs.items():
                if "ucv_pairs_kernelILi3E" in name:
                    f.write(f"Function : {name}\n" + "\n".join(lines)
                            + "\n")
    for d in (1, 3, 16):
        for name, lines in funcs.items():
            if f"ucv_pairs_kernelILi{d}E" not in name:
                continue
            whole = collections.Counter(opcode(t)
                                        for _, t in instructions(lines))
            print(f"[ucv sass] label={label} d={d} function_instructions="
                  f"{sum(whole.values())} ex2={whole.get('MUFU.EX2', 0)}",
                  flush=True)
            for body in loops(lines):
                ops = collections.Counter(opcode(i) for i in body)
                ex2 = ops.get("MUFU.EX2", 0)
                if not ex2:
                    continue
                top = ", ".join(f"{k} {v}" for k, v in ops.most_common(12))
                print(f"[ucv sass] label={label} d={d} loop_instructions="
                      f"{len(body)} ex2={ex2} instructions_per_pair="
                      f"{len(body) / ex2:.3f} fp32_per_pair="
                      f"{sum(v for k, v in ops.items() if k.split('.')[0] in ('FADD', 'FFMA', 'FMUL', 'FSEL', 'FMNMX')) / ex2:.3f} "
                      f"opcodes={top!r}", flush=True)


def sweep(torch, card, label):
    import chip_smoke
    from pybnesian_tpu_torch.ops.ucv_kernel import ucv_pair_sums_cuda

    rng = np.random.default_rng(0)
    cases = [(10, 9_000, d) for d in WIDTHS]
    cases += [(B, n, 3) for B in (10, 1) for n in ROWS]
    for B, N, d in dict.fromkeys(cases):
        white = torch.as_tensor(rng.normal(0, 4.0 / np.sqrt(d), (B, N, d)),
                                dtype=torch.float32, device="cuda")
        t = chip_smoke.time_kernel(torch, lambda: ucv_pair_sums_cuda(white))
        work = chip_smoke.ucv_work(white, None)
        bound_ms, by = chip_smoke.bound(card, *work)
        print(f"[ucv sweep] label={label} B_N_d={B}x{N}x{d} "
              f"ms={t['ms']:.4f} batched_ms={t['batched_ms']:.4f} "
              f"bound_ms={bound_ms:.4f} bound_by={by} "
              f"share={bound_ms / t['ms']:.4f} "
              f"batched_share={bound_ms / t['batched_ms']:.4f} "
              f"gpairs_per_s={work[0] / t['batched_ms'] / 1e6:.2f}",
              flush=True)


def main():
    import torch

    import chip_smoke

    parser = argparse.ArgumentParser()
    parser.add_argument("--label", default="tree")
    parser.add_argument("--sass-dir", default=None)
    args = parser.parse_args()
    card = chip_smoke.phase_environment(torch)
    sass_report(args.label, args.sass_dir)
    sweep(torch, card, args.label)


if __name__ == "__main__":
    main()
