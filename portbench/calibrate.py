"""The readings that the limits of ``limits/<workload>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        --seconds <s> [--control-seeds 7,8,9] [--precision float32] \
        [--fault start|half --fault-seeds 4,5,6]

For each of ``--seeds``: the cell's set-up and a window of ``--seconds``
at the cell's own size, then the numbers its check compares (the lower
readings). For each of ``--control-seeds``: the control, the plain
reference in ``--precision`` (bfloat16 unless given) put in the program's
place, and the same numbers (the upper readings; in float32, the stated
precision, sound readings). For each of ``--fault-seeds``: the program
with ``--fault`` planted in its UCV search, as the program seeds. One JSON
line each, in one process, on the card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def plant(fault):
    """Break the program's UCV search underneath the harness: every
    search returns its start (``start``), or every search of a launch
    stops at half the launch's median iteration count (``half``)."""
    import numpy as np
    import pybnesian_tpu_torch.kde.ucv as ucv

    if fault == "start":
        def unmoved(X, valid, Ns, starts, d, diagonal, _orig=ucv._minimize):
            got = _orig(X, valid, Ns, starts, d, diagonal)
            return got._replace(x=np.asarray(starts, np.float64))
        ucv._minimize = unmoved
    elif fault == "half":
        def cut(X, valid, Ns, x0s, d, diagonal, max_iter,
                _orig=ucv.ucv_search_cuda):
            full = _orig(X, valid, Ns, x0s, d, diagonal, max_iter)
            its = int(full.iterations.float().median())
            return _orig(X, valid, Ns, x0s, d, diagonal, max(1, its // 2))
        ucv.ucv_search_cuda = cut
    else:
        raise ValueError(f"no fault {fault!r}")


def readings(cell, seed, seconds, control, device="cuda"):
    """{number: value} of one seed: the program's, or with ``control`` (a
    torch dtype) the reference's in that precision."""
    from portbench.harness import window

    session = cell.loop().SESSION(cell.config, cell.mix, seed, False, device)
    session.setup()
    t0 = time.perf_counter()
    if control is not None:
        outputs = session.control(control)
        calls = len(outputs)
    else:
        win = window.run(session.sync, session.call, seconds)
        outputs = session.outputs()
        calls = len(win.calls)
    made = time.perf_counter() - t0
    session.free()
    t0 = time.perf_counter()
    numbers = session.check(outputs)
    return {"seed": seed,
            "kind": "program" if control is None else f"control {control}",
            "calls": calls, "made_s": made,
            "check_s": time.perf_counter() - t0, "numbers": numbers}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--precision", default="bfloat16")
    parser.add_argument("--fault", choices=["start", "half"])
    parser.add_argument("--fault-seeds", default="")
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import device, spec

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload)
    card = device.card(torch)
    print(json.dumps({"card": card["name"],
                      "power_limit_w": card["power_limit_w"]}), flush=True)
    control = getattr(torch, args.precision)
    for seeds, how in ((args.seeds, None), (args.control_seeds, control)):
        for s in filter(None, seeds.split(",")):
            print(json.dumps(readings(cell, int(s), args.seconds, how)),
                  flush=True)
    if args.fault:
        plant(args.fault)
        for s in filter(None, args.fault_seeds.split(",")):
            line = readings(cell, int(s), args.seconds, None)
            line["kind"] = f"fault {args.fault}"
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
