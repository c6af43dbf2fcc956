"""Run one cell of the benchmark of ``pybnesian_tpu_torch`` on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (data from the seed, kernel builds, warm calls), then a closed-loop
window of ``--seconds``, then the check of what the window produced
against the plain reference (``portbench/reference``). With ``--trace 1``
the window records host spans and launch counts, and a profiled
sub-window follows it. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` when traced), then the numbers compared under
``checked``. Exits non-zero with no result without a CUDA card, or when
JAX or the JAX package was loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# one process, few threads: the host's math libraries run single-threaded
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "pybnesian_tpu")


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules, compared
    whole (``pybnesian_tpu_torch`` is not ``pybnesian_tpu``)."""
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


class Run:
    """What a metric reader reads: the window, the launches in it, the
    spans, the profiled sub-window, the card and the session."""

    def __init__(self, session, setup_s, window, launches, spans, profile,
                 card):
        self.session = session
        self.setup_s = setup_s
        self.window = window
        self.launches = launches
        self.spans = spans
        self.profile = profile
        self.card = card


def execute(cell, seed, seconds, trace, device="cuda", card=None):
    """Set up, measure and check one cell: the result's dict, with the
    numbers compared under ``checked``."""
    import torch

    from portbench.harness import program, trace as tracing, window

    loop = cell.loop()
    session = loop.SESSION(cell.config, cell.mix, seed, trace, device)
    print(f"imports {time.perf_counter() - START:.3f} s", file=sys.stderr)
    session.setup()
    session.sync()
    setup_s = time.perf_counter() - START
    print(f"set-up {setup_s:.3f} s (builds {session.built})", file=sys.stderr)
    before = program.launches()
    win = window.run(session.sync, session.call, seconds)
    print(f"window {win.seconds:.3f} s, {len(win.calls)} calls",
          file=sys.stderr)
    launches = {k: v - before[k] for k, v in program.launches().items()}
    spans = None if session.spans is None else dict(session.spans)
    peak = (torch.cuda.max_memory_allocated()
            if session.device.type == "cuda" else 0)
    profile = None
    if trace:
        profile = tracing.profiled(session.sync, session.call,
                                   cell.mix["trace_calls"])
    run = Run(session, setup_s, win, launches, spans, profile, card)
    metrics = {}
    for entry, reader in cell.metrics(trace):
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    outputs = session.outputs()
    session.free()
    t0 = time.perf_counter()
    numbers = session.check(outputs)
    print(f"check {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    checked = {}
    for name, value in numbers.items():
        limit = cell.limits["numbers"][name]["limit"]
        # JSON has no infinity: a number that is not finite is its repr
        checked[name] = {"value": value if math.isfinite(value)
                         else repr(value), "limit": limit}
    correct = bool(numbers) and all(
        math.isfinite(v) and v <= cell.limits["numbers"][k]["limit"]
        for k, v in numbers.items())
    result = {
        "correct": correct,
        "attempted": len(win.calls),
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu",
            "kind": card["name"] if card else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
            "power_limit_w": card["power_limit_w"] if card else None,
        },
    }
    if profile is not None:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": profile.device_ops(),
                               "idle_gaps": profile.idle_gaps()}
    result["checked"] = checked
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import device, spec

    print(f"torch imported {time.perf_counter() - START:.3f} s",
          file=sys.stderr)
    cell = spec.Cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = device.card(torch)
    print(f"card read {time.perf_counter() - START:.3f} s", file=sys.stderr)
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", card)
    for name, c in result["checked"].items():
        print(f"checked {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
