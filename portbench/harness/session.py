"""What every loop shares: the device, the kernel builds, the reference's
inputs, and the relative error its checks compare."""

from __future__ import annotations

import concurrent.futures
import math

import torch


def relative(got, want):
    """|got - want| / |want|; 0 where both are the same infinity, inf
    where only one is finite."""
    if got == want:
        return 0.0
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-300)


class Session:
    """One cell's program state, on ``device`` ("cuda" on the card; "cpu"
    in the CPU tests, which take the port's plain route).

    A loop subclasses it with ``setup()``, ``call(i)`` (one call of the
    window; returns its units of work), ``outputs()`` (what the window's
    calls produced), ``control(dtype)`` (the same from the reference in
    ``dtype``, bfloat16 unless given, put in the program's place) and ``check(outputs)`` ({number:
    value}, each compared with its limit in ``limits/<cell>.json``; lower
    is better)."""

    def __init__(self, config, mix, seed, trace=False, device="cuda"):
        import pybnesian_tpu_torch as port

        self.port = port
        self.config = config
        self.mix = mix
        self.seed = int(seed)
        self.trace = trace
        self.device = torch.device(device)
        # host seconds inside score calls, where a loop records them
        self.spans = None
        port.use_device(self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def build(self):
        """Build the mix's kernel sources side by side (no-op on
        the CPU); returns {source: seconds nvcc took}."""
        if self.device.type != "cuda":
            return {}
        from pybnesian_tpu_torch.ops import cuda_build

        sources = self.mix["sources"]
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            done = list(pool.map(cuda_build.build, sources))
        return {s: r["seconds"] for s, r in zip(sources, done)}

    def reference_columns(self, cols):
        """A frame's columns as float64 tensors on the device: the
        reference's inputs (the same float32 values the program gets)."""
        return {k: torch.as_tensor(v, dtype=torch.float64,
                                   device=self.device)
                for k, v in cols.items()}

    def free(self):
        """Drop the program's state before the reference runs."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # the units a per-layer reader divides by (calls of the window)
    def pairs_programs(self, i):
        """Kernel #1's programs in call ``i`` as
        :func:`~.device.pairs_work` takes them, or None where the call
        launches no kernel #1 work the loop can count."""
        return None
