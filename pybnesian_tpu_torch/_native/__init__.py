"""Native-core build/load helper shared by every compiled component
(graph closure, discrete scoring, benchmark baselines).

Staleness is decided by a CONTENT hash of the source stored next to the
library — git checkouts do not preserve mtimes, so an mtime comparison
would happily load a stale (or foreign-ISA) binary after a fresh clone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

__all__ = ["build_and_load", "build_ext_and_import"]


def build_and_load(src_path: str, lib_path: str | None = None):
    """Compile ``src_path`` to a shared library (g++ -O3 -march=native) if
    its content hash changed, then ``ctypes.CDLL`` it. Returns the loaded
    library, or raises on toolchain failure (callers decide whether a
    numpy fallback exists)."""
    if lib_path is None:
        base, _ = os.path.splitext(src_path)
        name = os.path.basename(base)
        lib_path = os.path.join(os.path.dirname(src_path), f"lib{name}.so")
    stamp_path = lib_path + ".sha"
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    current = None
    if os.path.exists(stamp_path):
        with open(stamp_path) as f:
            current = f.read().strip()
    if not os.path.exists(lib_path) or current != digest:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-pthread", "-shared", "-fPIC",
             src_path, "-o", lib_path],
            check=True,
            capture_output=True,
        )
        with open(stamp_path, "w") as f:
            f.write(digest)
    return ctypes.CDLL(lib_path)


def build_ext_and_import(src_path: str, modname: str):
    """Compile ``src_path`` as a CPython EXTENSION module (PyInit_<modname>)
    and import it. Unlike :func:`build_and_load`, calls into the result pay
    normal extension-call overhead (~0.2 µs) instead of ctypes marshalling —
    this is what makes the serial-workload tiers viable (config-1 budget is
    tens of µs per whole pipeline). Content-hash staleness like
    build_and_load; raises on toolchain failure."""
    import sysconfig

    so_path = os.path.join(os.path.dirname(src_path), f"{modname}.so")
    stamp_path = so_path + ".sha"
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    current = None
    if os.path.exists(stamp_path):
        with open(stamp_path) as f:
            current = f.read().strip()
    if not os.path.exists(so_path) or current != digest:
        inc = sysconfig.get_paths()["include"]
        subprocess.run(
            ["g++", "-O3", "-march=native", "-funroll-loops", "-shared",
             "-fPIC", f"-I{inc}", src_path, "-o", so_path],
            check=True,
            capture_output=True,
        )
        with open(stamp_path, "w") as f:
            f.write(digest)
    import importlib.util

    spec = importlib.util.spec_from_file_location(modname, so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
