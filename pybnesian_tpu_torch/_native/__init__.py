"""Native-core build/load helper shared by every compiled component
(graph closure, discrete scoring, benchmark baselines).

Staleness is decided by a CONTENT hash of the source stored next to the
library — git checkouts do not preserve mtimes, so an mtime comparison
would happily load a stale (or foreign-ISA) binary after a fresh clone.
Builds are safe to race: one process builds under a lock file while the
others wait, and every file lands under its final name by a rename.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess

__all__ = ["build_and_load", "build_ext_and_import"]


def _digest(src_path: str) -> str:
    with open(src_path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _is_current(out_path: str, digest: str) -> bool:
    try:
        with open(out_path + ".sha") as f:
            return os.path.exists(out_path) and f.read().strip() == digest
    except FileNotFoundError:
        return False


@contextlib.contextmanager
def _build_lock(out_path: str):
    """Exclusive ``flock`` on ``<out_path>.lock`` while one process builds:
    the others wait, then find the fresh library and skip their build."""
    with open(out_path + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build(cmd_head: list, src_path: str, out_path: str) -> None:
    """Compile ``src_path`` to ``out_path`` with ``cmd_head`` (g++ and its
    flags) unless the ``.sha`` stamp beside ``out_path`` holds the source's
    content hash. The compiler writes to a per-process temporary name that
    is then renamed onto ``out_path``; the stamp follows the same way,
    after the library. Concurrent callers (pytest-xdist workers) serialise
    on a lock file and never load a partial library."""
    digest = _digest(src_path)
    if _is_current(out_path, digest):
        return
    with _build_lock(out_path):
        if _is_current(out_path, digest):
            return
        tmp = f"{out_path}.{os.getpid()}.tmp"
        try:
            subprocess.run([*cmd_head, src_path, "-o", tmp], check=True,
                           capture_output=True)
            os.replace(tmp, out_path)
            with open(tmp, "w") as f:
                f.write(digest)
            os.replace(tmp, out_path + ".sha")
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def build_and_load(src_path: str, lib_path: str | None = None):
    """Compile ``src_path`` to a shared library (g++ -O3 -march=native) if
    its content hash changed, then ``ctypes.CDLL`` it. Returns the loaded
    library, or raises on toolchain failure (callers decide whether a
    numpy fallback exists)."""
    if lib_path is None:
        base, _ = os.path.splitext(src_path)
        name = os.path.basename(base)
        lib_path = os.path.join(os.path.dirname(src_path), f"lib{name}.so")
    _build(["g++", "-O3", "-march=native", "-pthread", "-shared", "-fPIC"],
           src_path, lib_path)
    return ctypes.CDLL(lib_path)


def build_ext_and_import(src_path: str, modname: str):
    """Compile ``src_path`` as a CPython EXTENSION module (PyInit_<modname>)
    and import it. Unlike :func:`build_and_load`, calls into the result pay
    normal extension-call overhead (~0.2 µs) instead of ctypes marshalling —
    this is what makes the serial-workload tiers viable (config-1 budget is
    tens of µs per whole pipeline). Content-hash staleness like
    build_and_load; raises on toolchain failure."""
    import importlib.util
    import sysconfig

    so_path = os.path.join(os.path.dirname(src_path), f"{modname}.so")
    inc = sysconfig.get_paths()["include"]
    _build(["g++", "-O3", "-march=native", "-funroll-loops", "-shared",
            "-fPIC", f"-I{inc}"], src_path, so_path)
    spec = importlib.util.spec_from_file_location(modname, so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
