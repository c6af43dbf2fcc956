"""Build and load the port's hand-written CUDA kernels.

Each source in ``pybnesian_tpu_torch/csrc`` is one plain-C shared library:
``nvcc`` compiles it for sm_90a at first use into the ignored
``pybnesian_tpu_torch/_build`` directory, under a name keyed by the
source's content and the flags, and ``ctypes`` loads it. Nothing builds at
import, so the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["build", "load", "nvcc", "SOURCES"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: every kernel source of the port, by file name under ``csrc/``
SOURCES = ("ckde_cv.cu", "cv_whiten.cu", "exp_chain.cu", "lg_cv.cu",
           "ucv_pairs.cu")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source: str) -> dict:
    """Compile ``csrc/<source>`` for sm_90a into ``_build`` unless a library
    for this source and these flags exists. Returns ``{"path", "built",
    "seconds", "ptxas"}``: ``built`` is False when an existing library was
    reused; ``ptxas`` holds nvcc's resource report (registers, shared
    memory, spills), kept beside the library, so a reused library reports
    it too. Safe to call from several threads or processes: each compiles
    to its own temporary name and renames it into place."""
    src_path = os.path.join(_SRC_DIR, source)
    with open(src_path, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    path = os.path.join(_BUILD_DIR, f"lib{stem}-{key[:16]}.so")
    if os.path.exists(path):
        report = ""
        if os.path.exists(path + ".ptxas"):
            with open(path + ".ptxas") as f:
                report = f.read()
        return {"path": path, "built": False, "seconds": 0.0,
                "ptxas": report}
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *_NVCC_FLAGS, "-o", tmp, src_path],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    # atomic: a concurrent build never loads a partial file, nor a report
    # without its library
    with open(tmp + ".ptxas", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp + ".ptxas", path + ".ptxas")
    os.replace(tmp, path)
    return {"path": path, "built": True, "seconds": seconds,
            "ptxas": proc.stderr}


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed. The
    caller sets each function's ``argtypes``: ``c_void_p`` for pointers and
    the stream, ``c_int`` for ints."""
    return ctypes.CDLL(build(source)["path"])
