"""Build and load the port's hand-written CUDA kernels, and the Python face
of what their sources share.

Each source in ``pybnesian_tpu_torch/csrc`` is one plain-C shared library:
``nvcc`` compiles it for sm_90a at first use into the ignored
``pybnesian_tpu_torch/_build`` directory, under a name keyed by the
source's content, every header of ``csrc`` and the flags, and ``ctypes``
loads it. Nothing builds at import, so the CPU tests import every module
without ``nvcc``.

The kernels' shared header, ``csrc/common.cuh``, holds the fixed-leaf rule
of their sums; :func:`leaf_count` and the constants below mirror it, and
:func:`cluster_split` is the rule by which every launch plan spreads a
program's leaves over a thread-block cluster. :func:`check_tensors` is the
wrappers' argument check.
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

import torch

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
# The fixed-leaf rule of csrc/common.cuh; each mirrors a constant there.
#: most leaves of a program's rows (kMaxLeaves)
MAX_LEAVES = 8
#: least rows of a leaf when there are two or more (kLeafRows)
LEAF_ROWS = 256
#: most blocks of one cluster, the portable limit (kMaxSplit)
MAX_SPLIT = 8


def leaf_count(n):
    """L, the leaves of a program's n rows in every kernel that sums them
    over fixed leaves (``leaf_count`` in ``csrc/common.cuh``): the largest
    power of two up to :data:`MAX_LEAVES` that leaves each leaf
    :data:`LEAF_ROWS` rows, 1 below two leaves' worth. Leaf l holds rows
    [l·size, min(n, (l + 1)·size)), size = ceil(n / L); its sums run in a
    fixed order and the L leaves merge in a balanced tree. A function of n
    alone, so a program's float32 results do not depend on the batch, on
    the other programs or on the cluster size."""
    leaves = 1
    while 2 * leaves <= MAX_LEAVES and 2 * leaves * LEAF_ROWS <= n:
        leaves *= 2
    return leaves


def cluster_split(blocks, target, leaves, grow=None):
    """S, the blocks of the thread-block cluster that shares each program's
    ``leaves`` leaves, for a grid of ``blocks`` clusters: the least power of
    two that gives the grid ``target`` blocks, at most the leaves, so that
    every block sweeps as many leaves as the others; doubling also stops
    where ``grow(S)`` is false. S only decides which block sweeps which
    leaf: the result is the same at every S."""
    split = 1
    while (blocks * split < target and split < leaves
           and (grow is None or grow(split))):
        split *= 2
    return split


def check_tensors(tensors, dtypes, shapes, device):
    """Raises unless each ``tensors[name]`` is a contiguous torch.Tensor of
    dtype ``dtypes[name]`` (``dtypes`` may be one dtype for all) and shape
    ``shapes[name]`` on ``device``: TypeError for the type or the dtype,
    ValueError for the rest. The kernel wrappers' argument check."""
    for name, t in tensors.items():
        want = dtypes[name] if isinstance(dtypes, dict) else dtypes
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_key(source: str, src_dir: str) -> str:
    """The key of ``source``'s library: a hash of the source, of every
    header (``.cuh``, ``.h``) of ``src_dir`` by name, and of the flags, so
    that an edit of a shared header rebuilds every library."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(src_dir)
                     if f.endswith((".cuh", ".h")))
    for name in (source, *headers):
        with open(os.path.join(src_dir, name), "rb") as f:
            text = f.read()
        digest.update(f"{name}:{len(text)}:".encode() + text)
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return digest.hexdigest()


def build(source: str) -> dict:
    """Compile ``csrc/<source>`` for sm_90a into ``_build`` unless a library
    for this source, the headers of ``csrc`` and these flags exists
    (:func:`library_key`). Returns ``{"path", "built",
    "seconds", "ptxas"}``: ``built`` is False when an existing library was
    reused; ``ptxas`` holds nvcc's resource report (registers, shared
    memory, spills), kept beside the library, so a reused library reports
    it too. Safe to call from several threads or processes: each compiles
    to its own temporary name and renames it into place."""
    src_path = os.path.join(_SRC_DIR, source)
    key = library_key(source, _SRC_DIR)
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
