"""The library key of ``pybnesian_tpu_torch/ops/cuda_build.py``, on the CPU.

A kernel library is keyed on its source, on every header of ``csrc/`` and
on the nvcc flags, so an edit of the kernels' shared header
(``csrc/common.cuh``) rebuilds every library instead of loading one built
from the old header. The tests work on a copy of ``csrc/`` and never run
nvcc.
"""

import shutil
from pathlib import Path

import pytest

from pybnesian_tpu_torch.ops import cuda_build
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

CSRC = Path(cuda_build.__file__).resolve().parent.parent / "csrc"


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(CSRC, tmp_path / "csrc")


def _key(source, csrc):
    return cuda_build.library_key(source, str(csrc))


@pytest.mark.parametrize("source", cuda_build.SOURCES)
def test_a_header_edit_changes_every_key(csrc, source):
    """Each source's key is a function of the files: the copy keys as the
    tree does; editing the shared header, or adding a header, gives a new
    key; a file that is no header counts for nothing."""
    key = _key(source, csrc)
    assert key == _key(source, CSRC)
    header = csrc / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _key(source, csrc)
    assert edited != key
    (csrc / "extra.cuh").write_text("// a second header\n")
    added = _key(source, csrc)
    assert added not in (key, edited)
    (csrc / "notes.txt").write_text("not a header\n")
    assert _key(source, csrc) == added


def test_the_source_and_the_flags_key_a_library(csrc, monkeypatch):
    """Every source has a key of its own; editing one source moves its key
    alone; other flags give other keys."""
    keys = {s: _key(s, csrc) for s in cuda_build.SOURCES}
    assert len(set(keys.values())) == len(keys)
    source = csrc / "lg_cv.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    moved = {s for s in keys if _key(s, csrc) != keys[s]}
    assert moved == {"lg_cv.cu"}
    monkeypatch.setattr(cuda_build, "_NVCC_FLAGS",
                        [*cuda_build._NVCC_FLAGS, "-lineinfo"])
    assert _key("ckde_cv.cu", csrc) != keys["ckde_cv.cu"]


def test_build_reuses_a_library_only_for_the_same_headers(csrc, tmp_path,
                                                          monkeypatch):
    """``build`` loads a library it finds under the key of the source and
    the headers, with its kept report, and compiles anew once the header
    changes (here nvcc stands in by raising)."""
    build_dir = tmp_path / "build"
    monkeypatch.setattr(cuda_build, "_SRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", str(build_dir))

    def nvcc():
        raise RuntimeError("nvcc would run")

    monkeypatch.setattr(cuda_build, "nvcc", nvcc)
    with pytest.raises(RuntimeError, match="nvcc would run"):
        cuda_build.build("lg_cv.cu")
    lib = build_dir / f"liblg_cv-{_key('lg_cv.cu', csrc)[:16]}.so"
    lib.write_bytes(b"")
    Path(f"{lib}.ptxas").write_text("the kept report")
    assert cuda_build.build("lg_cv.cu") == {
        "path": str(lib), "built": False, "seconds": 0.0,
        "ptxas": "the kept report"}
    header = csrc / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    with pytest.raises(RuntimeError, match="nvcc would run"):
        cuda_build.build("lg_cv.cu")
