"""Concurrent native builds in the torch port (pybnesian_tpu_torch/_native).

Under pytest-xdist every worker imports every test file, so several
processes build the same library at the same moment. Six processes here
start one build of a tiny C source into a fresh directory together, through
``build_and_load`` (a ctypes library) or ``build_ext_and_import`` (a CPython
extension), and every one of them must load the result and call it.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest

import pybnesian_tpu_torch._native as native
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


PROCESSES = 6

# <regex> makes the compile take long enough for the builds to overlap
LIBRARY_SRC = textwrap.dedent("""\
    #include <regex>
    extern "C" int answer(void) {
        return std::regex_match("42", std::regex("[0-9]+")) ? 42 : 0;
    }
""")
EXTENSION_SRC = textwrap.dedent("""\
    #define PY_SSIZE_T_CLEAN
    #include <Python.h>
    static PyObject *answer(PyObject *self, PyObject *args) {
        return PyLong_FromLong(42);
    }
    static PyMethodDef methods[] = {
        {"answer", answer, METH_NOARGS, ""}, {NULL, NULL, 0, NULL}};
    static struct PyModuleDef mod = {
        PyModuleDef_HEAD_INIT, "tinyext", "", -1, methods};
    PyMODINIT_FUNC PyInit_tinyext(void) { return PyModule_Create(&mod); }
""")

# loads the loader module from its file alone (stdlib imports only), waits
# for the start file, builds, and prints what the built code returns
WORKER = textwrap.dedent("""\
    import importlib.util, os, sys, time
    loader, src, start, kind = sys.argv[1:5]
    spec = importlib.util.spec_from_file_location("native_loader", loader)
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    while not os.path.exists(start):
        time.sleep(0.001)
    if kind == "library":
        print(native.build_and_load(src).answer())
    else:
        print(native.build_ext_and_import(src, "tinyext").answer())
""")


@pytest.mark.parametrize("kind", ["library", "extension"])
def test_concurrent_builds_all_load(tmp_path, kind):
    name, text = (("tiny.cpp", LIBRARY_SRC) if kind == "library"
                  else ("tinyext.c", EXTENSION_SRC))
    src = tmp_path / name
    src.write_text(text)
    start = tmp_path / "start"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, native.__file__, str(src),
             str(start), kind],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(PROCESSES)
    ]
    time.sleep(0.5)  # let every process reach its wait
    start.write_text("")
    results = [p.communicate(timeout=120) for p in procs]
    for proc, (out, err) in zip(procs, results):
        assert proc.returncode == 0, err
        assert out.strip() == "42"
    stray = [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert stray == []
