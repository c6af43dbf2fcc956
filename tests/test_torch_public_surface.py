"""The port's public surface tracks the JAX package's.

Every name of ``pybnesian_tpu.__all__`` is in ``pybnesian_tpu_torch.__all__``,
and every module of ``pybnesian_tpu`` has its counterpart in the port,
unless the tables below list it under the roadmap item (ROADMAP.md, Queue
1) that will port it. A slice that ports a module and forgets its exports,
or exports a name still listed as open, fails here.
"""

from pathlib import Path

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb

# names of the JAX package not in the port yet, by the roadmap item that
# adds them
OPEN = {
    # two packages cannot both be registered as ``pybnesian``
    "never": {"install_as_pybnesian"},
}
# names of the port the JAX package has not: the device choice
PORT_ONLY = {"use_device"}
# modules of the JAX package with no counterpart in the port, by the
# roadmap item that ports them
OPEN_MODULES = {
    # the Pallas kernels; their Hopper counterparts are csrc/ckde_cv.cu
    # with ops/ckde_cv_kernel.py and ops/kde_kernel.py
    "replaced by CUDA kernels": {"ops/pallas_kde.py"},
}


def test_missing_names_are_the_open_items():
    missing = set(jpb.__all__) - set(tpb.__all__)
    assert missing == set().union(*OPEN.values())


def _modules(package):
    root = Path(package.__file__).parent
    return {str(p.relative_to(root)) for p in root.rglob("*.py")}


def test_missing_modules_are_the_open_items():
    missing = _modules(jpb) - _modules(tpb)
    assert missing == set().union(*OPEN_MODULES.values())


def test_extra_names_are_the_port_own():
    assert set(tpb.__all__) - set(jpb.__all__) == PORT_ONLY


def test_every_exported_name_resolves_in_the_port():
    for name in tpb.__all__:
        value = getattr(tpb, name)
        module = getattr(value, "__module__", None) or getattr(
            value, "__name__", "")
        assert not module.startswith("pybnesian_tpu.") and module != (
            "pybnesian_tpu"), name


def test_same_kinds_of_object_under_each_name():
    for name in set(jpb.__all__) & set(tpb.__all__):
        want, got = getattr(jpb, name), getattr(tpb, name)
        assert type(got).__name__ == type(want).__name__, name
        if isinstance(want, type):
            assert got.__name__ == want.__name__, name


def test_version():
    assert tpb.__version__ == jpb.__version__
