"""The port stands alone: no module of ``pybnesian_tpu_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package ``pybnesian_tpu``.

Checked twice: by importing every module of the port (and chip_smoke.py)
in a fresh interpreter and reading ``sys.modules``, and by reading every
import statement of their sources, the ones inside functions included.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pybnesian_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pybnesian_tpu")


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(REPO).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def test_importing_every_module_loads_no_jax():
    names = [_module_name(p) for p in SOURCES]
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pybnesian_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(names) > 40
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_import_statement_names_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


KERNEL_MODULES = ["ops/ckde_cv_kernel.py", "ops/kde_kernel.py",
                  "ops/ucv_kernel.py", "ops/cv_whiten_kernel.py",
                  "ops/lg_cv_kernel.py", "ops/exp_chain.py",
                  "ops/cuda_build.py"]


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_kernel_modules_are_checked(module):
    """Each module that binds a hand-written kernel is among the sources
    both checks above read, and imports neither JAX nor the JAX package
    at any depth of its imports within the port."""
    path = PORT / module
    assert path in SOURCES
    seen, todo = set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        tree = ast.parse(p.read_text(), filename=str(p))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert not any(_forbidden(a.name) for a in node.names), p
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0:
                    assert not (node.module and _forbidden(node.module)), p
                    continue
                base = p.parent
                for _ in range(node.level - 1):
                    base = base.parent
                parts = (node.module or "").split(".") if node.module else []
                target = base.joinpath(*parts)
                for cand in ([target.with_suffix(".py"),
                              target / "__init__.py"]
                             + [target / f"{a.name}.py" for a in node.names]):
                    if cand.exists():
                        todo.append(cand)
    assert len(seen) >= 1
