"""CVLikelihood.local_score_batch of the torch port against the JAX
package's, the slice as a whole.

The JAX package's state — column arrays, CV folds, network nodes, arcs and
node types — goes into the port through ``pybnesian_tpu_torch.interop``, so
both packages score the same folds on the same graph. Float64: rtol 1e-9 /
atol 1e-7; float32: rtol 5e-4 / atol 5e-3. The constant column ``z`` gives
families whose score is −inf in both packages.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pybnesian_tpu as pj
from pybnesian_tpu_torch import interop
from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs
from pybnesian_tpu_torch.ops.kde import ckde_cv_alldevice_flash
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


TOL = {np.float64: dict(rtol=1e-9, atol=1e-7),
       np.float32: dict(rtol=5e-4, atol=5e-3)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _columns(dtype, n=300, d=4, seed=0):
    rng = np.random.default_rng(seed)
    cols = {}
    prev = rng.normal(0, 1, n)
    for i in range(d):
        prev = np.sin(0.8 * prev) + 0.5 * prev + rng.normal(0, 0.6, n)
        cols[f"x{i}"] = prev
    cols["z"] = np.zeros(n)
    return {k: v.astype(dtype) for k, v in cols.items()}


def _families(names):
    xs = [n for n in names if n != "z"]
    d = len(xs)
    fams = []
    for i, v in enumerate(xs):
        fams += [(v, []), (v, [xs[(i + 1) % d]]),
                 (v, [xs[(i + 1) % d], xs[(i + 2) % d]])]
    return fams + [("z", []), ("x1", ["z"])]


def _state(model):
    """The JAX model's state as plain Python, as interop takes it."""
    return dict(nodes=model.nodes(), arcs=model.arcs(),
                node_types={n: model.node_type(n).ToString()
                            for n in model.nodes()})


def _networks(kind, names):
    arcs = [("x0", "x1"), ("x1", "x2")]
    if kind == "KDENetwork":
        jax_model = pj.KDENetwork(names, arcs)
    else:
        types = [(n, pj.CKDEType() if n in ("x0", "x2")
                  else pj.LinearGaussianCPDType()) for n in names]
        jax_model = pj.SemiparametricBN(names, arcs, types)
    return jax_model, interop.network(kind, **_state(jax_model))


@pytest.mark.parametrize("kind", ["KDENetwork", "SemiparametricBN"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_local_score_batch_matches_jax(kind, dtype):
    cols = _columns(dtype)
    names = list(cols)
    jax_score = pj.CVLikelihood(cols, k=3, seed=0)
    folds = [jax_score.cv.fold_indices(i) for i in range(3)]
    port_score = interop.cv_likelihood(cols, folds, device="cpu")
    jax_model, port_model = _networks(kind, names)
    assert port_model.arcs() == jax_model.arcs()
    fams = _families(names)

    want = jax_score.local_score_batch(jax_model, fams)
    before = ckde_cv_pairs.launches
    got = port_score.local_score_batch(port_model, fams)
    assert ckde_cv_pairs.launches == before  # CPU tensors: no kernel
    assert got.dtype == np.float64 and got.shape == (len(fams),)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    assert np.all(got[-2:] == -math.inf)
    assert np.all(np.isfinite(got[:-2]))


def test_port_folds_equal_jax_folds():
    """CrossValidation is numpy-seeded: both packages split alike."""
    from pybnesian_tpu_torch import CVLikelihood

    cols = _columns(np.float64)
    jax_cv = pj.CVLikelihood(cols, k=3, seed=5).cv
    port_cv = CVLikelihood(cols, k=3, seed=5, device="cpu").cv
    for i in range(3):
        for a, b in zip(jax_cv.fold_indices(i), port_cv.fold_indices(i)):
            np.testing.assert_array_equal(a, b)


def test_flash_route_on_cpu_does_not_count_launches():
    n, D = 64, 2
    rng = np.random.default_rng(0)
    t = torch.as_tensor
    args = (t(rng.normal(size=(n, D)).astype(np.float32)),
            torch.zeros(n, D), t([[0, 1]]), torch.ones(1, 2),
            t(np.arange(48)[None]), torch.ones(1, 48),
            t(np.arange(48, 64)[None]), torch.ones(1, 16))
    before = ckde_cv_pairs.launches
    out = ckde_cv_alldevice_flash(*args)
    assert ckde_cv_pairs.launches == before
    assert torch.isfinite(out).all()


def test_import_and_score_without_jax_or_pandas():
    """The port imports neither JAX nor the JAX package, and a dict of
    float arrays builds a DataFrame and scores without pandas or
    pyarrow."""
    code = (
        "import sys, numpy as np\n"
        "import pybnesian_tpu_torch as p\n"
        "rng = np.random.default_rng(0)\n"
        "df = p.DataFrame.wrap({c: rng.normal(size=60).astype(np.float32)"
        " for c in 'abc'})\n"
        "s = p.CVLikelihood(df, k=3, seed=0, device='cpu')\n"
        "lg = p.LinearGaussianCPDType()\n"
        "out = s.local_score_batch(p.SemiparametricBN(list('abc')),"
        " [('a', [], p.CKDEType()), ('b', ['a'], p.CKDEType()),"
        " ('c', ['a', 'b'], lg)])\n"
        "assert np.all(np.isfinite(out)), out\n"
        "print(sorted(m for m in ('jax', 'pybnesian_tpu', 'pandas',"
        " 'pyarrow') if m in sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
