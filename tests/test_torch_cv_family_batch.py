"""``CVLikelihood(k=10).local_score_batch`` of the 15 CKDE families a
structure search scores together (each of 5 chain columns with 0, 1 and 2
parents: the next columns after a shift), against the JAX package's
float64 scores on the same folds.

The port scores float32 columns; the JAX package the same values in
float64: rtol 5e-4 / atol 5e-3, the float32 tolerance of
``test_torch_cvlikelihood.py``. The row count is not a multiple of the
folds, so the folds are ragged. A family's score does not depend on the
batch it is scored in: alone it is the same bits."""

import numpy as np
import pytest

import pybnesian_tpu as pj
import pybnesian_tpu_torch as port
from pybnesian_tpu_torch import interop
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

ROWS = 503
FOLDS = 10
TOL = dict(rtol=5e-4, atol=5e-3)


def _chain(n=ROWS, d=5, seed=3):
    """Each column a sine of the last plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    cols = {"x0": rng.normal(0, 1, n) + rng.normal(0, 0.6, n)}
    for i in range(1, d):
        prev = cols[f"x{i - 1}"]
        cols[f"x{i}"] = (np.sin(0.8 * prev) + 0.5 * prev
                         + rng.normal(0, 0.6, n))
    return {k: v.astype(np.float32) for k, v in cols.items()}


def _families(d, shift):
    names = [f"x{i}" for i in range(d)]
    fams = []
    for i, v in enumerate(names):
        fams += [(v, []), (v, [names[(i + shift) % d]]),
                 (v, [names[(i + shift) % d], names[(i + shift + 1) % d]])]
    return fams


@pytest.fixture(scope="module")
def scores():
    """The JAX package's float64 score and network, the port's float32
    ones, on the same folds."""
    cols = _chain()
    names = list(cols)
    wide = {k: v.astype(np.float64) for k, v in cols.items()}
    jax_score = pj.CVLikelihood(wide, k=FOLDS, seed=0)
    folds = [jax_score.cv.fold_indices(i) for i in range(FOLDS)]
    port_score = interop.cv_likelihood(cols, folds, device="cpu")
    return (jax_score, pj.KDENetwork(names), port_score,
            port.KDENetwork(names))


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_a_batch_agrees_with_float64(scores, shift):
    jax_score, jax_model, port_score, port_model = scores
    fams = _families(5, shift)
    want = jax_score.local_score_batch(jax_model, fams)
    got = port_score.local_score_batch(
        port_model, [(v, ps, port.CKDEType()) for v, ps in fams])
    assert got.shape == (15,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_a_family_alone_is_the_same_bits_as_in_its_batch(scores):
    _, _, port_score, port_model = scores
    ckde = port.CKDEType()
    fams = [(v, ps, ckde) for v, ps in _families(5, 2)]
    batch = port_score.local_score_batch(port_model, fams)
    alone = np.array([port_score.local_score_batch(port_model, [f])[0]
                      for f in fams])
    np.testing.assert_array_equal(alone, batch)
