"""The torch port's CV-CKDE pair function against the JAX Pallas kernel.

``ckde_cv_pairs_reference`` (pybnesian_tpu_torch/ops/ckde_cv_kernel.py) is
the plain torch version of the CUDA kernel that replaces the Pallas
``_ckde_cv_kernel``; here both run the same numpy inputs, the Pallas kernel
in interpret mode as tests/factors/test_pallas_cv.py runs it. Float32 on
both sides: atol 1e-4 / rtol 1e-5 per test row (the Pallas kernel forms
distances as ‖a‖² + ‖b‖² − 2a·b, the port by direct differences).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu.ops.pallas_kde import pallas_ckde_cv_pairs
from pybnesian_tpu_torch.ops.ckde_cv_kernel import (
    MAX_DPAD,
    ckde_cv_pairs,
    ckde_cv_pairs_reference,
)
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


def _inputs(dpad, G=4, ntr=512, nte=128, seed=0):
    """Programs 1 and 3 are evidence-free; program 2's second 256-row train
    block is all padding; ~10% of the other train rows are null."""
    rng = np.random.default_rng(seed)
    jtr = rng.normal(0, 2.0, (G, ntr, dpad)).astype(np.float32)
    jte = rng.normal(0, 2.0, (G, nte, dpad)).astype(np.float32)
    neg = np.where(rng.random((G, ntr)) < 0.1, -np.inf, 0.0).astype(np.float32)
    neg[2, 256:] = -np.inf
    no_ev = np.array([0, 1, 0, 1], np.float32)
    lm_const = np.log(np.maximum((neg == 0).sum(1), 1)).astype(np.float32)
    return [jtr, neg, np.ascontiguousarray(jtr[..., -1]), jte,
            np.ascontiguousarray(jte[..., -1]), no_ev, lm_const]


def _torch(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("dpad", [1, 2, 4])
def test_reference_matches_pallas_interpret(dpad):
    arrays = _inputs(dpad)
    want = np.asarray(pallas_ckde_cv_pairs(
        *(jnp.asarray(a) for a in arrays), block_m=128, block_n=256,
        interpret=True,
    ))
    got = ckde_cv_pairs_reference(*_torch(arrays)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_wrapper_on_cpu_is_the_reference_and_uncounted():
    args = _torch(_inputs(3, ntr=300, nte=77))
    before = ckde_cv_pairs.launches
    got = ckde_cv_pairs(*args)
    assert ckde_cv_pairs.launches == before
    torch.testing.assert_close(got, ckde_cv_pairs_reference(*args),
                               rtol=0, atol=0)


def test_all_padding_program():
    """No valid train row: the joint logsumexp is −inf, so an evidence-free
    program gives −inf and one with evidence NaN, as in the Pallas kernel."""
    arrays = _inputs(2, ntr=256, nte=8)
    arrays[1][:] = -np.inf
    out = ckde_cv_pairs(*_torch(arrays)).numpy()
    no_ev = arrays[5] > 0
    assert np.all(out[no_ev] == -math.inf)
    assert np.all(np.isnan(out[~no_ev]))


@pytest.mark.parametrize("break_it, error", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError),
    (lambda a: a.__setitem__(1, a[1][:, :-1]), ValueError),
    (lambda a: a.__setitem__(3, a[3].transpose(0, 1)), ValueError),
    (lambda a: a.__setitem__(5, a[5][:-1]), ValueError),
], ids=["float64", "neg-shape", "jte-shape", "no_ev-shape"])
def test_wrapper_rejects_bad_arguments(break_it, error):
    args = _torch(_inputs(2, ntr=64, nte=8))
    break_it(args)
    with pytest.raises(error):
        ckde_cv_pairs(*args)


def test_wrapper_rejects_noncontiguous_and_wide():
    args = _torch(_inputs(2, ntr=64, nte=8))
    args[4] = torch.as_tensor(_inputs(2, ntr=64, nte=16)[4])[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ckde_cv_pairs(*args)
    wide = _torch(_inputs(MAX_DPAD + 1, ntr=64, nte=8))
    with pytest.raises(ValueError, match="dpad"):
        ckde_cv_pairs(*wide)

