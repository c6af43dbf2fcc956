"""The CUDA kernel behind ``ckde_cv_pairs`` against its plain torch version,
on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it runs where only torch is
installed (``--noconftest`` skips tests/conftest.py, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_ckde_cv_cuda.py -q

Tolerance: 1e-3 absolute per test row, as chip_smoke.py holds the kernel
(float32 sums over up to thousands of train rows, in another order).
"""

import math

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops.ckde_cv_kernel import (
    MAX_DPAD,
    ckde_cv_pairs,
    ckde_cv_pairs_reference,
)

pytestmark = pytest.mark.cuda
ATOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run chip_smoke.py)")
    return torch.device("cuda")


def _inputs(device, dpad, G=4, ntr=600, nte=77, seed=0):
    """Ragged ntr and nte; programs 1 and 3 evidence-free; program 2's
    second 256-row train tile all padding; ~10% null train rows."""
    rng = np.random.default_rng(seed)
    jtr = rng.normal(0, 2.0, (G, ntr, dpad)).astype(np.float32)
    jte = rng.normal(0, 2.0, (G, nte, dpad)).astype(np.float32)
    neg = np.where(rng.random((G, ntr)) < 0.1, -np.inf, 0.0).astype(np.float32)
    neg[2, 256:512] = -np.inf
    no_ev = (np.arange(G) % 2 == 1).astype(np.float32)
    lm_const = np.log(np.maximum((neg == 0).sum(1), 1)).astype(np.float32)
    arrays = [jtr, neg, np.ascontiguousarray(jtr[..., -1]), jte,
              np.ascontiguousarray(jte[..., -1]), no_ev, lm_const]
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("dpad", [1, 2, 3, 4, 8, MAX_DPAD])
def test_kernel_matches_reference(cuda, dpad):
    args = _inputs(cuda, dpad, seed=dpad)
    before = ckde_cv_pairs.launches
    got = ckde_cv_pairs(*args)
    torch.cuda.synchronize()
    assert ckde_cv_pairs.launches == before + 1
    want = ckde_cv_pairs_reference(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_all_padding_program(cuda):
    """No valid train row: −inf for an evidence-free program, NaN for one
    with evidence, as in the plain version and the Pallas kernel."""
    args = _inputs(cuda, 2, ntr=256, nte=8)
    args[1].fill_(-math.inf)
    got = ckde_cv_pairs(*args).cpu()
    no_ev = args[5].cpu() > 0
    assert torch.all(got[no_ev] == -math.inf)
    assert torch.all(torch.isnan(got[~no_ev]))


def test_nan_input_propagates(cuda):
    """A NaN train coordinate (a degenerate fold's whitening) turns its
    program's rows NaN, as in the plain version; other programs stay
    finite."""
    args = _inputs(cuda, 3)
    args[0][0, 5, 0] = math.nan
    got = ckde_cv_pairs(*args).cpu()
    want = ckde_cv_pairs_reference(*args).cpu()
    assert torch.all(torch.isnan(got[0])) and torch.all(torch.isnan(want[0]))
    torch.testing.assert_close(got[1:], want[1:], atol=ATOL, rtol=0)


def test_wrapper_rejects_mixed_devices(cuda):
    args = _inputs(cuda, 2)
    args[6] = args[6].cpu()
    with pytest.raises(ValueError, match="lm_const"):
        ckde_cv_pairs(*args)
