"""The KDE kernel (``kde_logl``), the exp-chain probe (``exp_chain``) and the
fitted-model routes through them and through ``ckde_cv_pairs``, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it runs where only torch is
installed (``--noconftest`` skips tests/conftest.py, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_kde_cuda.py -q

Tolerances: 1e-3 absolute per test row for the KDE kernel against its plain
version (float32 sums over up to thousands of train rows, in another
order); 1e-5 absolute for the exp chain (one float32 recurrence, the same
operations).
"""

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops import kde as tkde
from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs
from pybnesian_tpu_torch.ops.exp_chain import exp_chain, exp_chain_reference
from pybnesian_tpu_torch.ops.kde_kernel import (
    MAX_D,
    kde_logl,
    kde_logl_reference,
)

pytestmark = pytest.mark.cuda
ATOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run chip_smoke.py)")
    return torch.device("cuda")


def _inputs(device, d, G=2, ntr=600, nte=77, seed=0):
    """Ragged ntr and nte; ~10% invalid train rows; program 0's first
    256-row train tile all invalid."""
    rng = np.random.default_rng(seed)
    train = rng.normal(0, 2.0, (G, ntr, d)).astype(np.float32)
    test = rng.normal(0, 2.0, (G, nte, d)).astype(np.float32)
    valid = (rng.random((G, ntr)) > 0.1).astype(np.float32)
    valid[0, :256] = 0.0
    lognorm = rng.normal(-3.0, 0.5, G).astype(np.float32)
    return [torch.as_tensor(a, device=device)
            for a in (train, valid, test, lognorm)]


@pytest.mark.parametrize("d", [1, 2, 3, 8, 16, 17, 40])
def test_kde_kernel_matches_reference(cuda, d):
    args = _inputs(cuda, d, seed=d)
    before = kde_logl.launches
    got = kde_logl(*args)
    torch.cuda.synchronize()
    assert kde_logl.launches == before + 1
    want = kde_logl_reference(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_kde_kernel_widest(cuda):
    args = _inputs(cuda, MAX_D, G=1, ntr=300, nte=130)
    args[0] *= 0.1
    args[2] *= 0.1
    got = kde_logl(*args)
    torch.testing.assert_close(got, kde_logl_reference(*args), atol=ATOL,
                               rtol=0)


def test_kde_kernel_all_invalid_program(cuda):
    args = _inputs(cuda, 3, ntr=300, nte=10)
    args[1][1].zero_()
    got = kde_logl(*args).cpu()
    assert torch.all(got[1] == -torch.inf)
    assert torch.isfinite(got[0]).all()


def test_exp_chain_matches_reference(cuda):
    x = -torch.rand(64, 256, device=cuda) * 3.0
    before = exp_chain.launches
    got = exp_chain(x, repeats=4)
    torch.cuda.synchronize()
    assert exp_chain.launches == before + 1
    torch.testing.assert_close(got, exp_chain_reference(x, 1), atol=1e-5,
                               rtol=0)


def test_fitted_model_routes_launch_the_kernels(cuda):
    """Float32 on the card: kde_logl_whitened and kde_conditional_logsumexp
    launch the KDE kernel once each, batched_ckde_logl the pairs kernel;
    each agrees with its float64 plain form on the same inputs."""
    rng = np.random.default_rng(3)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=cuda)

    tr, te = rng.normal(size=(500, 3)), rng.normal(size=(90, 3))
    before = kde_logl.launches
    got = tkde.kde_logl_whitened(t(tr), t(te), -2.0)
    want = tkde.kde_logl_whitened(t(tr, torch.float64), t(te, torch.float64),
                                  -2.0)
    torch.testing.assert_close(got.double(), want, atol=ATOL, rtol=0)
    got = tkde.kde_conditional_logsumexp(t(tr), t(te), t(tr[:, 1:]),
                                         t(te[:, 1:]), -2.0, -1.0)
    want = tkde.kde_conditional_logsumexp(
        *(t(a, torch.float64) for a in (tr, te, tr[:, 1:], te[:, 1:])),
        -2.0, -1.0)
    torch.testing.assert_close(got.double(), want, atol=ATOL, rtol=0)
    assert kde_logl.launches == before + 2

    jtr = np.stack([tr, tr * 0.5])
    jtr[0, :, 1:] = 0.0  # factor 0 is evidence-free: its variable is col 0
    jte = np.stack([te, te * 0.5])
    jte[0, :, 1:] = 0.0
    zv = [jtr[0, :, 0], jtr[1, :, 2]], [jte[0, :, 0], jte[1, :, 2]]
    trm = np.ones((2, 500))
    trm[1, 450:] = 0.0
    args = [jtr, jte, np.stack(zv[0]), np.stack(zv[1]), trm,
            np.array([-1.2, -0.8])]
    before = ckde_cv_pairs.launches
    got = tkde.batched_ckde_logl(*(t(a) for a in args),
                                 no_ev=t([1.0, 0.0]))
    assert ckde_cv_pairs.launches == before + 1
    want = tkde.batched_ckde_logl(*(t(a, torch.float64) for a in args))
    torch.testing.assert_close(got.double(), want, atol=ATOL, rtol=0)
