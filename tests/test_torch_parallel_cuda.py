"""The sharded functions on the card: a mesh of four virtual shards of
``cuda:0``.

``sharded_ckde_cv`` (families over ``fam``, each shard through the CV
pairs kernel) and ``sharded_kde_slogl`` (training rows over ``data``, each
shard through the KDE kernel) against the unsharded kernel route and the
plain version, with one kernel launch per shard; a float64 mesh takes the
plain route and launches nothing. Tolerance: 1e-4 relative per family or
sum (float32 sums over thousands of rows, in another order and launch
plan).

Every test needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package; run it on the card with

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py -q
"""

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops import kde as tkde
from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs
from pybnesian_tpu_torch.ops.kde_kernel import kde_logl, kde_logl_reference
from pybnesian_tpu_torch.parallel import (make_mesh, sharded_ckde_cv,
                                          sharded_kde_slogl)

pytestmark = pytest.mark.cuda
RTOL = 1e-4
SHARDS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels; run chip_smoke.py)")
    return torch.device("cuda:0")


def _cv_inputs(device, dtype=torch.float32, n=2_000, D=4, K=5, F=8,
               seed=0):
    """config 6's weak-scaling layout (benchmarks/config6_scaling.py
    make_inputs) at 2,000 rows: K folds, families of 0 and 1 parents."""
    rng = np.random.default_rng(seed)
    folds = np.array_split(rng.permutation(n), K)
    ntr, nte = n - n // K, n // K
    tr_idx = np.stack([np.concatenate([folds[j] for j in range(K) if j != k])
                       for k in range(K)])
    te_idx = np.stack(folds)
    col_idx = np.zeros((F, 2), np.int64)
    col_mask = np.zeros((F, 2))
    for f in range(F):
        col_idx[f, 0], col_mask[f, 0] = f % D, 1.0
        if f % 2:
            col_idx[f] = [(f + 1) % D, f % D]
            col_mask[f, 1] = 1.0

    def t(a, kind=dtype):
        return torch.as_tensor(a, dtype=kind, device=device)

    return (t(rng.normal(size=(n, D))), t(np.zeros((n, D))),
            t(col_idx, torch.long), t(col_mask), t(tr_idx, torch.long),
            t(np.ones((K, ntr))), t(te_idx, torch.long), t(np.ones((K, nte))))


def _close(got, want):
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(), rtol=RTOL)


def test_sharded_ckde_cv_on_virtual_shards(cuda):
    args = _cv_inputs(cuda)
    mesh = make_mesh({"data": 1, "fam": SHARDS}, devices=[cuda] * SHARDS)
    before = ckde_cv_pairs.launches
    got = sharded_ckde_cv(mesh, *args)
    assert ckde_cv_pairs.launches - before == SHARDS
    assert got.device == cuda and bool(torch.isfinite(got).all())
    _close(got, tkde.ckde_cv_alldevice_flash(*args))
    _close(got, tkde.ckde_cv_alldevice(*args))


def test_sharded_kde_slogl_on_virtual_shards(cuda):
    rng = np.random.default_rng(1)
    train = torch.as_tensor(rng.normal(size=(4_096, 3)), dtype=torch.float32,
                            device=cuda)
    test = torch.as_tensor(rng.normal(size=(512, 3)), dtype=torch.float32,
                           device=cuda)
    mesh = make_mesh({"data": SHARDS}, devices=[cuda] * SHARDS)
    before = kde_logl.launches
    got = sharded_kde_slogl(mesh, train, test, -2.5)
    assert kde_logl.launches - before == SHARDS
    assert got.device == cuda and bool(torch.isfinite(got))
    _close(got, tkde.kde_logl_whitened(train, test, -2.5).sum())
    plain = kde_logl_reference(
        train[None], torch.ones((1, 4_096), device=cuda), test[None],
        torch.tensor([-2.5], device=cuda)).sum()
    _close(got, plain)


def test_float64_mesh_takes_the_plain_route(cuda):
    args = _cv_inputs(cuda, dtype=torch.float64, n=500)
    mesh = make_mesh({"fam": SHARDS}, devices=[cuda] * SHARDS)
    before = (ckde_cv_pairs.launches, kde_logl.launches)
    got = sharded_ckde_cv(mesh, *args)
    slogl = sharded_kde_slogl(make_mesh({"data": SHARDS},
                                        devices=[cuda] * SHARDS),
                              args[0][:400, :2], args[0][400:, :2], -1.0)
    assert (ckde_cv_pairs.launches, kde_logl.launches) == before
    assert got.dtype == torch.float64 and bool(torch.isfinite(got).all())
    _close(got, tkde.ckde_cv_alldevice(*args))
    assert bool(torch.isfinite(slogl))
