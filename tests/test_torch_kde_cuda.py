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

Some cases force a launch plan (R test rows per thread, T train rows per
group, S cluster blocks splitting the train axis) through the uncounted
launcher ``kde_kernel._launch``, to reach splits the shapes alone would not.
"""

import math

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops import kde as tkde
from pybnesian_tpu_torch.ops import kde_kernel
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
    valid[:, -1] = 1.0  # every program keeps a valid row
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


def _run(args, plan=None):
    """The wrapper's launch, or one with a forced ``plan``."""
    if plan is None:
        return kde_logl(*args)
    return kde_kernel._launch(*args, plan)


def _check(args, plan=None):
    got = _run(args, plan)
    want = kde_logl_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    return got


@pytest.mark.parametrize("d,plan", [(3, (2, 16, 1)), (3, (2, 16, 4)),
                                    (17, (1, 32, 1))])
def test_kde_nan_train_and_test_rows(cuda, d, plan):
    """A NaN train row turns its program NaN, a NaN test row only its
    row, on the templated and the runtime-width kernel."""
    args = _inputs(cuda, d, G=3, ntr=1500, nte=200)
    args[0][0, 1400, 0] = math.nan
    args[2][1, 33, :] = math.nan
    got = _run(args, plan).cpu()
    want = kde_logl_reference(*args).cpu()
    nan = torch.isnan(want)
    assert torch.all(nan[0]) and nan[1, 33] and nan.sum() == 200 + 1
    assert torch.equal(torch.isnan(got), nan)
    torch.testing.assert_close(got[~nan], want[~nan], atol=ATOL, rtol=0)


@pytest.mark.parametrize("d,plan", [(3, None), (3, (2, 16, 4)),
                                    (17, None)])
def test_kde_nan_in_an_invalid_train_row(cuda, d, plan):
    """A NaN in coordinate 0 of an invalid train row still turns its
    program NaN, as -1/2 * NaN + -inf does in the plain version."""
    args = _inputs(cuda, d, G=3, ntr=1500, nte=200)
    args[0][1, 900, 0] = math.nan
    args[1][1, 900] = 0.0
    got = _run(args, plan).cpu()
    want = kde_logl_reference(*args).cpu()
    assert torch.all(torch.isnan(got[1])) and torch.all(torch.isnan(want[1]))
    torch.testing.assert_close(got[[0, 2]], want[[0, 2]], atol=ATOL, rtol=0)


@pytest.mark.parametrize("split", [2, 8])
def test_kde_split_with_all_invalid_train_rows(cuda, split):
    args = _inputs(cuda, 3, ntr=4096, nte=300)
    args[1][:, :-(-4096 // split)] = 0.0  # the first share: all invalid
    assert torch.isfinite(_check(args, (2, 16, split))).all()


@pytest.mark.parametrize("ntr", [1, 33, 100])
def test_kde_fewer_train_rows_than_split_times_group(cuda, ntr):
    _check(_inputs(cuda, 2, ntr=ntr, nte=70, seed=ntr), (2, 16, 8))


@pytest.mark.parametrize("d,plan", [(2, (2, 16, 3)), (5, (2, 16, 6)),
                                    (20, (1, 32, 1))])
def test_kde_ragged_rows(cuda, d, plan):
    """ntr and nte multiples of neither the tile, the group, R nor the
    block."""
    _check(_inputs(cuda, d, G=3, ntr=256 * 2 + 61, nte=128 * 4 + 5, seed=d),
           plan)


@pytest.mark.parametrize("d", [3, 17])
def test_kde_far_test_rows(cuda, d):
    """Test rows ~30 from every train row: each exp of the unshifted
    values underflows; the max-then-sum keeps the result finite."""
    args = _inputs(cuda, d, ntr=900, nte=50)
    args[2][:, :, 0] += 30.0
    assert torch.isfinite(_check(args)).all()


@pytest.mark.parametrize("d", [1, 16])
def test_kde_extreme_widths_with_a_split(cuda, d):
    args = _inputs(cuda, d, G=1, ntr=3000, nte=400, seed=d)
    assert kde_kernel._launch_plan(1, 3000, 400, d, 132)[2] > 1
    _check(args)


def test_kde_one_program_at_10k_splits(cuda):
    """G 1 at the Pallas kernel's shape (10,240², d 3): the plan splits."""
    G, ntr, nte, d = 1, 10_240, 10_240, 3
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kde_kernel._launch_plan(G, ntr, nte, d, sms)[2] > 1
    _check(_inputs(cuda, d, G=G, ntr=ntr, nte=nte, seed=21))


@pytest.mark.parametrize("d,plan", [(3, (1, 32, 1)), (17, (2, 16, 1)),
                                    (17, (1, 32, 2)), (9, (4, 8, 1))])
def test_kde_entry_point_rejects_other_plans(cuda, d, plan):
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(_inputs(cuda, d), plan)


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


@pytest.mark.parametrize("flagged", [True, False], ids=["no_ev", "plain"])
def test_prepared_train_side_gives_the_same_bits(cuda, flagged):
    """``batched_ckde_logl_prepared`` on a train side prepared once by
    ``ckde_train_side`` returns the float32 bits of ``batched_ckde_logl``
    on the same inputs, each one launch of the pairs kernel, with and
    without the no-evidence flags."""
    rng = np.random.default_rng(5)
    G, ntr, nte, d = 3, 2_000, 700, 3
    jtr = rng.normal(size=(G, ntr, d)).astype(np.float32)
    jtr[0, :, 1:] = 0.0  # factor 0 is evidence-free
    jte = rng.normal(size=(G, nte, d)).astype(np.float32)
    jte[0, :, 1:] = 0.0
    var_col = [0, 2, 2]
    trm = np.ones((G, ntr), np.float32)
    trm[1, 1_500:] = 0.0
    trm[2, 700:] = 0.0
    jtr[trm == 0] = 0.0
    args = [torch.as_tensor(a, device=cuda) for a in (
        jtr, jte, jtr[np.arange(G), :, var_col],
        jte[np.arange(G), :, var_col], trm,
        np.array([-1.2, -0.8, -1.0], np.float32))]
    no_ev = (torch.tensor([1.0, 0.0, 0.0], device=cuda) if flagged
             else None)
    jtr_t, jte_t, zv_tr, zv_te, trm_t, lndiff = args
    before = ckde_cv_pairs.launches
    want = tkde.batched_ckde_logl(*args, no_ev=no_ev)
    neg, flags, log_n = tkde.ckde_train_side(jtr_t, trm_t, no_ev)
    got = tkde.batched_ckde_logl_prepared(jtr_t, neg, zv_tr, flags, log_n,
                                          lndiff, jte_t, zv_te)
    again = tkde.batched_ckde_logl_prepared(jtr_t, neg, zv_tr, flags,
                                            log_n, lndiff, jte_t, zv_te)
    torch.cuda.synchronize()
    assert ckde_cv_pairs.launches == before + 3
    assert got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.parametrize("ntr,nte,d", [(10_240, 10_240, 3), (600, 77, 20)],
                         ids=["tpu-shape", "wide"])
def test_kde_program_bit_equal_alone_and_in_a_batch(cuda, ntr, nte, d):
    """A program's rows are the same bits alone (G 1), inside G 150 and in
    a second run: the reduction order depends on (ntr, d) only."""
    args = _inputs(cuda, d, G=1, ntr=ntr, nte=nte, seed=d)
    batch = [a.expand(150, *a.shape[1:]).contiguous() for a in args]
    alone = kde_logl(*args)
    together = kde_logl(*batch)
    torch.cuda.synchronize()
    assert torch.equal(together[:1], alone)
    assert torch.equal(kde_logl(*batch), together)


@pytest.mark.parametrize("ntr", [700, 9000])
def test_kde_every_split_gives_the_same_bits(cuda, ntr):
    args = _inputs(cuda, 3, G=2, ntr=ntr, nte=300, seed=ntr)
    want = kde_logl(*args)
    for split in range(1, 9):
        assert torch.equal(_run(args, (2, 16, split)), want), split
