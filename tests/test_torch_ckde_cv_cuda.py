"""The CUDA kernel behind ``ckde_cv_pairs`` against its plain torch version,
on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it runs where only torch is
installed (``--noconftest`` skips tests/conftest.py, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_ckde_cv_cuda.py -q

Tolerance: 1e-3 absolute per test row, as chip_smoke.py holds the kernel
(float32 sums over up to thousands of train rows, in another order).

Some cases force a launch plan (R test rows per thread, T train rows per
group, S cluster blocks splitting the train axis) through the uncounted
launcher ``ckde_cv_kernel._launch``, to reach splits the shapes alone would
not.
"""

import math

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops import ckde_cv_kernel
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
    if G > 2:
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


def _run(args, plan=None):
    """The wrapper's launch, or one with a forced ``plan``."""
    if plan is None:
        return ckde_cv_pairs(*args)
    return ckde_cv_kernel._launch(*args, plan)


def _check(args, plan=None, atol=ATOL):
    got = _run(args, plan)
    want = ckde_cv_pairs_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=atol, rtol=0)
    return got


@pytest.mark.parametrize("plan", [(2, 16, 1), (2, 16, 3), (2, 16, 8)])
def test_nan_train_and_test_rows(cuda, plan):
    """A NaN train row turns its program NaN; a NaN test row turns only
    that row NaN; with and without a split, as in the plain version."""
    args = _inputs(cuda, 3, ntr=2000, nte=300)
    args[0][0, 1500, :] = math.nan  # a train row late in the last split
    args[3][2, 17, 1] = math.nan
    got = _run(args, plan).cpu()
    want = ckde_cv_pairs_reference(*args).cpu()
    assert torch.all(torch.isnan(got[0])) and torch.all(torch.isnan(want[0]))
    assert torch.isnan(got[2, 17]) and torch.isnan(want[2, 17])
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    torch.testing.assert_close(got[~nan], want[~nan], atol=ATOL, rtol=0)


@pytest.mark.parametrize("plan", [None, (2, 16, 1), (2, 16, 4)])
def test_nan_in_an_invalid_train_row(cuda, plan):
    """A NaN in coordinate 0 of a null train row still turns its program
    NaN, as -1/2 * NaN + -inf does in the plain version."""
    args = _inputs(cuda, 3, ntr=2000, nte=300)
    args[0][1, 700, 0] = math.nan
    args[1][1, 700] = -math.inf
    got = _run(args, plan).cpu()
    want = ckde_cv_pairs_reference(*args).cpu()
    assert torch.all(torch.isnan(got[1])) and torch.all(torch.isnan(want[1]))
    torch.testing.assert_close(got[[0, 2, 3]], want[[0, 2, 3]], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("split", [2, 4, 8])
def test_split_with_all_invalid_train_rows(cuda, split):
    """The last split block's share is all padding: its (-1e30, 0) pair
    merges to nothing."""
    args = _inputs(cuda, 2, ntr=4096, nte=200)
    share = -(-4096 // split)
    args[1][:, (split - 1) * share:] = -math.inf
    assert torch.isfinite(_check(args, (2, 16, split))).all()


@pytest.mark.parametrize("ntr", [1, 20, 50, 127])
def test_fewer_train_rows_than_split_times_group(cuda, ntr):
    """ntr < S * T: partial groups, and empty shares for the last ranks."""
    args = _inputs(cuda, 4, ntr=ntr, nte=45, seed=ntr)
    args[1][:, 0] = 0.0  # at least one valid row per program
    _check(args, (2, 16, 8))


@pytest.mark.parametrize("plan", [(2, 16, 1), (2, 16, 2), (2, 16, 5),
                                  (2, 16, 7)])
def test_ragged_rows(cuda, plan):
    """ntr and nte multiples of neither the 256-row tile, T, R nor the
    block's 128 * R rows."""
    _check(_inputs(cuda, 3, G=5, ntr=256 * 3 + 37, nte=128 * 4 + 3, seed=5),
           plan)


@pytest.mark.parametrize("split", [1, 4])
def test_far_test_rows(cuda, split):
    """Test rows ~30 away from every train row: every exp of the
    unshifted values would underflow; the max-then-sum keeps them."""
    args = _inputs(cuda, 2, ntr=1200, nte=64)
    args[3][:, :, 0] += 30.0
    args[4].copy_(args[3][..., -1])
    got = _check(args, (2, 16, split))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dpad", [1, MAX_DPAD])
def test_extreme_widths_with_a_split(cuda, dpad):
    """dpad 1 and 16 at a shape that the plan splits."""
    args = _inputs(cuda, dpad, G=2, ntr=3000, nte=500, seed=dpad)
    assert ckde_cv_kernel._launch_plan(2, 3000, 500, dpad, 132)[2] > 1
    _check(args)


def test_one_program_at_10k_splits(cuda):
    """G 1 at 10k × 10k: the plan splits the train axis."""
    G, ntr, nte, dpad = 1, 10_000, 10_000, 3
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ckde_cv_kernel._launch_plan(G, ntr, nte, dpad, sms)[2] > 1
    _check(_inputs(cuda, dpad, G=G, ntr=ntr, nte=nte, seed=11))


@pytest.mark.parametrize("plan", [None, (2, 16, 1)])
def test_cv_shape(cuda, plan):
    """G 150 at the CV path's shape (9000 × 1000, dpad 3): with the plan's
    own split, and with no split."""
    G, ntr, nte, dpad = 150, 9000, 1000, 3
    args = _inputs(cuda, dpad, G=G, ntr=ntr, nte=nte, seed=12)
    assert torch.isfinite(_check(args, plan)).all()


@pytest.mark.parametrize("plan", [(3, 16, 1), (2, 8, 1), (2, 16, 9),
                                  (2, 16, 0), (4, 8, 1), (1, 32, 1)])
def test_entry_point_rejects_other_plans(cuda, plan):
    """The C entry point refuses a plan outside what it instantiates."""
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(_inputs(cuda, 12), plan)


def test_wrapper_rejects_mixed_devices(cuda):
    args = _inputs(cuda, 2)
    args[6] = args[6].cpu()
    with pytest.raises(ValueError, match="lm_const"):
        ckde_cv_pairs(*args)


@pytest.mark.parametrize("ntr,nte,dpad", [(9000, 1000, 3), (600, 77, 8)],
                         ids=["cv-shape", "small"])
def test_program_bit_equal_alone_and_in_a_batch(cuda, ntr, nte, dpad):
    """A program's rows are the same bits alone (G 1), inside G 150 and in
    a second run: the reduction order depends on (ntr, dpad) only, not on
    the split that G makes the plan choose."""
    args = _inputs(cuda, dpad, G=150, ntr=ntr, nte=nte, seed=ntr)
    together = ckde_cv_pairs(*args)
    alone = ckde_cv_pairs(*[a[:1].contiguous() for a in args])
    torch.cuda.synchronize()
    assert torch.equal(together[:1], alone)
    assert torch.equal(ckde_cv_pairs(*args), together)


@pytest.mark.parametrize("ntr,nte,G", [(700, 300, 3), (1500, 300, 3),
                                       (9000, 300, 3), (90_000, 10_000, 150)],
                         ids=["700", "1500", "9000", "cv-100k-rows"])
def test_every_split_gives_the_same_bits(cuda, ntr, nte, G):
    """Forced splits 1 to 8, powers of two or not, only spread the fixed
    leaves over the cluster: every one gives the planned launch's bits.
    The last case is the CV path's shape at 100,000 rows, where the plan
    itself splits two ways."""
    args = _inputs(cuda, 3, G=G, ntr=ntr, nte=nte, seed=ntr)
    want = ckde_cv_pairs(*args)
    for split in range(1, ckde_cv_kernel.MAX_SPLIT + 1):
        assert torch.equal(_run(args, (2, 16, split)), want), split
