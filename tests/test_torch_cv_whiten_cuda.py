"""The CUDA kernels behind ``ckde_cv_whiten`` (the CV whitening) and
``ckde_cv_fold_reduce`` (the per-fold sums) against their plain torch
versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it runs where only torch is
installed (``--noconftest`` skips tests/conftest.py, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_cv_whiten_cuda.py -q

Tolerances, per output of the whitening: the whitened rows and their
variable coordinate within 2e-6 relative and absolute (each is one float32
rounding of a float64 value that both versions form in another order, so
they differ by at most an ulp); ``lndiff`` (float64) within 1e-12
relative; ``lm_const`` within 2e-7 relative (one rounding of a float64
log); ``neg``, ``wte``, ``no_ev``, ``ok`` and every NaN exactly. The fold
sums: within 2e-7 relative of the plain version's float64 sums of the same
float32 rows (one rounding). Bit-equality where the kernels promise it: a
family's outputs and score alone, inside a batch of 56, with the families
permuted, at another padded width and run again.
"""

import math

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops import kde as tkde
from pybnesian_tpu_torch.ops.ckde_cv_kernel import ckde_cv_pairs
from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
    MAX_DPAD,
    ckde_cv_fold_reduce,
    ckde_cv_fold_reduce_reference,
    ckde_cv_whiten,
    ckde_cv_whiten_reference,
)

pytestmark = pytest.mark.cuda
NAMES = ("jtr", "neg", "zv_tr", "jte", "zv_te", "no_ev", "lm_const", "wte",
         "lndiff", "ok")
TOL = {"jtr": 2e-6, "zv_tr": 2e-6, "jte": 2e-6, "zv_te": 2e-6,
       "lndiff": 1e-12, "lm_const": 2e-7}
REDUCE_RTOL = 2e-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run chip_smoke.py)")
    return torch.device("cuda")


def _inputs(device, F=6, djmax=3, n=1001, K=3, null=0.1, seed=0,
            widths=None):
    """A CV call's arguments: n rows of max(djmax + 1, 6) correlated
    columns with ``null`` of the cells null (zeroed), K ragged folds, F
    families of ``widths`` columns (default 1 + f % djmax) on distinct
    columns, evidence first, padded to djmax."""
    rng = np.random.default_rng(seed)
    D = max(djmax + 1, 6)
    data = rng.normal(0, 1.5, (n, D))
    for j in range(1, D):
        data[:, j] += 0.6 * data[:, j - 1]
    nulls = (rng.random((n, D)) < null).astype(np.float64)
    data[nulls > 0] = 0.0
    folds = np.array_split(rng.permutation(n), K)
    ntr = max(n - len(f) for f in folds)
    nte = max(len(f) for f in folds)
    tr_idx = np.zeros((K, ntr), np.int64)
    tr_mask = np.zeros((K, ntr))
    te_idx = np.zeros((K, nte), np.int64)
    te_mask = np.zeros((K, nte))
    for k, te in enumerate(folds):
        tr = np.concatenate([f for j, f in enumerate(folds) if j != k])
        tr_idx[k, : len(tr)] = tr
        tr_mask[k, : len(tr)] = 1.0
        te_idx[k, : len(te)] = te
        te_mask[k, : len(te)] = 1.0
    widths = widths or [1 + f % djmax for f in range(F)]
    col_idx = np.zeros((F, djmax), np.int64)
    col_mask = np.zeros((F, djmax))
    for f, w in enumerate(widths):
        col_idx[f, :w] = rng.choice(D, w, replace=False)
        col_mask[f, :w] = 1.0

    def t(a):
        dtype = torch.int64 if a.dtype == np.int64 else torch.float32
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return [t(a) for a in (data, nulls, col_idx, col_mask, tr_idx, tr_mask,
                           te_idx, te_mask)]


def _check(args, rule="nr", bandwidths=None):
    """Kernel against plain on ``args``; returns the kernel's outputs."""
    before = ckde_cv_whiten.launches
    got = ckde_cv_whiten(*args, rule=rule, bandwidths=bandwidths)
    torch.cuda.synchronize()
    assert ckde_cv_whiten.launches == before + 1
    want = ckde_cv_whiten_reference(*args, rule=rule, bandwidths=bandwidths)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = TOL.get(name, 0.0)
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, equal_nan=True,
                                   msg=name)
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
    return got


@pytest.mark.parametrize("djmax", range(1, MAX_DPAD + 1))
def test_normal_reference_at_every_width(cuda, djmax):
    got = _check(_inputs(cuda, djmax=djmax, seed=djmax))
    assert torch.all(got[9] == 1)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[3]).all()


@pytest.mark.parametrize("djmax", [1, 3, 8])
def test_scott(cuda, djmax):
    _check(_inputs(cuda, djmax=djmax, seed=20 + djmax), rule="scott")


def _spd_bandwidths(args, seed, scale=0.3):
    F, djmax = args[2].shape
    K = args[4].shape[0]
    rng = np.random.default_rng(seed)
    A = rng.normal(0, scale, (F, K, djmax, djmax))
    H = A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(djmax)
    return torch.as_tensor(H, dtype=torch.float32, device=args[0].device)


@pytest.mark.parametrize("djmax", [1, 2, 5])
def test_given_bandwidths(cuda, djmax):
    args = _inputs(cuda, djmax=djmax, seed=30 + djmax)
    _check(args, rule=None, bandwidths=_spd_bandwidths(args, djmax))


def test_not_positive_definite_bandwidth_gives_nan_parts(cuda):
    """A negative pivot in one (family, fold): its whitened rows and lndiff
    are NaN in both versions, neg, wte and ok are not; the other programs
    are untouched."""
    args = _inputs(cuda, djmax=3, seed=40)
    H = _spd_bandwidths(args, 40)
    H[2, 1, 0, 0] = -1.0
    got = _check(args, rule=None, bandwidths=H)
    K = args[4].shape[0]
    g = 2 * K + 1
    assert torch.isnan(got[0][g]).all() and torch.isnan(got[3][g]).all()
    assert torch.isnan(got[8][2, 1])
    assert torch.isfinite(got[8]).sum() == got[8].numel() - 1
    assert not torch.isnan(got[1][g]).any() and got[9][2, 1] == 1


def test_fold_without_train_rows_gives_nan(cuda):
    """Column 0 null except on fold 0's test rows: fold 0 of each family
    that uses column 0 has no valid train row (a 0/0 mean), ok 0."""
    args = _inputs(cuda, F=8, djmax=2, seed=50, null=0.0)
    args[2][0, 0] = 0                      # family 0: column 0 alone
    args[2][1] = torch.tensor([2, 0])      # family 1: column 0 its variable
    data, nulls = args[0], args[1]
    te0 = args[6][0][args[7][0] > 0]
    nulls[:, 0] = 1.0
    nulls[te0, 0] = 0.0
    data[nulls > 0] = 0.0
    got = _check(args)
    K = args[4].shape[0]
    uses0 = (args[2] == 0).logical_and(args[3] > 0).any(1)
    assert uses0.any()
    for f in torch.nonzero(uses0).flatten().tolist():
        assert got[9][f, 0] == 0 and torch.isnan(got[8][f, 0])
        assert torch.all(got[1][f * K] == -math.inf)


def test_nan_cell_propagates(cuda):
    """A NaN in a cell of a train row: every family whose columns hold it
    gets NaN parts in the folds that train on that row, as the plain
    version gives them."""
    args = _inputs(cuda, F=6, djmax=3, seed=60, null=0.0)
    row = int(args[4][0][0])
    args[0][row, 1] = math.nan
    got = _check(args)
    uses1 = ((args[2] == 1) & (args[3] > 0)).any(1)
    assert torch.equal(torch.isnan(got[8]).any(1), uses1)


@pytest.mark.parametrize("n,K", [(257, 2), (1999, 5), (33, 10)])
def test_odd_fold_sizes(cuda, n, K):
    _check(_inputs(cuda, F=5, djmax=4, n=n, K=K, seed=n))


def _batch(device, seed=70):
    """56 families of 1 to 3 columns over 6 columns, 10 ragged folds."""
    return _inputs(device, F=56, djmax=3, n=2000, K=10, seed=seed)


def _family(args, f, width=None):
    """Family f of ``args`` alone, padded to ``width`` columns (default:
    its own)."""
    col_idx, col_mask = args[2][f:f + 1], args[3][f:f + 1]
    w = int(col_mask.sum()) if width is None else width
    pad = w - col_idx.shape[1]
    if pad > 0:
        col_idx = torch.nn.functional.pad(col_idx, (0, pad))
        col_mask = torch.nn.functional.pad(col_mask, (0, pad))
    out = list(args)
    out[2], out[3] = col_idx[:, :w].contiguous(), col_mask[:, :w].contiguous()
    return out


def _program_parts(parts, f, K, width):
    """Family f's outputs of a whitening call, its first ``width``
    columns."""
    g = slice(f * K, (f + 1) * K)
    return [parts[0][g, :, :width], parts[1][g], parts[2][g],
            parts[3][g, :, :width], parts[4][g], parts[5][g], parts[6][g],
            parts[7][f], parts[8][f], parts[9][f]]


def test_a_family_is_the_same_bits_alone_in_a_batch_and_permuted(cuda):
    args = _batch(cuda)
    K = args[4].shape[0]
    together = ckde_cv_whiten(*args)
    again = ckde_cv_whiten(*args)
    perm = torch.randperm(56, generator=torch.Generator().manual_seed(0))
    permuted_args = list(args)
    permuted_args[2] = args[2][perm.to(cuda)].contiguous()
    permuted_args[3] = args[3][perm.to(cuda)].contiguous()
    permuted = ckde_cv_whiten(*permuted_args)
    torch.cuda.synchronize()
    for a, b in zip(together, again):
        assert torch.equal(a, b)
    where = {int(p): i for i, p in enumerate(perm)}
    for f in (0, 1, 2, 17, 55):
        width = int(args[3][f].sum())
        alone = ckde_cv_whiten(*_family(args, f))
        wide = ckde_cv_whiten(*_family(args, f, width=MAX_DPAD))
        mine = _program_parts(together, f, K, width)
        for other in (_program_parts(alone, 0, K, width),
                      _program_parts(wide, 0, K, width),
                      _program_parts(permuted, where[f], K, width)):
            for name, a, b in zip(NAMES, mine, other):
                assert torch.equal(a, b), (f, name)


def test_fold_reduce_against_the_float64_sums(cuda):
    """The reduce kernel on the pairs kernel's rows (with −inf rows where
    the weight is 0 and a degenerate fold) against the plain version's
    float64 sums."""
    args = _batch(cuda, seed=80)
    parts = ckde_cv_whiten(*args)
    wte, lndiff, ok = parts[7:]
    rows = ckde_cv_pairs(*parts[:7]).reshape(wte.shape)
    rows = torch.where(wte > 0, rows, -math.inf).contiguous()
    ok = ok.clone()
    ok[3, 4] = 0.0
    before = ckde_cv_fold_reduce.launches
    got = ckde_cv_fold_reduce(rows, wte, lndiff, ok)
    torch.cuda.synchronize()
    assert ckde_cv_fold_reduce.launches == before + 1
    want = ckde_cv_fold_reduce_reference(rows.double(), wte.double(), lndiff,
                                         ok.double())
    assert got.dtype == torch.float32 and got.shape == (56,)
    others = torch.ones(56, dtype=torch.bool, device=cuda)
    others[3] = False
    assert torch.isnan(got[3]) and torch.isfinite(got[others]).all()
    torch.testing.assert_close(got.double(), want, rtol=REDUCE_RTOL, atol=0,
                               equal_nan=True)
    plain32 = ckde_cv_fold_reduce_reference(rows, wte, lndiff, ok)
    torch.testing.assert_close(got, plain32, rtol=REDUCE_RTOL, atol=0,
                               equal_nan=True)


def test_cv_scores_are_the_same_bits_in_every_batch(cuda):
    """The whole float32 route (whitening, pairs, fold sums: three
    launches) against the plain route at flash_cv_selfcheck's tolerance
    (the plain route's pair distances are float32 matmuls), and each
    family's score the same bits alone, at another padded width and inside
    the batch."""
    args = _batch(cuda, seed=90)
    counts = (ckde_cv_whiten.launches, ckde_cv_pairs.launches,
              ckde_cv_fold_reduce.launches)
    scores = tkde.ckde_cv_alldevice_flash(*args)
    assert (ckde_cv_whiten.launches, ckde_cv_pairs.launches,
            ckde_cv_fold_reduce.launches) == tuple(c + 1 for c in counts)
    plain = tkde.ckde_cv_alldevice(*args)
    torch.testing.assert_close(scores.double(), plain.double(), rtol=1e-4,
                               atol=5e-2)
    for f in range(0, 56, 5):
        alone = tkde.ckde_cv_alldevice_flash(*_family(args, f))
        wide = tkde.ckde_cv_alldevice_flash(*_family(args, f, width=7))
        assert torch.equal(alone[0], scores[f]), f
        assert torch.equal(wide[0], scores[f]), f


SPLITS = (1, 2, 4, 8)


def _every_split(args, **kw):
    """The whitening at every cluster size S the entry point takes, each
    output bit-equal to S = 1's (NaN in the same places); returns S = 1's
    outputs."""
    first = ckde_cv_whiten(*args, split=1, **kw)
    for split in SPLITS[1:]:
        got = ckde_cv_whiten(*args, split=split, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(NAMES, first, got):
            assert torch.equal(torch.isnan(a), torch.isnan(b)), (split, name)
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), (
                split, name)
    return first


def _rows_inputs(device, ntr, nte, F=3, djmax=3, K=2, seed=0):
    """A whitening call of K folds of exactly ntr train and nte test rows
    (indices drawn from max(ntr, nte, 8) + 5 data rows, one train row in 7
    masked out), F families of 1 to djmax columns over 6."""
    rng = np.random.default_rng(seed)
    n = max(ntr, nte, 8) + 5
    D = max(djmax + 1, 6)
    data = rng.normal(0, 1.3, (n, D))
    nulls = (rng.random((n, D)) < 0.05).astype(np.float64)
    data[nulls > 0] = 0.0
    tr_idx = rng.integers(0, n, (K, ntr))
    tr_mask = (np.arange(ntr)[None] % 7 != 3).astype(np.float64).repeat(K, 0)
    te_idx = rng.integers(0, n, (K, nte))
    te_mask = np.ones((K, nte))
    col_idx = np.zeros((F, djmax), np.int64)
    col_mask = np.zeros((F, djmax))
    for f in range(F):
        w = 1 + f % djmax
        col_idx[f, :w] = rng.choice(D, w, replace=False)
        col_mask[f, :w] = 1.0

    def t(a):
        dtype = torch.int64 if a.dtype == np.int64 else torch.float32
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return [t(a) for a in (data, nulls, col_idx, col_mask, tr_idx, tr_mask,
                           te_idx, te_mask)]


@pytest.mark.parametrize("ntr", [0, 1, 511, 512, 513, 9000, 100_000])
def test_row_counts_at_the_leaf_edges_at_every_split(cuda, ntr):
    """Train-row counts of no row, one, a leaf's edge (two leaves of 256
    rows start at 512) and the CV path's 9,000 and 100,000 rows: the kernel
    against its plain version, and the same bits at every S."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import whiten_leaves

    args = _rows_inputs(cuda, ntr, 37 if ntr < 10_000 else 1000,
                        seed=ntr % 1000)
    assert whiten_leaves(ntr) == (1 if ntr < 512 else 2 if ntr < 1024
                                  else 8)
    got = _every_split(args)
    if ntr > 1:
        _check(args)
    else:  # no row: a 0/0 mean, NaN parts where the plain version has them
        want = ckde_cv_whiten_reference(*args)
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(torch.isnan(g), torch.isnan(w)), name


def test_batch_of_150_at_every_split_alone_and_padded(cuda):
    """Phase 4's program count (15 families × 10 folds) at 2,000 rows: every
    S gives the same bits, and each family the bits it gets alone and
    padded to dpad 16, at every S."""
    args = _inputs(cuda, F=15, djmax=3, n=2000, K=10, seed=110)
    K = 10
    together = _every_split(args)
    for f in (0, 7, 14):
        width = int(args[3][f].sum())
        mine = _program_parts(together, f, K, width)
        for split in SPLITS:
            for fam_args in (_family(args, f),
                             _family(args, f, width=MAX_DPAD)):
                alone = ckde_cv_whiten(*fam_args, split=split)
                for name, a, b in zip(NAMES, mine,
                                      _program_parts(alone, 0, K, width)):
                    assert torch.equal(a, b), (f, split, name)


def test_nan_row_in_the_last_leaf_at_every_split(cuda):
    """A NaN cell in the last train row of every fold (the last leaf): the
    families on that column get NaN parts in every fold, as in the plain
    version, at every S."""
    args = _rows_inputs(cuda, 2100, 300, F=6, djmax=3, seed=120)
    col = int(args[2][0, 0])  # family 0's first column
    args[0][args[4][:, -1], col] = math.nan
    _check(args)
    got = _every_split(args)
    uses = ((args[2] == col) & (args[3] > 0)).any(1)
    assert uses.any() and not uses.all()
    assert torch.equal(torch.isnan(got[8]).all(1), uses)


def test_out_of_range_indices_read_nan(cuda):
    """A train index past the data in fold 1 and a column index past it in
    family 2: those programs' statistics are NaN (no read out of bounds),
    every other program keeps the bits of a call without the bad index, at
    every S."""
    args = _rows_inputs(cuda, 1500, 200, F=4, djmax=3, K=3, seed=130)
    clean = ckde_cv_whiten(*args)
    bad = list(args)
    bad[4] = args[4].clone()
    bad[4][1, 700] = args[0].shape[0]
    bad[2] = args[2].clone()
    bad[2][2, 0] = args[0].shape[1] + 3
    got = _every_split(bad)
    K = 3
    lndiff = got[8]
    assert torch.isnan(lndiff[:, 1]).all()          # fold 1, every family
    assert torch.isnan(lndiff[2]).all()             # family 2, every fold
    for f in (0, 1, 3):
        for k in (0, 2):
            g = f * K + k
            assert torch.equal(got[0][g], clean[0][g]), (f, k)
            assert torch.equal(got[3][g], clean[3][g]), (f, k)
            assert torch.equal(lndiff[f, k], clean[8][f, k]), (f, k)


def test_degenerate_fold_at_every_split(cuda):
    """test_fold_without_train_rows_gives_nan's fold and a bandwidth that is
    not positive definite: the same NaN parts and ``ok`` at every S."""
    args = _inputs(cuda, F=8, djmax=2, seed=50, null=0.0)
    args[2][0, 0] = 0
    args[2][1] = torch.tensor([2, 0])
    te0 = args[6][0][args[7][0] > 0]
    args[1][:, 0] = 1.0
    args[1][te0, 0] = 0.0
    args[0][args[1] > 0] = 0.0
    got = _every_split(args)
    assert got[9][0, 0] == 0 and torch.isnan(got[8][0, 0])
    args = _inputs(cuda, djmax=3, seed=40)
    H = _spd_bandwidths(args, 40)
    H[2, 1, 0, 0] = -1.0
    got = _every_split(args, rule=None, bandwidths=H)
    assert torch.isnan(got[8][2, 1]) and got[9][2, 1] == 1


def test_wrapper_rejects_a_split_the_kernel_does_not_take(cuda):
    args = _rows_inputs(cuda, 100, 10)
    for split in (0, 3, 16):
        with pytest.raises(ValueError, match="split"):
            ckde_cv_whiten(*args, split=split)


# The fold reduce's shapes: folds of one round and past the 8 blocks of a
# cluster, test rows at a block's edges (256 threads) and at 100,000 rows'
# folds, one family to a wide batch.
REDUCE_K = (1, 3, 8, 10, 17)
REDUCE_NTE = (0, 1, 255, 256, 257, 1000, 10_000)
REDUCE_F = (1, 15, 80)


def _bits(t):
    return t.view(torch.int32)


def _reduce_args(device, F, K, nte, seed=0):
    """Fold-reduce arguments from a seed: rows of log-likelihood values,
    weights 1 (a few 0.5) with about one row in 7 at 0, those rows -inf or
    NaN in turn (both must count 0), lndiff around -1.4, every fold ok."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(-4.0, 2.0, (F, K, nte))
    wte = np.where(rng.random((F, K, nte)) < 0.05, 0.5, 1.0)
    zero = rng.random((F, K, nte)) < 1 / 7
    wte[zero] = 0.0
    rows[zero] = np.where(np.arange(zero.sum()) % 2 == 0, -np.inf, np.nan)
    lndiff = rng.normal(-1.4, 0.3, (F, K))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return [t(rows), t(wte), t(lndiff, torch.float64), t(np.ones((F, K)))]


def _reduce_every_split(args):
    """The fold reduce at every cluster size S the entry point takes (1 to
    min(K, 8)) and at the plan's, each the same bits as S = 1's; returns
    S = 1's result."""
    K = args[0].shape[1]
    first = ckde_cv_fold_reduce(*args, split=1)
    for split in [*range(2, min(K, 8) + 1), None]:
        got = ckde_cv_fold_reduce(*args, split=split)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(first)), split
    return first


def _hold_reduce(got, args):
    """``got`` within REDUCE_RTOL of the plain version's float64 sums of
    the same float32 rows, NaN in the same places."""
    rows, wte, lndiff, ok = args
    want = ckde_cv_fold_reduce_reference(rows.double(), wte.double(), lndiff,
                                         ok.double())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got.double(), want, rtol=REDUCE_RTOL, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("F", REDUCE_F)
@pytest.mark.parametrize("nte", REDUCE_NTE)
@pytest.mark.parametrize("K", REDUCE_K)
def test_fold_reduce_at_every_split(cuda, F, K, nte):
    """Every S the same bits, against the float64 sums; the -inf and NaN
    rows of weight 0 count 0, so every family is finite."""
    args = _reduce_args(cuda, F, K, nte, seed=1000 * K + nte + F)
    before = ckde_cv_fold_reduce.launches
    got = _reduce_every_split(args)
    assert ckde_cv_fold_reduce.launches == before + min(K, 8) + 1
    assert got.shape == (F,) and torch.isfinite(got).all()
    _hold_reduce(got, args)


def test_fold_reduce_nan_row_with_weight_propagates(cuda):
    """A NaN row of weight 1 in fold 9 of family 4: that family is NaN,
    every other family is the bits it had, at every S."""
    args = _reduce_args(cuda, 15, 10, 1000, seed=7)
    clean = ckde_cv_fold_reduce(*args)
    args[0][4, 9, 333] = math.nan
    args[1][4, 9, 333] = 1.0
    got = _reduce_every_split(args)
    _hold_reduce(got, args)
    others = torch.arange(15, device=cuda) != 4
    assert torch.isnan(got[4])
    assert torch.equal(_bits(got[others]), _bits(clean[others]))


def test_fold_reduce_degenerate_fold_is_nan_for_its_family_only(cuda):
    """ok 0 in fold 3 of family 2: NaN for family 2 alone, at every S."""
    args = _reduce_args(cuda, 8, 10, 800, seed=8)
    clean = ckde_cv_fold_reduce(*args)
    args[3][2, 3] = 0.0
    got = _reduce_every_split(args)
    _hold_reduce(got, args)
    others = torch.arange(8, device=cuda) != 2
    assert torch.isnan(got[2])
    assert torch.equal(_bits(got[others]), _bits(clean[others]))


def test_fold_reduce_same_launch_twice_gives_the_same_bits(cuda):
    args = _reduce_args(cuda, 15, 10, 10_000, seed=9)
    for split in (None, 1, 5, 8):
        a = ckde_cv_fold_reduce(*args, split=split)
        b = ckde_cv_fold_reduce(*args, split=split)
        torch.cuda.synchronize()
        assert torch.equal(_bits(a), _bits(b)), split


def test_reduce_wrapper_rejects_a_split_the_kernel_does_not_take(cuda):
    args = _reduce_args(cuda, 2, 3, 10)
    for split in (0, 4, 9):
        with pytest.raises(ValueError, match="split"):
            ckde_cv_fold_reduce(*args, split=split)


# ---------------------------------------------------------------- UCV starts
#
# ``ucv_starts`` (kernel ``ucv_starts_f32``) against its plain version and
# against the host route it replaced in the CV score: the starts (float64)
# within 1e-12 relative of the plain version's (1e-9 of the host's np.cov
# and np.linalg.cholesky), the rows, mask, counts and ``ok`` exactly.

STARTS = ("X", "valid", "Ns", "starts", "ok")


def _starts_inputs(device, F=6, d=3, n=1001, K=3, null=0.1, seed=0):
    """``ucv_starts``'s arguments: ``_inputs``'s data and folds, F families
    of d distinct columns each, the variable first."""
    data, nulls, _c, _m, tr_idx, tr_mask, _ti, _tm = _inputs(
        device, F=1, djmax=d, n=n, K=K, null=null, seed=seed)
    rng = np.random.default_rng(seed + 1)
    cols = np.stack([rng.choice(data.shape[1], d, replace=False)
                     for _ in range(F)])
    return [data, nulls, torch.as_tensor(cols, device=device), tr_idx,
            tr_mask]


def _starts_check(args, **kw):
    """Kernel against plain on ``args``; returns the kernel's outputs."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        ucv_starts, ucv_starts_reference)

    before = ucv_starts.launches
    got = ucv_starts(*args, **kw)
    torch.cuda.synchronize()
    assert ucv_starts.launches == before + 1
    want = ucv_starts_reference(*args)
    for name, g, w in zip(STARTS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "starts":
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-15,
                                       equal_nan=True)
            assert torch.equal(torch.isnan(g), torch.isnan(w))
        else:
            assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("null", [0.0, 0.1])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 16])
def test_ucv_starts_against_the_plain_version(cuda, d, null):
    got = _starts_check(_starts_inputs(cuda, d=d, null=null,
                                       seed=200 + d))
    assert torch.all(got[4] == 1)


@pytest.mark.parametrize("ntr", [0, 1, 511, 512, 513, 9000])
def test_ucv_starts_at_the_leaf_edges_at_every_split(cuda, ntr):
    """The whitening's leaf edges: every S the same bits as S = 1, and the
    plain version's outputs (a problem of at most d rows: ok 0, NaN
    start)."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ucv_starts

    a = _rows_inputs(cuda, ntr, 5, F=4, djmax=2, seed=ntr % 1000)
    cols = torch.stack([a[2][:, 0], (a[2][:, 0] + 1) % a[0].shape[1]], 1)
    args = [a[0], a[1], cols.contiguous(), a[4], a[5]]
    first = _starts_check(args, split=1)
    for split in SPLITS[1:]:
        got = ucv_starts(*args, split=split)
        for name, x, y in zip(STARTS, first, got):
            assert torch.equal(torch.isnan(x), torch.isnan(y)), (split, name)
            assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), (
                split, name)
    if ntr <= 2:
        assert torch.all(first[4] == 0) and torch.isnan(first[3]).all()


def _kde5_frame(n=10_000, null=0.0, seed=5):
    """bench.py's 5-column chain in float32 (x_i = sin(0.8 x_{i-1}) +
    0.5 x_{i-1} + noise), ``null`` of the cells of x1 and x3 null."""
    rng = np.random.default_rng(seed)
    cols = {"x0": rng.normal(0, 1, n) + rng.normal(0, 0.6, n)}
    for i in range(1, 5):
        prev = cols[f"x{i - 1}"]
        cols[f"x{i}"] = (np.sin(0.8 * prev) + 0.5 * prev
                         + rng.normal(0, 0.6, n))
    out = {}
    for k, v in cols.items():
        v = v.astype(np.float32)
        if k in ("x1", "x3") and null:
            v[rng.random(n) < null] = np.nan
        out[k] = v
    return out


def _kde5_families(shift=1, d=5):
    names = [f"x{i}" for i in range(d)]
    fams = []
    for i, v in enumerate(names):
        fams += [(v, []), (v, [names[(i + shift) % d]]),
                 (v, [names[(i + shift) % d], names[(i + shift + 1) % d]])]
    return fams


def _kde5_engine(device, null, k=10, seed=0):
    """A CV engine over k folds of all rows of the kde5 frame, null rows
    included, so each family drops its own."""
    import pybnesian_tpu_torch as pt
    from pybnesian_tpu_torch.learning.scores.likelihood import _KFoldEngine

    cols = _kde5_frame(null=null)
    n = len(cols["x0"])
    rows = np.random.default_rng(seed).permutation(n)
    folds = [(np.sort(np.setdiff1d(rows, te)), np.sort(te))
             for te in np.array_split(rows, k)]
    return _KFoldEngine(pt.DataFrame.wrap(cols), folds, device)


def _host_starts(engine, fams):
    """The host route the CV score took before: per family the folds'
    train rows (``_fold_trains``) and vech(chol(k·np.cov)) per fold."""
    from pybnesian_tpu_torch.kde.ucv import vech

    out = []
    for v, ps in fams:
        dj = len(ps) + 1
        trains = [t for _r, t in engine._fold_trains(v, ps)]
        starts = []
        for t in trains:
            knr = (4.0 / (len(t) * (dj + 2.0))) ** (2.0 / (dj + 4.0))
            starts.append(vech(np.linalg.cholesky(
                knr * np.cov(t, rowvar=False, ddof=1).reshape(dj, dj))))
        out.append((trains, np.array(starts)))
    return out


def _host_pack(entries):
    """The host's float64 padded block of ``_host_starts``'s entries."""
    rows = [t for trains, _s in entries for t in trains]
    npad = max(len(t) for t in rows)
    Xpad = np.zeros((len(rows), npad, rows[0].shape[1]))
    validm = np.zeros((len(rows), npad))
    for b, t in enumerate(rows):
        Xpad[b, : len(t)] = t
        validm[b, : len(t)] = 1.0
    x0s = np.concatenate([s for _t, s in entries])
    return Xpad, validm, np.array([len(t) for t in rows], np.float64), x0s


@pytest.mark.parametrize("null", [0.0, 0.05], ids=["full", "nulls"])
def test_ucv_starts_rows_are_the_host_pack_at_kde5_size(cuda, null):
    """10,000 rows, 10 folds, the 15 families of a shift: per width the
    kernel's float32 block is the host's packed block cast to float32, bit
    for bit (then zeros), its mask and counts the host's, its starts within
    1e-9 of the host's."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ucv_starts

    engine = _kde5_engine(cuda, null)
    pos, data, null_mask, tr_idx, tr_mask, _te, _tm = (
        engine._device_cv_cache())
    fams = _kde5_families()
    for d in (1, 2, 3):
        fs = [f for f in fams if len(f[1]) + 1 == d]
        cols = torch.tensor([[pos[c] for c in (v, *ps)] for v, ps in fs],
                            device=cuda)
        X, valid, Ns, starts, ok = (
            t.cpu() for t in ucv_starts(data, null_mask, cols, tr_idx,
                                        tr_mask))
        Xpad, validm, want_ns, x0s = _host_pack(_host_starts(engine, fs))
        npad = Xpad.shape[1]
        assert torch.equal(X[:, :npad], torch.from_numpy(
            Xpad.astype(np.float32)))
        assert not X[:, npad:].any() and not valid[:, npad:].any()
        assert torch.equal(valid[:, :npad],
                           torch.from_numpy(validm.astype(np.float32)))
        assert torch.equal(Ns, torch.from_numpy(want_ns.astype(np.float32)))
        assert torch.all(ok == 1)
        np.testing.assert_allclose(starts.numpy(), x0s, rtol=1e-9,
                                   atol=1e-7)
        # where every family has a column with nulls (x1 or x3), the block
        # is wider than its widest problem
        nulled = all({"x1", "x3"} & {v, *ps} for v, ps in fs)
        assert (npad < X.shape[1]) == (null > 0 and nulled)


def test_ucv_starts_a_family_alone_and_in_a_batch_of_15(cuda):
    """A family's start and rows are the same bits alone and in a batch of
    15 (the kde5 families of width 2 and 3 padded by repeats), at every
    S."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ucv_starts

    engine = _kde5_engine(cuda, 0.05)
    pos, data, null_mask, tr_idx, tr_mask, _te, _tm = (
        engine._device_cv_cache())
    K = tr_idx.shape[0]
    for d in (2, 3):
        fs = [f for f in _kde5_families(1) + _kde5_families(2)
              if len(f[1]) + 1 == d]
        fs = (fs * 2)[:15]
        cols = torch.tensor([[pos[c] for c in (v, *ps)] for v, ps in fs],
                            device=cuda)
        batch = ucv_starts(data, null_mask, cols, tr_idx, tr_mask)
        for f in (0, 6, 14):
            for split in SPLITS:
                alone = ucv_starts(data, null_mask, cols[f:f + 1], tr_idx,
                                   tr_mask, split=split)
                for name, a, b in zip(STARTS, batch, alone):
                    assert torch.equal(a[f * K:(f + 1) * K], b), (
                        d, f, split, name)


def _host_start_searches(engine, fams):
    """The searches as the CV score ran them before its starts moved to the
    card: ``_host_starts``, the float64 block packed on the host, uploaded
    by ``ucv_search_batch``, one search per width."""
    from pybnesian_tpu_torch.kde.ucv import ucv_search_batch

    by_dj = {}
    for v, ps in fams:
        by_dj.setdefault(len(ps) + 1, []).append((v, ps))
    return [ucv_search_batch(*_host_pack(_host_starts(engine, fs)), d,
                             dtype=np.float32, device=engine.device)
            for d, fs in by_dj.items()]


@pytest.mark.parametrize("null", [0.0, 0.05], ids=["full", "nulls"])
def test_ucv_bandwidths_search_as_from_host_starts(cuda, null):
    """``_ucv_bandwidths`` of the 15 kde5 families on 10,000 rows: one
    ``ucv_starts`` launch and one search a width, its 150 problems counted
    as ``ucv.device_starts``, and each search's optima, iterations and
    evaluations the bits of the host-start route's."""
    from torch.profiler import ProfilerActivity, profile

    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ucv_starts
    from pybnesian_tpu_torch.ops.ucv_search_kernel import ucv_search_cuda
    from pybnesian_tpu_torch.runtime import tracing

    engine = _kde5_engine(cuda, null)
    fams = _kde5_families()
    want = _host_start_searches(engine, fams)
    before = (ucv_starts.launches, ucv_search_cuda.launches)
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        h_maps, got = engine._ucv_bandwidths(
            [(v, ps, None) for v, ps in fams])
    counted = tracing.counters()
    tracing.reset_counters()
    assert (ucv_starts.launches - before[0],
            ucv_search_cuda.launches - before[1]) == (3, 3)
    assert counted["ucv.device_starts"] == 150
    assert "ucv.host_starts" not in counted
    assert sorted(h_maps) == list(range(15))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.iterations, w.iterations)
        np.testing.assert_array_equal(g.lane_evaluations, w.lane_evaluations)
        assert g.evaluations == w.evaluations


def test_ucv_starts_wrapper_rejects_a_split_the_kernel_does_not_take(cuda):
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ucv_starts

    args = _starts_inputs(cuda, d=2)
    for split in (0, 3, 16):
        with pytest.raises(ValueError, match="split"):
            ucv_starts(*args, split=split)
