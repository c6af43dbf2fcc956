"""The CUDA kernel behind ``lg_cv_stats`` (the linear-Gaussian CV, holdout,
Gram and BIC statistics) against its plain torch version, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it runs where only torch is
installed (``--noconftest`` skips tests/conftest.py, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_lg_cv_cuda.py -q

Tolerance: 2e-7 relative per score, BIC and Gram entry against the plain
version run in float64 on the same float32 inputs (the kernel's float64
statistics rounded once to float32); the −inf/NaN pattern exactly.
Bit-equality where the kernel promises it: a family's score, Gram and BIC
alone, inside a batch, padded to a wider batch (the templated and the
runtime-width kernel) and run again.
"""

import math

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops import gaussian
from pybnesian_tpu_torch.ops.gaussian import family_tensors, lg_fold_stats
from pybnesian_tpu_torch.ops.lg_cv_kernel import MAX_PARENTS, lg_cv_stats

pytestmark = pytest.mark.cuda
RTOL = 2e-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run chip_smoke.py)")
    return torch.device("cuda")


def _frame(device, n=3001, D=20, K=5, null=0.05, seed=0):
    """(values, valid, train, test): n rows of D correlated float32 columns
    with ``null`` of the cells null (zeroed), and K folds' dense masks."""
    rng = np.random.default_rng(seed)
    values = rng.normal(0, 1.0, (n, D))
    for j in range(1, D):
        values[:, j] += 0.7 * values[:, j - 1]
    valid = (rng.random((n, D)) >= null).astype(np.float64)
    values = np.where(valid > 0, values, 0.0)
    folds = np.array_split(rng.permutation(n), K)
    train, test = np.zeros((K, n)), np.zeros((K, n))
    for k, te in enumerate(folds):
        test[k, te] = 1.0
        train[k] = 1.0 - test[k]
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (values, valid, train, test)]


def _args(frame, fams, device):
    values, valid, train, test = frame
    return [values, valid, train,
            *family_tensors(fams, np.float32, device), values, valid, test]


def _hold(got, want, label):
    """Relative difference within RTOL, the non-finite pattern and the
    zeros exactly."""
    g = got.double().flatten().cpu()
    w = want.double().flatten().cpu()
    fin = w.isfinite()
    assert torch.equal(g.isfinite(), fin), label
    assert torch.equal(g.isnan(), w.isnan()), label
    odd = ~fin & ~w.isnan()
    assert torch.equal(g[odd], w[odd]), label
    g, w = g[fin], w[fin]
    zero = w == 0
    assert bool((g[zero] == 0).all()), label
    rel = ((g - w).abs()[~zero] / w[~zero].abs()).max() if (~zero).any() \
        else torch.zeros(())
    assert float(rel) <= RTOL, f"{label}: {float(rel)}"


def _check(args):
    got = lg_cv_stats(*args)
    f64 = [a.double() if a is not None and a.is_floating_point() else a
           for a in args]
    want = lg_fold_stats(*f64)
    torch.cuda.synchronize()
    if want.scores is not None:
        assert got.scores.dtype == torch.float32
        _hold(got.scores, want.scores, "scores")
    _hold(got.bic.float(), want.bic, "bic")
    _hold(got.gram.float(), want.gram, "gram")
    return got, want


@pytest.mark.parametrize("width", [0, 1, 2, 3, 16])
def test_matches_the_plain_version_by_width(cuda, width):
    """Families of 0–3 and 16 parents (the widest templated width), and
    every narrower family of the batch padded to it."""
    frame = _frame(cuda)
    fams = [(v, list(range(v + 1, v + 1 + width))) for v in range(3)]
    fams += [(5, []), (6, [7]), (8, [9, 10])]
    before = lg_cv_stats.launches
    _check(_args(frame, fams, cuda))
    assert lg_cv_stats.launches == before + 1


def test_runtime_width_and_holdout(cuda):
    """A family of 18 parents takes the runtime-width kernel; the holdout
    form (one fold of every training row, a test frame of its own) and the
    Gram form (no test rows)."""
    values, valid, _, _ = _frame(cuda)
    fams = [(19, list(range(18))), (0, [1]), (2, [])]
    vi, pi, pm = family_tensors(fams, np.float32, cuda)
    _check([values, valid, None, vi, pi, pm, values, valid, None])
    _check([values[:2000], valid[:2000], None, vi, pi, pm, values[2000:],
            valid[2000:], None])
    got, _ = _check([values, valid, None, vi, pi, pm, None, None, None])
    assert got.scores is None


def test_bit_equal_alone_in_a_batch_padded_and_rerun(cuda):
    """Each family's score, Gram and BIC: alone, inside a batch of 12, and
    padded to 17 parents (the runtime-width kernel) by a wider family in
    the batch, and a second run, all the same bits."""
    frame = _frame(cuda)
    fams = [(v, list(range(v + 1, v + 1 + v % 4))) for v in range(12)]
    together = lg_cv_stats(*_args(frame, fams, cuda))
    again = lg_cv_stats(*_args(frame, fams, cuda))
    wide = lg_cv_stats(*_args(frame, fams + [(19, list(range(17)))], cuda))
    for f, fam in enumerate(fams):
        alone = lg_cv_stats(*_args(frame, [fam], cuda))
        w = len(fam[1]) + 2
        for batch in (together, again, wide):
            assert torch.equal(alone.scores[0], batch.scores[f])
            assert torch.equal(alone.bic[0], batch.bic[f])
            assert torch.equal(alone.gram[0, :, :w - 1, :w - 1],
                               batch.gram[f, :, :w - 1, :w - 1])
            assert torch.equal(alone.gram[0, :, :w - 1, -1],
                               batch.gram[f, :, :w - 1, -1])
            assert torch.equal(alone.gram[0, :, -1, -1],
                               batch.gram[f, :, -1, -1])


def test_degenerate_folds_and_nans(cuda):
    """A constant variable (variance 0), a fold of two training rows
    (underdetermined with a parent: +inf variance), an all-null column
    (no rows) and a NaN cell (0 × NaN reaches every fold's Gram, as in the
    plain version: NaN variances) give the plain version's −inf pattern;
    a NaN in a holdout's test rows alone gives NaN scores."""
    values, valid, train, test = _frame(cuda, n=1500, D=8, K=4)
    values = values.clone()
    valid = valid.clone()
    train = train.clone()
    values[:, 0] = 0.0
    valid[:, 7] = 0.0
    values[:, 7] = 0.0
    values[int(torch.nonzero(test[0])[0, 0]), 1] = math.nan
    keep = torch.nonzero(train[2] * valid[:, 5])[:2, 0]
    train[2] = 0.0
    train[2, keep] = 1.0
    fams = [(0, []), (0, [2]), (1, []), (1, [2]), (2, [3]), (3, [2, 4]),
            (7, []), (4, [7]), (5, [])]
    args = _args([values, valid, train, test], fams, cuda)
    got, want = _check(args)
    s = want.scores.cpu()
    assert bool((s[:8] == -math.inf).all())  # see the docstring, in order
    assert bool(torch.isfinite(s[8]))
    # holdout: fitted on rows 0-999, a NaN in the test rows' column 3
    tv, tvalid = values[:1000, 2:].contiguous(), valid[:1000, 2:].contiguous()
    sv = values[1000:, 2:].clone()
    sv[7, 1] = math.nan
    vi, pi, pm = family_tensors([(1, [0]), (0, []), (2, [1, 0])],
                                np.float32, cuda)
    got, want = _check([tv, tvalid, None, vi, pi, pm, sv,
                        valid[1000:, 2:].contiguous(), None])
    assert bool(torch.isnan(want.scores[[0, 2]]).all())
    assert bool(torch.isfinite(want.scores[1]))


def test_routing_and_the_public_functions(cuda):
    """float32 on the card launches the kernel from every public function
    (CV, holdout, family_grams, batched_bic); float64 takes the plain
    version and launches nothing; both agree."""
    values, valid, train, test = _frame(cuda)
    fam_t = family_tensors([(0, [1]), (2, [])], np.float32, cuda)
    calls = {
        "cv": lambda v, m, tr, te, ft: gaussian.batched_lg_cv_loglik(
            v, m, tr, te, *ft),
        "holdout": lambda v, m, tr, te, ft: gaussian.batched_lg_holdout_loglik(
            v[:2000], m[:2000], v[2000:], m[2000:], *ft),
        "grams": lambda v, m, tr, te, ft: gaussian.family_grams(v, m, *ft)[0],
        "bic": lambda v, m, tr, te, ft: gaussian.batched_bic(v, m, *ft),
    }
    f64 = [t.double() for t in (values, valid, train, test)]
    fam64 = (fam_t[0], fam_t[1], fam_t[2].double())
    for name, call in calls.items():
        before = lg_cv_stats.launches
        got = call(values, valid, train, test, fam_t)
        assert lg_cv_stats.launches == before + 1, name
        want = call(*f64, fam64)
        assert lg_cv_stats.launches == before + 1, name
        assert got.dtype == torch.float32 and want.dtype == torch.float64
        _hold(got, want, name)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    values, valid, train, test = _frame(cuda, n=200, D=4, K=2)
    fam_t = family_tensors([(0, [1])], np.float32, cuda)
    with pytest.raises(TypeError, match="float32"):
        lg_cv_stats(values.double(), valid, train, *fam_t, values, valid,
                    test)
    with pytest.raises(ValueError, match="contiguous"):
        lg_cv_stats(values.T.contiguous().T, valid, train, *fam_t, values,
                    valid, test)
    with pytest.raises(ValueError, match="shape"):
        lg_cv_stats(values, valid, train[:, :100].contiguous(), *fam_t,
                    values, valid, test)
    with pytest.raises(ValueError, match="cpu"):
        lg_cv_stats(values, valid.cpu(), train, *fam_t, values, valid, test)
    wide = family_tensors([(0, list(range(1, MAX_PARENTS + 2)))], np.float32,
                          cuda)
    big = torch.zeros((10, MAX_PARENTS + 2), device=cuda)
    with pytest.raises(ValueError, match="parents"):
        lg_cv_stats(big, big, None, *wide)


SPLITS = (1, 2, 4, 8)


def _every_split(args):
    """The kernel at every cluster size S the entry point takes and with
    one fold a program and the most, each result (scores, Grams, BICs)
    bit-equal to S = 1's with one fold a program, NaN in the same places;
    returns that one."""
    from pybnesian_tpu_torch.ops.lg_cv_kernel import fold_chunk

    K = 1 if args[2] is None else args[2].shape[0]
    most = fold_chunk(K, args[4].shape[1] + 2)
    first = lg_cv_stats(*args, chunk=1, split=1)
    for chunk in sorted({1, most}):
        for split in SPLITS:
            got = lg_cv_stats(*args, chunk=chunk, split=split)
            torch.cuda.synchronize()
            for name in ("scores", "gram", "bic"):
                a, b = getattr(first, name), getattr(got, name)
                if a is None:
                    assert b is None
                    continue
                label = (chunk, split, name)
                assert torch.equal(torch.isnan(a), torch.isnan(b)), label
                assert torch.equal(torch.nan_to_num(a),
                                   torch.nan_to_num(b)), label
    return first


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 9000, 100_000])
def test_row_counts_at_the_leaf_edges_at_every_split(cuda, n):
    """Row counts of no row, one, a leaf's edge (two leaves of 256 rows
    start at 512) and 9,000 and 100,000 rows, in the CV form (2 folds of
    the frame) and the holdout form (a test frame of its own): the kernel
    against its float64 plain version where the plain version is finite,
    and the same bits at every S."""
    from pybnesian_tpu_torch.ops.lg_cv_kernel import lg_leaves

    assert lg_leaves(n) == (1 if n < 512 else 2 if n < 1024 else 8)
    frame = _frame(cuda, n=max(n, 2), D=6, K=2, seed=n % 1000)
    frame = [t[:n] if i < 2 else t[:, :n] for i, t in enumerate(frame)]
    fams = [(0, []), (1, [0]), (2, [0, 1]), (3, [4])]
    values, valid = frame[0], frame[1]
    cv = [values, valid, frame[2].contiguous(),
          *family_tensors(fams, np.float32, cuda), values, valid,
          frame[3].contiguous()]
    holdout = [values, valid, None, *family_tensors(fams, np.float32, cuda),
               values[: max(n // 3, 1)].contiguous(),
               valid[: max(n // 3, 1)].contiguous(), None]
    for args in (cv, holdout):
        _every_split(args)
        if n > 1:
            _check(args)


def test_batch_of_150_at_every_split_alone_and_padded(cuda):
    """15 families × 10 folds (150 programs) at 3,000 rows: every S gives
    the same bits, and each family the bits it gets alone and padded by a
    wider family to W 17 (templated) and W 20 (the runtime width), at every
    S."""
    frame = _frame(cuda, K=10)
    fams = [(v, list(range(v + 1, v + 1 + v % 3))) for v in range(15)]
    together = _every_split(_args(frame, fams, cuda))
    for f in (0, 4, 14):
        w = len(fams[f][1]) + 2
        for extra in ([], [(19, list(range(15)))], [(19, list(range(18)))]):
            for split in SPLITS:
                alone = lg_cv_stats(*_args(frame, [fams[f]] + extra, cuda),
                                    split=split)
                assert torch.equal(alone.scores[0], together.scores[f])
                assert torch.equal(alone.bic[0], together.bic[f])
                assert torch.equal(alone.gram[0, :, :w - 1, :w - 1],
                                   together.gram[f, :, :w - 1, :w - 1])
                assert torch.equal(alone.gram[0, :, :w - 1, -1],
                                   together.gram[f, :, :w - 1, -1])
                assert torch.equal(alone.gram[0, :, -1, -1],
                                   together.gram[f, :, -1, -1])


def test_nan_row_in_the_last_leaf_at_every_split(cuda):
    """A NaN cell in the frame's last row (the last leaf of every fold):
    every family on that column gets −inf in every fold, as in the plain
    version, at every S, and every other family stays finite."""
    values, valid, train, test = _frame(cuda, n=2100, D=8, K=3)
    values = values.clone()
    values[-1, 3] = math.nan
    fams = [(3, []), (4, [3]), (5, []), (6, [5])]
    args = _args([values, valid, train, test], fams, cuda)
    _check(args)
    got = _every_split(args)
    s = got.scores.cpu()
    assert bool((s[:2] == -math.inf).all()) and bool(s[2:].isfinite().all())


def test_out_of_range_indices_read_nan(cuda):
    """A variable index past the frame's columns: that family's scores and
    BICs are −inf (no read out of bounds), the other families keep the
    bits they get without it, at every S."""
    frame = _frame(cuda, n=1500, D=6, K=3)
    fams = [(0, [1]), (2, []), (3, [4])]
    clean = lg_cv_stats(*_args(frame, fams, cuda))
    args = _args(frame, fams + [(0, [])], cuda)
    args[3] = args[3].clone()
    args[3][3] = 6
    got = _every_split(args)
    assert bool((got.scores[3] == -math.inf).all())
    assert bool((got.bic[3] == -math.inf).all())
    assert torch.equal(got.scores[:3], clean.scores)
    assert torch.equal(got.bic[:3], clean.bic)


def test_degenerate_folds_at_every_split(cuda):
    """test_degenerate_folds_and_nans's CV batch (variance 0, two training
    rows, an all-null column, a NaN cell): the same −inf pattern and bits
    at every S."""
    values, valid, train, test = _frame(cuda, n=1500, D=8, K=4)
    values, valid, train = values.clone(), valid.clone(), train.clone()
    values[:, 0] = 0.0
    valid[:, 7] = 0.0
    values[:, 7] = 0.0
    values[int(torch.nonzero(test[0])[0, 0]), 1] = math.nan
    keep = torch.nonzero(train[2] * valid[:, 5])[:2, 0]
    train[2] = 0.0
    train[2, keep] = 1.0
    fams = [(0, []), (0, [2]), (1, []), (1, [2]), (2, [3]), (3, [2, 4]),
            (7, []), (4, [7]), (5, [])]
    got = _every_split(_args([values, valid, train, test], fams, cuda))
    s = got.scores.cpu()
    assert bool((s[:8] == -math.inf).all()) and bool(torch.isfinite(s[8]))


def test_wrapper_rejects_a_split_the_kernel_does_not_take(cuda):
    frame = _frame(cuda, n=200, D=4, K=2)
    for split in (0, 3, 16):
        with pytest.raises(ValueError, match="split"):
            lg_cv_stats(*_args(frame, [(0, [1])], cuda), split=split)
    for chunk in (0, 3):
        with pytest.raises(ValueError, match="chunk"):
            lg_cv_stats(*_args(frame, [(0, [1])], cuda), chunk=chunk)
