"""The torch port's CV-CKDE path (pybnesian_tpu_torch/ops/kde.py) against
the JAX package's, on the cases of tests/factors/test_pallas_cv.py.

Every case has an evidence-free family, 5% nulls and ragged folds. Float64:
rtol 1e-9 / atol 1e-7 (the same math in another summation order). Float32:
rtol 5e-4 / atol 5e-3, the tolerance the reference's own flash test uses.
The JAX flash path runs its Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu.ops import kde as jkde
from pybnesian_tpu_torch.ops import kde as tkde
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


F64 = dict(rtol=1e-9, atol=1e-7)
F32 = dict(rtol=5e-4, atol=5e-3)


def _setup(F=4, n=512, D=4, K=3, djmax=2, seed=0, degenerate=False):
    """numpy arrays of test_pallas_cv.py's ``_setup``. With ``degenerate``,
    column 3 is null except on 10 rows of fold 0's test part: fold 0 of
    every family that uses it has no train row and must give NaN."""
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 1.5, (n, D))
    for j in range(1, D):
        data[:, j] += 0.7 * data[:, j - 1]
    null = np.zeros((n, D))
    null[rng.random((n, D)) < 0.05] = 1.0
    idx = rng.permutation(n)
    folds = np.array_split(idx, K)
    if degenerate:
        null[:, 3] = 1.0
        null[folds[0][:10], 3] = 0.0
    data = np.where(null > 0, 0.0, data)

    col_idx = np.zeros((F, djmax), np.int64)
    col_mask = np.zeros((F, djmax))
    # families: evidence first, variable last
    col_idx[0, 0] = 0
    col_mask[0, 0] = 1.0  # univariate
    for f in range(1, F):
        col_idx[f, 0] = (f + 1) % D
        col_idx[f, 1] = f % D
        col_mask[f, :2] = 1.0

    ntr = 256 * ((n - min(len(f) for f in folds)) // 256 + 1)
    nte = 256 * ((max(len(f) for f in folds) + 255) // 256)
    tr_idx = np.zeros((K, ntr), np.int64)
    tr_mask = np.zeros((K, ntr))
    te_idx = np.zeros((K, nte), np.int64)
    te_mask = np.zeros((K, nte))
    for k in range(K):
        te = folds[k]
        tr = np.concatenate([folds[j] for j in range(K) if j != k])
        tr_idx[k, : len(tr)] = tr
        tr_mask[k, : len(tr)] = 1.0
        te_idx[k, : len(te)] = te
        te_mask[k, : len(te)] = 1.0
    return [data, null, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask]


CASES = {
    "nr": (dict(), "nr"),
    "scott": (dict(), "scott"),
    "wide": (dict(F=2, djmax=4, seed=1), "nr"),
    "degenerate": (dict(degenerate=True), "nr"),
}


def _args(case, dtype):
    kw, rule = CASES[case]
    arrays = _setup(**kw)
    floats = (0, 1, 3, 5, 7)
    jax_args = [
        jnp.asarray(a.astype(dtype) if i in floats else a.astype(np.int32))
        for i, a in enumerate(arrays)
    ]
    torch_args = [
        torch.as_tensor(a.astype(dtype) if i in floats else a)
        for i, a in enumerate(arrays)
    ]
    return jax_args, torch_args, rule


@pytest.mark.parametrize("case", ["nr", "scott", "degenerate"])
def test_whitened_parts_f64(case):
    jargs, targs, rule = _args(case, np.float64)
    want = jkde.ckde_cv_whitened_parts(*jargs, rule=rule)
    got = tkde.ckde_cv_whitened_parts(*targs, rule=rule)
    names = ["jtr", "neg", "zv_tr", "jte", "zv_te", "wte", "lndiff", "ok"]
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float64, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_alldevice_f64(case):
    jargs, targs, rule = _args(case, np.float64)
    want = np.asarray(jkde.ckde_cv_alldevice(*jargs, chunk=256, rule=rule))
    got = tkde.ckde_cv_alldevice(*targs, rule=rule).numpy()
    np.testing.assert_allclose(got, want, **F64)
    if case == "degenerate":
        # families 2 and 3 use column 3; their fold 0 has no train row
        assert np.all(np.isnan(got[2:])) and np.all(np.isfinite(got[:2]))
    else:
        assert np.all(np.isfinite(got))


@pytest.mark.parametrize("case", ["nr", "wide", "degenerate"])
def test_alldevice_f32(case):
    jargs, targs, rule = _args(case, np.float32)
    want = np.asarray(jkde.ckde_cv_alldevice(*jargs, chunk=256, rule=rule))
    got = tkde.ckde_cv_alldevice(*targs, rule=rule)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_f32(case):
    jargs, targs, rule = _args(case, np.float32)
    want = np.asarray(jkde.ckde_cv_alldevice_flash(
        *jargs, rule=rule, block_m=128, block_n=256, interpret=True))
    got = tkde.ckde_cv_alldevice_flash(*targs, rule=rule).numpy()
    np.testing.assert_allclose(got, want, **F32)
    # the port's two routes agree with each other too
    dense = tkde.ckde_cv_alldevice(*targs, rule=rule).numpy()
    np.testing.assert_allclose(got, dense, **F32)


def test_selfcheck_cpu():
    ok, diff = tkde.flash_cv_selfcheck(device="cpu")
    assert ok, f"selfcheck diff {diff}"
    assert diff < 5e-2


def test_cholesky_or_nan_matches_jax():
    """A bandwidth that is not positive definite gives a factor with a NaN
    lower triangle in both packages (torch.linalg.cholesky would raise)."""
    from pybnesian_tpu_torch.ops.linalg import cholesky_or_nan

    H = np.array([
        [[2.0, 0.5, 0.1], [0.5, 1.0, 0.2], [0.1, 0.2, 0.5]],   # SPD
        [[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]],   # indefinite
        [[1.0, 0.0, 0.0], [0.0, -1e-12, 0.0], [0.0, 0.0, 1.0]],
    ])
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(H)))
    got = cholesky_or_nan(torch.as_tensor(H)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    rows, cols = np.tril_indices(3)
    assert np.all(np.isnan(got[1:, rows, cols]))
    assert np.all(np.isfinite(got[0]))
    np.testing.assert_allclose(got[0], want[0], **F64)


def test_flash_reduce_matches_jax():
    """Per-fold sums: test rows with weight 0 drop out even where their
    value is not finite, and a fold with ``ok`` 0 makes its family NaN."""
    rng = np.random.default_rng(3)
    F, K, nte = 3, 2, 16
    out = rng.normal(-2.0, 0.5, (F, K, nte))
    wte = (rng.random((F, K, nte)) < 0.8).astype(np.float64)
    out[wte == 0] = -np.inf
    lndiff = rng.normal(-1.0, 0.1, (F, K))
    ok = np.ones((F, K))
    ok[1, 0] = 0.0
    args = (out, wte, lndiff, ok)
    want = np.asarray(jkde._flash_reduce(*(jnp.asarray(a) for a in args)))
    got = tkde._flash_reduce(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, **F64)
    assert np.isnan(got[1]) and np.all(np.isfinite(got[[0, 2]]))


PART_NAMES = ["jtr", "neg", "zv_tr", "jte", "zv_te", "wte", "lndiff", "ok"]


@pytest.mark.parametrize("case", list(CASES))
def test_whitened_parts_f32(case):
    """The float32 plain version against the JAX package's float32 parts at
    the port's float32 tolerance, and against its own float64 path on the
    same float32 data: every statistic is float64, so each output is that
    float64 value rounded once (``lndiff`` stays float64)."""
    jargs, targs, rule = _args(case, np.float32)
    want = jkde.ckde_cv_whitened_parts(*jargs, rule=rule)
    got = tkde.ckde_cv_whitened_parts(*targs, rule=rule)
    wide = [a.double() if a.is_floating_point() else a for a in targs]
    f64 = tkde.ckde_cv_whitened_parts(*wide, rule=rule)
    for name, g, w, d in zip(PART_NAMES, got, want, f64):
        assert g.dtype == (torch.float64 if name == "lndiff"
                           else torch.float32), name
        np.testing.assert_allclose(g.double().numpy(), np.asarray(w), **F32,
                                   err_msg=name)
        torch.testing.assert_close(g, d.to(g.dtype), rtol=0, atol=0,
                                   equal_nan=True, msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_whitened_parts_bandwidths(case):
    """The bandwidths route (UCV's and a user selector's) in float64 against
    the rule's own matrices: given the normal-reference bandwidths the rule
    computes, the parts are the rule's to 1e-9."""
    _, targs, rule = _args(case, np.float64)
    data, null, col_idx, col_mask, tr_idx, tr_mask, _, _ = targs
    F, djmax = col_idx.shape
    K = tr_idx.shape[0]
    fam = data[:, col_idx].permute(1, 0, 2) * col_mask[:, None, :]
    fvalid = 1.0 - torch.amax(null[:, col_idx].permute(1, 0, 2)
                              * col_mask[:, None, :], dim=2)
    w = tr_mask[None] * fvalid[:, tr_idx]
    train = fam[:, tr_idx]
    n = w.sum(2)
    mean = (train * w[..., None]).sum(2) / n[..., None]
    xc = (train - mean[:, :, None]) * (w[..., None] * col_mask[:, None, None])
    cov = xc.mT @ xc / (n - 1.0)[..., None, None]
    d = col_mask.sum(1)[:, None]
    k = ((4.0 / (n * (d + 2.0))) ** (2.0 / (d + 4.0)) if rule == "nr"
         else n ** (-2.0 / (d + 4.0)))
    H = k[..., None, None] * cov
    assert H.shape == (F, K, djmax, djmax)
    want = tkde.ckde_cv_whitened_parts(*targs, rule=rule)
    got = tkde.ckde_cv_whitened_parts(*targs, rule=None, bandwidths=H)
    for name, g, w_ in zip(PART_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), **F64,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["nr", "degenerate"])
def test_flash_reduce_f32(case):
    """The float32 fold sums against the JAX package's at the float32
    tolerance, and equal to the float64 sums of the same float32 rows
    rounded once."""
    jargs, targs, rule = _args(case, np.float32)
    parts = tkde.ckde_cv_whitened_parts(*targs, rule=rule)
    F, K, ntr, djmax = parts[0].shape
    nte = parts[3].shape[2]
    out = tkde._dense_pairs(
        parts[0].reshape(F * K, ntr, djmax), parts[1].reshape(F * K, ntr),
        parts[2].reshape(F * K, ntr), parts[3].reshape(F * K, nte, djmax),
        parts[4].reshape(F * K, nte)).reshape(F, K, nte)
    wte, lndiff, ok = parts[5:]
    got = tkde._flash_reduce(out, wte, lndiff, ok)
    assert got.dtype == torch.float32 and got.shape == (F,)
    want = np.asarray(jkde._flash_reduce(
        jnp.asarray(out.numpy()), jnp.asarray(wte.numpy()),
        jnp.asarray(lndiff.numpy().astype(np.float32)),
        jnp.asarray(ok.numpy())))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    f64 = tkde._flash_reduce(out.double(), wte.double(), lndiff, ok.double())
    torch.testing.assert_close(got, f64.float(), rtol=0, atol=0,
                               equal_nan=True)


def _wrapper_args(case="nr"):
    _, targs, rule = _args(case, np.float32)
    return [a.contiguous() for a in targs], rule


def test_whiten_wrapper_on_the_cpu_takes_the_plain_version():
    """CPU tensors take the plain version, in the kernel's layout (kernel
    #1's seven arguments for G = F·K programs, then the fold reduce's
    three), and launch nothing."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        ckde_cv_fold_reduce, ckde_cv_whiten)

    args, rule = _wrapper_args()
    before = (ckde_cv_whiten.launches, ckde_cv_fold_reduce.launches)
    got = ckde_cv_whiten(*args, rule=rule)
    parts = tkde.ckde_cv_whitened_parts(*args, rule=rule)
    F, K, ntr, djmax = parts[0].shape
    nte = parts[3].shape[2]
    G = F * K
    want_shapes = [(G, ntr, djmax), (G, ntr), (G, ntr), (G, nte, djmax),
                   (G, nte), (G,), (G,), (F, K, nte), (F, K), (F, K)]
    assert [tuple(t.shape) for t in got] == want_shapes
    assert all(t.is_contiguous() for t in got)
    for g, w in zip(got[:5], parts[:5]):
        torch.testing.assert_close(g, w.reshape(g.shape), rtol=0, atol=0,
                                   equal_nan=True)
    for g, w in zip(got[7:], parts[5:]):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    # family 0 is evidence-free; lm_const = log n_valid
    no_ev = got[5].reshape(F, K)
    assert torch.all(no_ev[0] == 1) and torch.all(no_ev[1:] == 0)
    n_valid = (got[1] == 0).sum(1).double()
    torch.testing.assert_close(got[6], torch.log(n_valid).float())
    out = torch.zeros((F, K, nte))
    reduced = ckde_cv_fold_reduce(out, *got[7:])
    torch.testing.assert_close(reduced, tkde._flash_reduce(out, *got[7:]),
                               rtol=0, atol=0)
    assert (ckde_cv_whiten.launches, ckde_cv_fold_reduce.launches) == before


def test_whiten_wrappers_raise_off_the_cpu_without_a_kernel():
    """A device that is neither the CPU nor CUDA has no kernel and no
    plain fall-back: both wrappers raise."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import (
        ckde_cv_fold_reduce, ckde_cv_whiten)

    args, rule = _wrapper_args()
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no ckde_cv_whiten kernel"):
        ckde_cv_whiten(*meta, rule=rule)
    F, K = 4, 3
    with pytest.raises(ValueError, match="no ckde_cv_fold_reduce kernel"):
        ckde_cv_fold_reduce(
            torch.zeros((F, K, 5), device="meta"),
            torch.zeros((F, K, 5), device="meta"),
            torch.zeros((F, K), dtype=torch.float64, device="meta"),
            torch.zeros((F, K), device="meta"))


@pytest.mark.parametrize("bad", ["float64 data", "int32 index", "dpad 17",
                                 "rule", "bandwidth shape", "mixed devices"])
def test_whiten_wrapper_checks_its_arguments(bad):
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ckde_cv_whiten

    args, rule = _wrapper_args()
    kw = {"rule": rule}
    if bad == "float64 data":
        args[0], err = args[0].double(), TypeError
    elif bad == "int32 index":
        args[2], err = args[2].int(), TypeError
    elif bad == "dpad 17":
        args[2] = torch.zeros((4, 17), dtype=torch.int64)
        args[3], err = torch.ones((4, 17)), ValueError
    elif bad == "rule":
        kw, err = {"rule": "silverman"}, ValueError
    elif bad == "bandwidth shape":
        kw, err = {"rule": None, "bandwidths": torch.ones((4, 3, 3, 3))}, \
            ValueError
    else:
        args[1], err = args[1].to("meta"), ValueError
    with pytest.raises(err):
        ckde_cv_whiten(*args, **kw)


def test_cv_whiten_source_matches_its_binding():
    """The C entry points of csrc/cv_whiten.cu take their arguments in the
    order the wrappers pass them (19 pointers, 9 ints, the last the
    launch plan's cluster size, and the stream for the whitening; 5
    pointers, 4 ints, the last the cluster size, and the stream for the
    fold sums),
    the kernel's widest family is the wrapper's, and nothing sums with
    atomics: the order of every sum is fixed."""
    import re
    from pathlib import Path

    from pybnesian_tpu_torch.ops import cv_whiten_kernel as cw

    text = (Path(cw.__file__).resolve().parent.parent / "csrc"
            / "cv_whiten.cu").read_text()

    def params(fn):
        found = re.search(rf"int {fn}\(([^)]*)\)", text).group(1)
        return [p.split()[-1].lstrip("*") for p in found.split(",")]

    assert params("ckde_cv_whiten_f32") == [
        "data", "null_mask", "col_idx", "col_mask", "tr_idx", "tr_mask",
        "te_idx", "te_mask", "bandwidths", "jtr", "neg", "zv_tr", "jte",
        "zv_te", "no_ev", "lm_const", "wte", "lndiff", "ok", "n", "D", "F",
        "K", "ntr", "nte", "dpad", "rule", "split", "stream"]
    assert params("ckde_cv_fold_reduce_f32") == [
        "rows", "wte", "lndiff", "ok", "out", "F", "K", "nte", "split",
        "stream"]
    binding = Path(cw.__file__).read_text()
    assert "[ctypes.c_void_p] * 19 + [ctypes.c_int] * 9" in binding
    assert "[ctypes.c_void_p] * 5 + [ctypes.c_int] * 4" in binding
    constants = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(constants["kMaxD"]) == cw.MAX_DPAD
    assert "atomicAdd" not in text and "atomicCAS" not in text


# (F, K): phase 4's CV call, ``hc``'s CV batches (F 1–8 and its cache
# pass's 56), the holdout batches (K 1), the 100,000-row call, a wide batch
# and folds past a round of MAX_FOLDS
REDUCE_SHAPES = [(15, 10), (1, 10), (2, 10), (8, 10), (56, 10), (1, 1),
                 (8, 1), (80, 10), (150, 10), (1, 3), (4, 17), (1, 40),
                 (2, 200), (1000, 10)]


def _rank_folds(K, split, max_folds):
    """The fold reduce's rounds, as csrc/cv_whiten.cu's fold_reduce_kernel
    takes them: {rank: [folds of round 0, of round 1, ...]}, rank q taking
    folds q, q + S, ... and each round the next max_folds of them."""
    rounds = -(-K // (max_folds * split))
    return {q: [[k for j in range(max_folds)
                 if (k := r * max_folds * split + q + j * split) < K]
                for r in range(rounds)]
            for q in range(split)}


@pytest.mark.parametrize("sms", [1, 16, 78, 132])
@pytest.mark.parametrize("F,K", REDUCE_SHAPES)
def test_reduce_plan(F, K, sms):
    """The fold reduce's cluster size: 1 ≤ S ≤ min(K, 8); every fold goes
    to exactly one rank, each round's folds in order and a block's sums
    within one block sum (kMaxSums / 2 folds); F·S reaches the SM count
    unless S is at K or 8; no smaller S would leave its ranks as few
    folds."""
    import re
    from pathlib import Path

    from pybnesian_tpu_torch.ops import cv_whiten_kernel as cw

    csrc = Path(cw.__file__).resolve().parent.parent / "csrc"
    text = (csrc / "cv_whiten.cu").read_text() + (
        csrc / "common.cuh").read_text()  # the source and its header
    constants = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    max_folds = int(constants["kMaxFolds"])
    assert max_folds == cw.MAX_FOLDS == int(constants["kMaxSums"]) // 2
    assert cw.MAX_SPLIT == int(constants["kMaxSplit"])
    split = cw._reduce_plan(F, K, sms)
    assert 1 <= split <= min(K, 8)
    ranks = _rank_folds(K, split, max_folds)
    folds = sorted(k for rounds in ranks.values() for r in rounds for k in r)
    assert folds == list(range(K))
    assert all(len(r) <= max_folds for rounds in ranks.values()
               for r in rounds)
    # round r of every rank covers folds [r·NF·S, (r + 1)·NF·S): rank 0
    # adds them in order as the round ends
    for r in range(len(ranks[0])):
        span = sorted(k for q in ranks for k in ranks[q][r])
        assert span == list(range(r * max_folds * split,
                                  min(K, (r + 1) * max_folds * split)))
    per_rank = -(-K // split)
    assert F * split >= sms or split == min(K, 8) or (
        -(-K // min(K, 8, -(-sms // F))) == per_rank)
    if split > 1:
        assert -(-K // (split - 1)) > per_rank


def test_reduce_wrapper_rejects_a_split_the_kernel_does_not_take():
    """On the CPU too: S outside 1..min(K, 8) raises before any launch."""
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ckde_cv_fold_reduce

    F, K, nte = 2, 3, 5
    args = (torch.zeros((F, K, nte)), torch.ones((F, K, nte)),
            torch.zeros((F, K), dtype=torch.float64), torch.ones((F, K)))
    for split in (0, 4, 9, -1):
        with pytest.raises(ValueError, match="split"):
            ckde_cv_fold_reduce(*args, split=split)
    for split in (1, 2, 3):
        assert torch.equal(ckde_cv_fold_reduce(*args, split=split),
                           ckde_cv_fold_reduce(*args))
