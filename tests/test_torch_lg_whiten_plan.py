"""The launch plans of the CV whitening kernel (``csrc/cv_whiten.cu``) and
the linear-Gaussian kernel (``csrc/lg_cv.cu``), on the CPU.

Each kernel splits a program's train rows into L fixed leaves by the rule
of the kernels' shared header ``csrc/common.cuh`` (``whiten_leaves(ntr)``
in ``ops/cv_whiten_kernel.py``, ``lg_leaves(n)`` in ``ops/lg_cv_kernel.py``,
both ``leaf_count`` of ``ops/cuda_build.py``): leaf l holds rows [l·size,
(l + 1)·size), size = ceil(n / L), its sums run in a fixed order and the
leaves merge in a balanced tree. The plan (``_launch_plan``) only chooses
S, the blocks of the thread-block cluster that share a program's leaves,
rank q sweeping leaves [q L / S, (q + 1) L / S). These tests hold the
leaves to the row count alone, the plan to what the entry points accept
(the limits read from the sources and the header), and the plain versions
beside the kernels to the JAX package at row counts on the leaves' edges.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu.ops import kde as jkde
from pybnesian_tpu.ops.gaussian import batched_lg_cv_loglik as jax_lg_cv
from pybnesian_tpu_torch.ops import cuda_build as cb
from pybnesian_tpu_torch.ops import cv_whiten_kernel as wk
from pybnesian_tpu_torch.ops import lg_cv_kernel as lk
from pybnesian_tpu_torch.ops.gaussian import family_tensors
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

CSRC = Path(wk.__file__).resolve().parent.parent / "csrc"
HEADER = CSRC / "common.cuh"
KERNELS = {"whiten": (wk, wk.whiten_leaves, CSRC / "cv_whiten.cu"),
           "lg": (lk, lk.lg_leaves, CSRC / "lg_cv.cu")}
H100_SMS = 132
SM_COUNTS = [1, 16, 78, 114, H100_SMS]
ROW_COUNTS = [0, 1, 255, 256, 511, 512, 513, 1023, 1024, 2047, 2048, 8000,
              9000, 90_000, 100_000]
GRIDS = [1, 2, 7, 10, 56, 70, 150, 200, 560, 1500, 65535]
EDGES = [511, 512, 513, 1023, 1024]  # leaf counts change at 512 and 1024
LG_BATCHES = [(1, 10, 3), (56, 10, 3), (56, 1, 3), (7, 10, 4), (20, 10, 3),
              (1, 10, 17), (1, 10, 20), (150, 5, 2), (1500, 10, 3),
              (3, 40, 2), (2, 10, 64)]  # (F, K, W)
# the wrappers take float32: each float32 output one rounding of the
# float64 value that the JAX package computes from the same float32 inputs
ROUNDED = dict(rtol=2e-6, atol=2e-6)


def _constants(path):
    """The integer constants of a source and of the header it includes;
    neither defines one the other does."""
    source, header = (
        {name: int(value) for name, value in
         re.findall(r"constexpr int (k\w+) = (\d+);", p.read_text())}
        for p in (path, HEADER))
    assert not set(source) & set(header)
    return {**source, **header}


def _leaf_rows(leaves_of, n):
    leaves = leaves_of(n)
    size = -(-n // leaves)
    return [(min(n, q * size), min(n, (q + 1) * size)) for q in range(leaves)]


def _rank_leaves(leaves, split):
    return [list(range(q * leaves // split, (q + 1) * leaves // split))
            for q in range(split)]


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_python_limits_mirror_the_source(kernel):
    """Each kernel's limits mirror its source, and its leaves are the
    header's rule: the source includes the header and defines no leaf rule
    of its own, and the wrapper's leaves are cuda_build's mirror of it."""
    module, leaves_of, source = KERNELS[kernel]
    c = _constants(source)
    text = source.read_text()
    assert module.THREADS == c["kThreads"]
    assert cb.MAX_LEAVES == c["kMaxLeaves"]
    assert cb.LEAF_ROWS == c["kLeafRows"]
    assert module.MAX_SPLIT == cb.MAX_SPLIT == c["kMaxSplit"] <= 8
    assert '#include "common.cuh"' in text and "leaf_count(" in text
    assert "while (2 * leaves" not in text
    assert leaves_of is cb.leaf_count
    if kernel == "whiten":
        assert wk.MAX_DPAD == c["kMaxD"]
    else:
        assert lk.MAX_PARENTS + 2 == c["kMaxW"]
        assert lk.MAX_CHUNK == c["kMaxChunk"]
        assert lk.MAX_PAIRS == c["kMaxPairs"]


@pytest.mark.parametrize("K", [1, 2, 5, 10, 17, 40])
@pytest.mark.parametrize("W", [2, 3, 4, 8, 9, 18, 19, 40, 64])
def test_fold_chunk_mirrors_the_source(K, W):
    """The LG kernel's programs hold a family's folds in chunks that keep
    their (fold, entry) sums within kMaxPairs; the source's rule, read from
    it, and the mirror agree, and the chunks cover the K folds."""
    body = re.search(r"int fold_chunk\(int K, int W\) \{(.*?)\n\}",
                     KERNELS["lg"][2].read_text(), re.S).group(1)
    assert "int chunk = kMaxPairs / E;" in body
    assert "chunk < kMaxChunk ? chunk : kMaxChunk" in body
    assert "chunk < K ? chunk : K" in body
    E = W * (W + 1) // 2
    want = max(1, min(K, 16, 360 // E))
    chunk = lk.fold_chunk(K, W)
    assert chunk == want
    assert chunk * E <= lk.MAX_PAIRS or chunk == 1
    assert lk.programs(3, K, chunk) == 3 * -(-K // chunk)


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("F,K,W", LG_BATCHES)
def test_lg_plan_takes_fewer_folds_only_for_a_small_grid(F, K, W, sms):
    """The plan's fold chunk is fold_chunk's, halved (rounded up) only
    while the programs it gives, split to the leaves, fit one block per
    SM; the next halving would not fit."""
    n = 8000
    leaves = min(lk.lg_leaves(n), lk.MAX_SPLIT)
    chunk, _ = lk._launch_plan(F, K, W, n, sms)
    most = lk.fold_chunk(K, W)
    if chunk < most:
        assert lk.programs(F, K, chunk) * leaves <= sms
    if chunk > 1:
        assert lk.programs(F, K, -(-chunk // 2)) * leaves > sms


@pytest.mark.parametrize("entry,ints,plan", [
    ("ckde_cv_whiten_f32", 9, ["split"]),
    ("lg_cv_f32", 8, ["chunk", "split"])])
def test_entry_points_take_the_plan_last(entry, ints, plan):
    """The C signature ends (..., plan, stream), the order in which the
    wrappers pass the plan and the stream."""
    source = KERNELS["whiten" if "whiten" in entry else "lg"][2]
    params = re.search(entry + r"\(([^)]*)\)", source.read_text()).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[-len(plan) - 1:] == plan + ["stream"]
    assert sum(p.split()[0] == "int" for p in params.split(",")) == ints


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("n", ROW_COUNTS)
def test_leaves_depend_on_the_row_count_alone(kernel, n):
    """A power of two up to 8 leaves that tile [0, n) in order, each of at
    least LEAF_ROWS rows when there are two or more."""
    module, leaves_of, _ = KERNELS[kernel]
    layout = _leaf_rows(leaves_of, n)
    leaves = len(layout)
    assert leaves & (leaves - 1) == 0 and leaves <= cb.MAX_LEAVES
    assert layout[0][0] == 0 and layout[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(layout, layout[1:]))
    if leaves > 1:
        assert min(hi - lo for lo, hi in layout) >= cb.LEAF_ROWS




def _plans(kernel, n, sms):
    """(programs, S, blocks per SM aimed at, least work a block keeps) of
    the plans of n rows over grids of every size."""
    if kernel == "whiten":
        for G in GRIDS:
            for dpad in (1, 3, 8, 9, 16):
                target = wk.TARGET_BLOCKS_PER_SM * (2 if dpad > 8 else 1)
                yield G, wk._launch_plan(G, n, dpad, sms), target, None
    else:
        for F, K, W in LG_BATCHES:
            chunk, split = lk._launch_plan(F, K, W, n, sms)
            assert 1 <= chunk <= lk.fold_chunk(K, W)
            work = n * chunk * W * (W + 1) // 2
            yield (lk.programs(F, K, chunk), split, lk.TARGET_BLOCKS_PER_SM,
                   work)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("n", [0, 300, 600, 2048, 9000, 100_000])
def test_plan_is_a_power_of_two_with_no_empty_block(kernel, sms, n):
    """At every grid: S in 1, 2, 4, 8 and at most the leaves, so every rank
    sweeps L / S leaves; S stops at the target blocks per SM, at the
    leaves, or (LG) where doubling would take the grid past a wave with
    less than MIN_BLOCK_WORK a block; half of S would not reach the
    target, and (LG) a split past a wave keeps that work."""
    _, leaves_of, _ = KERNELS[kernel]
    leaves = leaves_of(n)
    for G, split, per_sm, work in _plans(kernel, n, sms):
        target = per_sm * sms
        assert split in (1, 2, 4, 8)
        assert leaves % split == 0
        assert all(len(r) == leaves // split
                   for r in _rank_leaves(leaves, split))
        wave = lk.WAVE_BLOCKS_PER_SM * sms
        small = (work is not None and G * 2 * split > wave
                 and work < 2 * split * lk.MIN_BLOCK_WORK)
        assert G * split >= target or split == leaves or small
        assert split == 1 or G * (split // 2) < target
        if work is not None and split > 1 and G * split > wave:
            assert work >= split * lk.MIN_BLOCK_WORK


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("n", [600, 1024, 9000, 8000, 100_000])
def test_leaf_layout_is_the_same_at_every_g(kernel, n):
    """The leaves of n rows are one layout for every grid and card; each S
    the entry point takes, planned or forced, gives every leaf to exactly
    one rank, in order."""
    module, leaves_of, _ = KERNELS[kernel]
    layout = _leaf_rows(leaves_of, n)
    leaves = len(layout)
    for sms in SM_COUNTS:
        for _ in _plans(kernel, n, sms):
            assert _leaf_rows(leaves_of, n) == layout
    for split in (1, 2, 4, 8):
        ranks = _rank_leaves(leaves, split)
        assert sum(ranks, []) == list(range(leaves))
        assert all(len(r) <= max(1, leaves // split) for r in ranks)


def test_measured_shapes():
    """Phase 4's whitening (G 150, 9,000 rows, dpad 3) takes 4 blocks a
    program, at 100,000 rows too, at dpad 16 8; ``hc``'s CV channel (G
    80) 8. The LG kernel holds ``hc``'s one-parent CV batch's 10 folds of a
    family in one program (56 programs, 8,000 rows) and takes 8 blocks a
    program, the holdout batch (56 programs of one fold) 4; a batch of a
    few families takes fewer folds a program, to fill the card."""
    assert wk._launch_plan(150, 9000, 3, H100_SMS) == 4
    assert wk._launch_plan(150, 90_000, 3, H100_SMS) == 4
    assert wk._launch_plan(150, 9000, 16, H100_SMS) == 8
    assert wk._launch_plan(80, 7200, 2, H100_SMS) == 8
    assert lk._launch_plan(56, 10, 3, 8000, H100_SMS) == (10, 8)
    assert lk._launch_plan(56, 1, 3, 8000, H100_SMS) == (1, 4)
    assert lk._launch_plan(1, 10, 20, 10_000, H100_SMS) == (1, 8)
    # small batches of `hc`'s update steps: fewer folds a program
    assert [lk._launch_plan(F, 10, 3, 8000, H100_SMS)[0]
            for F in (1, 2, 4, 7, 14)] == [1, 2, 3, 5, 10]


def _whiten_rows(ntr, nte=50, F=3, K=2, seed=0):
    """numpy arguments of a whitening call of exactly ntr train rows per
    fold (random rows of a 5-column frame with 5% nulls, one row in 9
    masked), families of 1 to 3 columns."""
    rng = np.random.default_rng(seed)
    n = ntr + nte + 7
    D = 5
    data = rng.normal(0, 1.4, (n, D))
    for j in range(1, D):
        data[:, j] += 0.6 * data[:, j - 1]
    null = (rng.random((n, D)) < 0.05).astype(np.float64)
    data = np.where(null > 0, 0.0, data)
    tr_idx = rng.integers(0, n, (K, ntr))
    tr_mask = (np.arange(ntr)[None] % 9 != 4).astype(np.float64).repeat(K, 0)
    te_idx = rng.integers(0, n, (K, nte))
    te_mask = np.ones((K, nte))
    col_idx = np.array([[2, 0, 0], [1, 3, 0], [0, 4, 2]][:F], np.int64)
    col_mask = np.array([[1, 0, 0], [1, 1, 0], [1, 1, 1]][:F], np.float64)
    return [data, null, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask]


@pytest.mark.parametrize("ntr", EDGES)
def test_plain_whitening_matches_jax_at_the_leaf_edges(ntr):
    """The whitening wrapper on CPU tensors (its plain version) against the
    JAX package's ``ckde_cv_whitened_parts`` in float64 on the same float32
    values, at train-row counts where the kernel's leaves change."""
    floats = (0, 1, 3, 5, 7)
    arrays = [a.astype(np.float32).astype(np.float64) if i in floats else a
              for i, a in enumerate(_whiten_rows(ntr, seed=ntr))]
    jargs = [jnp.asarray(a if i in floats else a.astype(np.int32))
             for i, a in enumerate(arrays)]
    want = jkde.ckde_cv_whitened_parts(*jargs, rule="nr")
    got = wk.ckde_cv_whiten(*(
        torch.as_tensor(a, dtype=torch.float32 if i in floats else None)
        for i, a in enumerate(arrays)))
    F, K = arrays[2].shape[0], arrays[4].shape[0]
    named = {"jtr": (got[0], want[0]), "neg": (got[1], want[1]),
             "zv_tr": (got[2], want[2]), "jte": (got[3], want[3]),
             "zv_te": (got[4], want[4]), "wte": (got[7], want[5]),
             "lndiff": (got[8], want[6]), "ok": (got[9], want[7])}
    for name, (g, w) in named.items():
        w = np.asarray(w)
        tol = dict(rtol=1e-9, atol=1e-9) if name == "lndiff" else ROUNDED
        np.testing.assert_allclose(g.numpy().reshape(w.shape), w, **tol,
                                   err_msg=name)
    assert np.isfinite(got[8].numpy()).all() and (got[9].numpy() == 1).all()
    assert got[0].shape == (F * K, ntr, 3)


@pytest.mark.parametrize("n", EDGES)
def test_plain_lg_matches_jax_at_the_leaf_edges(n):
    """The LG wrapper on CPU tensors (its plain version) against the JAX
    package's ``batched_lg_cv_loglik`` in float64 on the same float32
    frames of n rows, where the kernel's leaves change (train and test
    leaves both)."""
    rng = np.random.default_rng(n)
    values = rng.normal(0, 1.0, (n, 4))
    for j in range(1, 4):
        values[:, j] += 0.8 * values[:, j - 1]
    valid = (rng.random((n, 4)) >= 0.05).astype(np.float64)
    values = np.where(valid > 0, values, 0.0).astype(np.float32)
    folds = np.array_split(rng.permutation(n), 2)
    test = np.zeros((2, n))
    for k, te in enumerate(folds):
        test[k, te] = 1.0
    train = 1.0 - test
    fams = [(0, []), (1, [0]), (2, [1, 0]), (3, [2])]
    vi, pi, pm = family_tensors(fams, np.float32, "cpu")
    want = np.asarray(jax_lg_cv(
        *(jnp.asarray(a, jnp.float64)
          for a in (values, valid, train, test)),
        jnp.asarray(vi.numpy(), jnp.int32), jnp.asarray(pi.numpy(),
                                                        jnp.int32),
        jnp.asarray(pm.numpy(), jnp.float64)))
    v, m = torch.as_tensor(values), torch.as_tensor(valid, dtype=torch.float32)
    got = lk.lg_cv_stats(v, m, torch.as_tensor(train, dtype=torch.float32),
                         vi, pi, pm, v, m,
                         torch.as_tensor(test, dtype=torch.float32))
    assert got.scores.dtype == torch.float32
    np.testing.assert_allclose(got.scores.numpy(), want, **ROUNDED)
    assert np.isfinite(want).all()
