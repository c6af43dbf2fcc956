"""The launch plan of the KDE kernels of ``csrc/ckde_cv.cu`` (``_launch_plan``
in ``pybnesian_tpu_torch/ops/ckde_cv_kernel.py``), on the CPU.

The plan is pure Python: (R, T, S) = test rows per thread, train rows per
group, and blocks of a thread-block cluster that split each program's
train rows. These tests hold it to what the CUDA entry points accept (the
limits are read from the source and from the kernels' shared header,
``csrc/common.cuh``) and to the split the kernel makes: a program's train
rows fall into P = ``reduction_leaves(ntr, d)`` leaves of ceil(ntr / P)
rows, whose logsumexp pairs merge in a fixed tree, and cluster rank q of S
sweeps leaves [q P / S, (q + 1) P / S). The leaves, and so the float32
result of a (program, test row), do not depend on G.
"""

import re
from pathlib import Path

import pytest

from pybnesian_tpu_torch.ops import ckde_cv_kernel as ck
from pybnesian_tpu_torch.ops import cuda_build, kde_kernel
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


SOURCE = (Path(ck.__file__).resolve().parent.parent / "csrc" / "ckde_cv.cu")
HEADER = SOURCE.parent / "common.cuh"
H100_SMS = 132
CV_SHAPE = (150, 9000, 1000, 3)        # bench.py's CV path, main-path inputs
CONFIG3B_SHAPE = (4, 10_000, 10_000, 2)  # config3b's model.slogl
KDE_G1_SHAPE = (1, 10_240, 10_240, 3)    # the Pallas KDE kernel's shape
SHAPES = [
    CV_SHAPE, CONFIG3B_SHAPE, KDE_G1_SHAPE,
    (150, 90_000, 10_000, 3),  # the CV path at 100k rows
    (2, 10_000, 10_000, 2),    # CKDE.logl: joint and marginal
    (4, 600, 77, 8),
    (1, 600, 77, 16),
    (1, 255, 1, 1),
    (1, 7, 3, 4),
    (1, 0, 5, 2),
    (2, 300, 130, 17),         # the runtime-width KDE variant
    (1, 300, 130, 256),
    (40, 5000, 3000, 12),
]
SM_COUNTS = [1, 16, 78, 114, H100_SMS]


def _constants():
    """The integer constants of the source and of the header it includes;
    neither defines one the other does."""
    source, header = (
        {name: int(value) for name, value in
         re.findall(r"constexpr int (k\w+) = (\d+);", path.read_text())}
        for path in (SOURCE, HEADER))
    assert not set(source) & set(header)
    return {**source, **header}


def _accepted(d, rows, group, split):
    """What ``ckde_cv_pairs_f32`` and ``kde_logl_f32`` accept (plan_ok and
    the runtime-width check)."""
    c = _constants()
    if d > c["kMaxTemplated"]:
        return (rows, group, split) == (1, c["kWideGroup"], 1)
    return ((rows, group) == (c["kRowsPerThread"], c["kGroup"])
            and 1 <= split <= c["kMaxSplit"])


def _leaf_rows(ntr, d):
    """[lo, hi) train rows of each leaf, as the kernel splits them."""
    leaves = ck.reduction_leaves(ntr, d)
    size = -(-ntr // leaves)
    return [(min(ntr, q * size), min(ntr, (q + 1) * size))
            for q in range(leaves)]


def _rank_leaves(ntr, d, split):
    """The leaves each cluster rank sweeps (first_leaf in the source)."""
    leaves = ck.reduction_leaves(ntr, d)
    return [list(range(q * leaves // split, (q + 1) * leaves // split))
            for q in range(split)]


def _shares(ntr, split, d=3):
    """Train rows of each cluster rank, as the kernel splits them."""
    rows = _leaf_rows(ntr, d)
    return [sum(rows[leaf][1] - rows[leaf][0] for leaf in ranks)
            for ranks in _rank_leaves(ntr, d, split)]


def test_python_limits_mirror_the_source():
    c = _constants()
    assert ck.THREADS == c["kThreads"]
    assert ck.ROWS_PER_THREAD == c["kRowsPerThread"]
    assert ck.GROUP == c["kGroup"]
    assert ck.WIDE_GROUP == c["kWideGroup"]
    assert ck.MAX_SPLIT == c["kMaxSplit"]
    assert ck.TILE == c["kTile"]
    assert ck.MAX_DPAD == c["kMaxTemplated"]
    assert kde_kernel.MAX_D == c["kMaxWide"]
    assert c["kMaxSplit"] <= 8  # portable cluster size, no opt-in needed


@pytest.mark.parametrize("entry", ["ckde_cv_pairs_f32", "kde_logl_f32"])
def test_entry_points_take_the_plan_last(entry):
    """The C signature ends (..., R, T, S, stream), the order in which the
    wrappers pass ``*plan, stream``."""
    text = SOURCE.read_text()
    params = re.search(entry + r"\(([^)]*)\)", text).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[-4:] == ["rows_per_thread", "group", "split", "stream"]
    ints = [p for p in params.split(",") if p.split()[0] == "int"]
    pointers = len(names) - len(ints)
    assert (pointers, len(ints)) == {"ckde_cv_pairs_f32": (9, 7),
                                     "kde_logl_f32": (6, 7)}[entry]


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_is_accepted_and_no_split_is_empty(shape, sms):
    G, ntr, nte, d = shape
    rows, group, split = ck._launch_plan(G, ntr, nte, d, sms)
    assert _accepted(d, rows, group, split)
    assert 1 <= split <= ck.MAX_SPLIT
    shares = _shares(ntr, split, d)
    assert sum(shares) == ntr
    if split > 1:
        assert min(shares) >= ck.TILE  # every split sweeps a full tile
    # pure: the same shape and card give the same plan
    assert ck._launch_plan(G, ntr, nte, d, sms) == (rows, group, split)


@pytest.mark.parametrize("shape", [CV_SHAPE, CONFIG3B_SHAPE, KDE_G1_SHAPE],
                         ids=["cv", "config3b", "kde-G1"])
def test_measured_shapes_split_to_the_cluster_limit(shape):
    """600, 160 and 40 blocks of 256 test rows, all under 64 per SM: each
    splits 8 ways, which measured fastest on the H100 at all three shapes
    (PERF.md)."""
    assert ck._launch_plan(*shape, H100_SMS) == (2, 16, ck.MAX_SPLIT)


def test_cv_path_at_100k_rows_splits_two_ways():
    """6,000 blocks, ~45 per SM: split 2 ways, which measured fastest on
    the H100 there (split 8 ways was slower than no split; PERF.md)."""
    assert ck._launch_plan(150, 90_000, 10_000, 3, H100_SMS) == (2, 16, 2)


@pytest.mark.parametrize("sms", SM_COUNTS)
def test_full_grid_takes_no_split(sms):
    # the CV path at 100k rows: 150 programs x 40 tiles of 256 test rows,
    # split only while the grid is under the target
    G, nte = 150, 10_000
    tiles = G * -(-nte // (ck.THREADS * ck.ROWS_PER_THREAD))
    split = ck._launch_plan(G, 90_000, nte, 3, sms)[2]
    assert (split == 1) == (tiles >= ck.TARGET_BLOCKS_PER_SM * sms)


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[3] <= ck.MAX_DPAD],
                         ids=lambda s: "x".join(map(str, s)))
def test_split_reaches_the_target_or_a_limit(shape, sms):
    G, ntr, nte, d = shape
    split = ck._launch_plan(G, ntr, nte, d, sms)[2]
    tiles = G * -(-nte // (ck.THREADS * ck.ROWS_PER_THREAD))
    target = ck.TARGET_BLOCKS_PER_SM * sms
    leaves = ck.reduction_leaves(ntr, d)
    # a power of two up to the leaves, so every rank sweeps as many leaves
    assert split & (split - 1) == 0 and leaves % split == 0
    assert tiles * split >= target or split == leaves
    # half the split would not reach the target
    assert split == 1 or tiles * (split // 2) < target


def test_split_needs_a_tile_of_train_rows():
    # a tiny program cannot be split, however empty the card
    assert ck._launch_plan(1, ck.TILE - 1, 10, 3, H100_SMS)[2] == 1
    assert ck._launch_plan(1, 2 * ck.TILE, 10, 3, H100_SMS)[2] == 2


def test_wide_kde_takes_one_row_per_thread():
    assert ck._launch_plan(1, 10_000, 10_000, 17, H100_SMS) == (1, 32, 1)


@pytest.mark.parametrize("ntr,d", [(9000, 3), (10_240, 3), (10_000, 2),
                                   (90_000, 3), (600, 8), (2047, 16),
                                   (255, 1), (5000, 12), (300, 17)],
                         ids=lambda v: str(v))
def test_reduction_layout_is_the_same_at_every_g(ntr, d):
    """The leaves of a (ntr, d) and their merge tree are one layout for
    every G and card; the plan's split only spreads those leaves over the
    ranks of a cluster, each leaf to exactly one rank, in order."""
    layout = _leaf_rows(ntr, d)
    assert layout[0][0] == 0 and layout[-1][1] == ntr
    assert all(a[1] == b[0] for a, b in zip(layout, layout[1:]))
    leaves = len(layout)
    assert leaves & (leaves - 1) == 0 and leaves <= ck.MAX_SPLIT
    for G in (1, 2, 10, 150, 1000, 65535):
        for sms in SM_COUNTS:
            split = ck._launch_plan(G, ntr, 1000, d, sms)[2]
            assert ck.reduction_leaves(ntr, d) == leaves
            ranks = _rank_leaves(ntr, d, split)
            assert sum(ranks, []) == list(range(leaves))
    # every split the entry point takes, forced ones too, covers the leaves
    for split in range(1, ck.MAX_SPLIT + 1):
        assert sum(_rank_leaves(ntr, d, split), []) == list(range(leaves))


def test_reduction_leaves_mirror_the_source():
    """The header's leaf_count doubles the leaves while two more still hold
    kLeafRows rows each and stay within kMaxLeaves, as the Python mirror
    does; the source takes its leaves and its ranks' shares from the
    header, and the templated widths' leaves are the shared rule's."""
    body = re.search(r"int leaf_count\(int n\) \{(.*?)\n\}",
                     HEADER.read_text(), re.S).group(1)
    assert ("while (2 * leaves <= kMaxLeaves && 2 * leaves * kLeafRows <= n)"
            in body)
    text = SOURCE.read_text()
    assert '#include "common.cuh"' in text
    assert text.count("leaf_count(a.ntr)") == 2  # the kernel and its launch
    assert "first_leaf(rank, leaves, split)" in text
    assert "leaf_owner(l, leaves, split)" in text
    for ntr in (0, 1, 255, 511, 512, 1023, 1024, 2047, 2048, 10**6):
        want = 1
        while 2 * want <= 8 and 2 * want * 256 <= ntr:
            want *= 2
        assert ck.reduction_leaves(ntr, 3) == want
        assert cuda_build.leaf_count(ntr) == want
    assert ck.reduction_leaves(10**6, ck.MAX_DPAD + 1) == 1
