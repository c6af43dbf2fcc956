"""The linear-Gaussian family statistics of a batch in one launch: k-fold
Grams, the Cholesky solves, the BIC and the folds' test log-likelihood.

Replaces ``batched_lg_cv_loglik`` and ``family_grams`` of
``pybnesian_tpu/ops/gaussian.py`` (with one fold and no test rows also
``batched_bic``, and with a test frame the holdout score), which the JAX
package runs as jitted XLA (no Pallas kernel). What lives here:

- :func:`lg_cv_stats`, the wrapper: the plain version
  (:func:`~.gaussian.lg_fold_stats`) for CPU tensors, the CUDA kernel
  ``lg_cv_f32`` (``pybnesian_tpu_torch/csrc/lg_cv.cu``) for CUDA tensors,
  with a launch counter ``lg_cv_stats.launches``;
- :func:`fold_chunk`, the folds of one of the kernel's programs (a family
  and a chunk of its folds, which share every row the program reads),
  :func:`lg_leaves` (:func:`~.cuda_build.leaf_count`) and
  :func:`_launch_plan`, the fixed leaves of a program's rows and the
  cluster size S that spreads them over a thread-block cluster;
- the ctypes binding of that kernel (built at first use by
  :mod:`.cuda_build`).

The kernel sums in float64 in an order fixed by the rows and folds alone:
per (family, fold) and Gram entry a sum of its own over :func:`lg_leaves`
leaves of fixed row strides per thread, a fixed tree over the block and a
balanced tree over the leaves, whichever program and whichever of the S
blocks of its cluster sweeps a leaf; the folds added in order. So a
family's statistics and score are the same bits alone and in any batch,
at every S, whatever the batch's widest family.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .ckde_cv_kernel import _sm_count
from .cuda_build import MAX_SPLIT, check_tensors, cluster_split, leaf_count

__all__ = ["lg_cv_stats", "lg_leaves", "fold_chunk", "MAX_PARENTS"]

#: most parents of a family the kernel takes (``kMaxW`` - 2 in the source)
MAX_PARENTS = 62
# The launch plan's limits; each mirrors a constant of csrc/lg_cv.cu.
#: threads per block (kThreads)
THREADS = 256
#: most folds of one program (kMaxChunk)
MAX_CHUNK = 16
#: most (fold, Gram entry) sums of one program (kMaxPairs)
MAX_PAIRS = 360
#: blocks per SM that the plan aims for, splitting each program's leaves
#: over a cluster to get them
TARGET_BLOCKS_PER_SM = 8
#: blocks of the kernel an SM holds at once (128 registers x 256 threads)
WAVE_BLOCKS_PER_SM = 2
#: least work a block keeps, in rows x folds x Gram entries, where a split
#: would take the grid past one wave: such a split does not pay for its
#: blocks' fixed cost (on the H100, tools/whiten_lg_ab.py, PERF.md: `hc`'s
#: holdout batch, 56 programs of 8,000 rows x 1 fold x 6 entries, ran
#: fastest split 4 ways; its CV batch, 10 folds a program, 8)
MIN_BLOCK_WORK = 8192


def fold_chunk(K, W):
    """The most folds of one program of the kernel (``fold_chunk`` in
    ``csrc/lg_cv.cu``): as many of the K folds of a family of W design
    columns as keep the program's (fold, Gram entry) sums within
    :data:`MAX_PAIRS`, at most :data:`MAX_CHUNK`, at least one. The folds
    of a program share every row it reads; the chunk decides nothing of a
    sum's order."""
    return max(1, min(K, MAX_CHUNK, MAX_PAIRS // (W * (W + 1) // 2)))


def programs(F, K, chunk):
    """The kernel's programs for F families of K folds in chunks of
    ``chunk``."""
    return F * -(-K // chunk)


#: L, the leaves of one program's n train (or test) rows in the LG kernel:
#: the shared rule of csrc/common.cuh
lg_leaves = leaf_count


@functools.lru_cache(maxsize=1024)
def _launch_plan(F, K, W, n_tr, sm_count):
    """``(chunk, S)`` for F families of K folds and W design columns over
    n_tr train rows on a card of ``sm_count`` SMs: the folds of a program
    and the blocks of its thread-block cluster. The chunk is
    :func:`fold_chunk`'s, halved (rounded up) while the programs it gives,
    split to the leaves, still fit one block per SM (a small batch's blocks
    each pay a fixed cost; past one wave they queue). S is
    :func:`~.cuda_build.cluster_split`'s for :data:`TARGET_BLOCKS_PER_SM`
    blocks per SM over :func:`lg_leaves` (n_tr); it stops short where
    doubling would take the grid past one wave (:data:`WAVE_BLOCKS_PER_SM`)
    with less than :data:`MIN_BLOCK_WORK` a block. Measured on the H100
    (tools/whiten_lg_ab.py, tools/kernel_sweeps.py chunks, PERF.md).
    Neither decides the order of a sum: the result is the same at every
    plan."""
    leaves = lg_leaves(n_tr)
    chunk = fold_chunk(K, W)
    while (chunk > 1 and programs(F, K, -(-chunk // 2))
           * min(leaves, MAX_SPLIT) <= sm_count):
        chunk = -(-chunk // 2)
    G = programs(F, K, chunk)
    work = n_tr * chunk * (W * (W + 1) // 2)

    def grow(split):
        return not (G * 2 * split > WAVE_BLOCKS_PER_SM * sm_count
                    and work < 2 * split * MIN_BLOCK_WORK)

    return chunk, cluster_split(G, TARGET_BLOCKS_PER_SM * sm_count, leaves,
                                grow)


def lg_cv_stats(tr_values, tr_valid, train_mask, var_idx, parent_idx,
                parent_mask, te_values=None, te_valid=None, test_mask=None,
                *, chunk=None, split=None):
    """:class:`~.gaussian.LgStats` of F families on K folds: arguments and
    result as :func:`~.gaussian.lg_fold_stats`'s. float32 values, masks
    and parent mask, int64 indices, all contiguous and on one device; at
    most :data:`MAX_PARENTS` parents. Indices must lie in range: the
    kernel reads NaN for one that does not, the plain version raises.

    CPU tensors take :func:`~.gaussian.lg_fold_stats`. CUDA tensors launch
    the kernel, counted in ``lg_cv_stats.launches``, or raise; its plan
    is :func:`_launch_plan`'s, or ``chunk`` folds a program (1 to
    :func:`fold_chunk`) and a cluster of ``split`` blocks (1, 2, 4 or 8)
    where given, and gives the same bits either way."""
    # ops/gaussian.py imports this module for its kernel route
    from .gaussian import LgStats, lg_fold_stats

    if split is not None and split not in (1, 2, 4, 8):
        raise ValueError(f"split {split!r} is not a power of two up to "
                         f"{MAX_SPLIT}")

    if not isinstance(tr_values, torch.Tensor) or tr_values.dim() != 2:
        raise ValueError("tr_values must be an (n, D) torch.Tensor")
    if not isinstance(parent_idx, torch.Tensor) or parent_idx.dim() != 2:
        raise ValueError("parent_idx must be an (F, P) torch.Tensor")
    if (te_values is None) != (te_valid is None):
        raise ValueError("te_values and te_valid come together")
    if te_values is None and test_mask is not None:
        raise ValueError("a test mask needs test rows")
    n_tr, D = tr_values.shape
    F, P = parent_idx.shape
    K = 1 if train_mask is None else train_mask.shape[0]
    tensors = {"tr_values": tr_values, "tr_valid": tr_valid,
               "var_idx": var_idx, "parent_idx": parent_idx,
               "parent_mask": parent_mask}
    shapes = {"tr_values": (n_tr, D), "tr_valid": (n_tr, D), "var_idx": (F,),
              "parent_idx": (F, P), "parent_mask": (F, P)}
    if train_mask is not None:
        tensors["train_mask"] = train_mask
        shapes["train_mask"] = (K, n_tr)
    n_te = 0
    if te_values is not None:
        if te_values.dim() != 2:
            raise ValueError("te_values must be an (m, D) torch.Tensor")
        n_te = te_values.shape[0]
        tensors.update(te_values=te_values, te_valid=te_valid)
        shapes.update(te_values=(n_te, D), te_valid=(n_te, D))
        if test_mask is not None:
            tensors["test_mask"] = test_mask
            shapes["test_mask"] = (K, n_te)
    dtypes = {name: torch.int64 if name.endswith("idx") else torch.float32
              for name in tensors}
    check_tensors(tensors, dtypes, shapes, tr_values.device)
    if tr_values.device.type == "cpu":
        return lg_fold_stats(tr_values, tr_valid, train_mask, var_idx,
                             parent_idx, parent_mask, te_values, te_valid,
                             test_mask)
    if tr_values.device.type != "cuda":
        raise ValueError(f"no lg_cv kernel for {tr_values.device}")
    if P > MAX_PARENTS:
        raise ValueError(f"{P} parents exceed the kernel's {MAX_PARENTS}")
    device = tr_values.device
    planned = _launch_plan(F, K, P + 2, n_tr, _sm_count(device))
    chunk = planned[0] if chunk is None else chunk
    split = planned[1] if split is None else split
    if not 1 <= chunk <= fold_chunk(K, P + 2):
        raise ValueError(f"chunk {chunk} outside 1..{fold_chunk(K, P + 2)}")
    if F * K * split >= 2**31:
        raise ValueError(f"{F * K} programs of {split} blocks exceed the "
                         "grid's 2**31 - 1")

    def empty(*shape, dtype=torch.float64):
        return torch.empty(shape, dtype=dtype, device=device)

    G, W = F * K, P + 2
    gram, bic = empty(G, W, W), empty(G)
    test = te_values is not None
    fold_ll = empty(G) if test else None
    out = empty(F, dtype=torch.float32) if test else None
    if G > 0:
        # an empty tensor has no storage (data_ptr 0); the kernel reads none
        # of it, but a null pointer means "no mask" or "no test rows" there
        stub = []

        def ptr(t):
            if t is None:
                return None
            if t.numel():
                return t.data_ptr()
            if not stub:
                stub.append(torch.empty(1, device=device))
            return stub[0].data_ptr()

        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = _load_library().lg_cv_f32(
                *(ptr(t) for t in (tr_values, tr_valid, train_mask,
                                   te_values, te_valid, test_mask, var_idx,
                                   parent_idx, parent_mask, gram, bic,
                                   fold_ll, out)),
                n_tr, n_te, D, F, K, P, chunk, split, stream)
        if err != 0:
            raise RuntimeError(f"lg_cv kernel launch failed (F {F}, K {K}, "
                               f"P {P}, chunk {chunk}, split {split}): "
                               f"CUDA error {err}")
        lg_cv_stats.launches += 1
    gram = gram.reshape(F, K, W, W)
    return LgStats(gram, gram[:, :, 0, 0], bic.reshape(F, K), out)


lg_cv_stats.launches = 0


@functools.cache
def _load_library():
    lib = cuda_build.load("lg_cv.cu")
    fn = lib.lg_cv_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    lib.lg_cv_max_width.argtypes = []
    lib.lg_cv_max_width.restype = ctypes.c_int
    if lib.lg_cv_max_width() != MAX_PARENTS + 2:
        raise RuntimeError("lg_cv.cu's widest family disagrees with "
                           "MAX_PARENTS")
    return lib
