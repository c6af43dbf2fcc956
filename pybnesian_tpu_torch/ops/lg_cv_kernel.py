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
- the ctypes binding of that kernel (built at first use by
  :mod:`.cuda_build`).

The kernel sums in float64 in an order fixed by the rows and folds alone:
one block per (family, fold), fixed row strides per thread, a fixed tree
over the block, every Gram entry a sum of its own, the folds added in
order. So a family's statistics and score are the same bits alone and in
any batch, whatever the batch's widest family.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

__all__ = ["lg_cv_stats", "MAX_PARENTS"]

#: most parents of a family the kernel takes (``kMaxW`` - 2 in the source)
MAX_PARENTS = 62


def _check(tensors, shapes, device):
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        want = torch.int64 if name.endswith("idx") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")


def lg_cv_stats(tr_values, tr_valid, train_mask, var_idx, parent_idx,
                parent_mask, te_values=None, te_valid=None, test_mask=None):
    """:class:`~.gaussian.LgStats` of F families on K folds: arguments and
    result as :func:`~.gaussian.lg_fold_stats`'s. float32 values, masks
    and parent mask, int64 indices, all contiguous and on one device; at
    most :data:`MAX_PARENTS` parents. Indices must lie in range: the
    kernel reads NaN for one that does not, the plain version raises.

    CPU tensors take :func:`~.gaussian.lg_fold_stats`. CUDA tensors launch
    the kernel, counted in ``lg_cv_stats.launches``, or raise."""
    # ops/gaussian.py imports this module for its kernel route
    from .gaussian import LgStats, lg_fold_stats

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
    _check(tensors, shapes, tr_values.device)
    if tr_values.device.type == "cpu":
        return lg_fold_stats(tr_values, tr_valid, train_mask, var_idx,
                             parent_idx, parent_mask, te_values, te_valid,
                             test_mask)
    if tr_values.device.type != "cuda":
        raise ValueError(f"no lg_cv kernel for {tr_values.device}")
    if P > MAX_PARENTS:
        raise ValueError(f"{P} parents exceed the kernel's {MAX_PARENTS}")
    if F * K >= 2**31:
        raise ValueError(f"{F * K} programs exceed the grid's 2**31 - 1")
    device = tr_values.device

    def empty(*shape, dtype=torch.float64):
        return torch.empty(shape, dtype=dtype, device=device)

    G, W = F * K, P + 2
    gram, bic = empty(G, W, W), empty(G)
    test = te_values is not None
    fold_ll = empty(G) if test else None
    out = empty(F, dtype=torch.float32) if test else None
    if G > 0:
        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = _load_library().lg_cv_f32(
                *(ptr(t) for t in (tr_values, tr_valid, train_mask,
                                   te_values, te_valid, test_mask, var_idx,
                                   parent_idx, parent_mask, gram, bic,
                                   fold_ll, out)),
                n_tr, n_te, D, F, K, P, stream)
        if err != 0:
            raise RuntimeError(f"lg_cv kernel launch failed (F {F}, K {K}, "
                               f"P {P}): CUDA error {err}")
        lg_cv_stats.launches += 1
    gram = gram.reshape(F, K, W, W)
    return LgStats(gram, gram[:, :, 0, 0], bic.reshape(F, K), out)


lg_cv_stats.launches = 0


@functools.cache
def _load_library():
    lib = cuda_build.load("lg_cv.cu")
    fn = lib.lg_cv_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    lib.lg_cv_max_width.argtypes = []
    lib.lg_cv_max_width.restype = ctypes.c_int
    if lib.lg_cv_max_width() != MAX_PARENTS + 2:
        raise RuntimeError("lg_cv.cu's widest family disagrees with "
                           "MAX_PARENTS")
    return lib
