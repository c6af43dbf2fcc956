"""The pair sums of the UCV bandwidth objective, B problems in one launch.

Replaces ``ucv_pair_sums`` of ``pybnesian_tpu/ops/kde.py``, which the JAX
package runs as one jitted XLA program (no Pallas kernel). For each problem
b of whitened rows ``white[b]`` (N, d) and its validity mask it computes

    s2h[b] = Σ_{i<j, both valid} exp(−¼‖wᵢ−wⱼ‖²)
    sh[b]  = Σ_{i<j, both valid} exp(−½‖wᵢ−wⱼ‖²)

- :func:`ucv_pair_sums_reference`, the plain torch version;
- :func:`ucv_pair_sums_cuda`, the wrapper: plain version for CPU tensors,
  the CUDA kernel (``ucv_pair_sums_f32`` in
  ``pybnesian_tpu_torch/csrc/ucv_pairs.cu``) for CUDA tensors, with a
  launch counter ``ucv_pair_sums_cuda.launches``;
- the ctypes binding of that kernel (built at first use by
  :mod:`.cuda_build`).

The kernel's sums of one problem are bit-equal alone, inside any batch
(padded with invalid rows to the batch's N) and from run to run: it sums
fixed tiles in a fixed order, with no atomic in any sum.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

__all__ = ["ucv_pair_sums_cuda", "ucv_pair_sums_reference"]

_MAX_PROBLEMS = 65535
# elements of one (problems, row block, column span) pair block of the UCV
# sums: 2**25 keeps each of its three live temporaries at 128 MiB in
# float32, and a 9,000-row problem in a few dozen blocks
_UCV_BLOCK = 1 << 25


def ucv_pair_sums_reference(white, valid=None):
    """The UCV pair sums of B problems at once: ``white`` (B, N, d) whitened
    training rows, ``valid`` (B, N) 1.0 on the rows that count (a problem
    with fewer rows than N is padded with invalid ones), or None when every
    row counts. Returns ``(s2h, sh)``, each (B,) in ``white``'s dtype:

        s2h = Σ_{i<j} exp(−¼‖wᵢ−wⱼ‖²),   sh = Σ_{i<j} exp(−½‖wᵢ−wⱼ‖²)

    over the valid pairs of each problem — the leave-one-out terms of the
    UCV objective for bandwidths 2H and H (reference kde/UCV.cpp,
    KDE.cl.src:471-565) from ONE exp per pair: the second term is the square
    of the first.

    Plain torch on every device (the JAX package has no hand-written kernel
    here either). Only the upper triangle is walked: a block of rows
    [a, a+blk) meets the columns [a, N), so the i ≥ j half of each diagonal
    block is the only waste; N need not be a multiple of the block, the
    last block is just shorter. ``blk`` is chosen so that one (B, blk, N)
    temporary stays at ``_UCV_BLOCK`` elements. The i < j mask touches
    only the block's first ``blk`` columns, the validity mask only runs
    when ``valid`` is given: every pass over a pair block costs as much as
    its exp.

    Distances are DIRECT differences, Σ_k (w_ik − w_jk)², one pass per
    column, not the ‖a‖² − 2a·b + ‖b‖² matmul form of the dense KDE paths:
    the sums are dominated by the closest pairs, which is where that form
    cancels worst in float32 (its error is ε·‖w‖², the distance itself may be
    smaller), and the UCV objective is a small difference of the two sums.
    d is a handful of columns, so the matmul would save little. A block's
    rows are summed in the data's dtype (a tree sum over at most N terms);
    the row sums, and the blocks, in float64 (asking the big reduction for
    float64 made torch copy the whole block to float64 first: a fifth of
    the call on an H100)."""
    B, N, d = white.shape
    dtype, device = white.dtype, white.device
    s2h = torch.zeros(B, dtype=torch.float64, device=device)
    sh = torch.zeros(B, dtype=torch.float64, device=device)
    blk = max(1, min(N, _UCV_BLOCK // max(B * N, 1)))
    upper = torch.triu(torch.ones((blk, blk), dtype=dtype, device=device),
                       diagonal=1)
    wt = white.transpose(1, 2).contiguous()                    # (B, d, N)
    if valid is not None:
        valid = (valid > 0).to(dtype)
    for a in range(0, N, blk):
        b = min(a + blk, N)
        e = wt[:, 0, a:b, None] - wt[:, 0, None, a:]
        e.square_()
        for k in range(1, d):
            diff = wt[:, k, a:b, None] - wt[:, k, None, a:]
            e.addcmul_(diff, diff)
        torch.exp_(e.mul_(-0.25))
        e[:, :, : b - a].mul_(upper[: b - a, : b - a])
        if valid is not None:
            e.mul_(valid[:, a:b, None]).mul_(valid[:, None, a:])
        s2h += torch.sum(e, dim=2).sum(dim=1, dtype=torch.float64)
        sh += torch.sum(e.square_(), dim=2).sum(dim=1, dtype=torch.float64)
    return s2h.to(dtype), sh.to(dtype)


def _check_args(white, valid):
    if not isinstance(white, torch.Tensor):
        raise TypeError("white must be a torch.Tensor")
    if white.dim() != 3:
        raise ValueError(f"white must be (B, N, d), got {tuple(white.shape)}")
    B, N, d = white.shape
    tensors = {"white": white}
    if valid is not None:
        if not isinstance(valid, torch.Tensor):
            raise TypeError("valid must be a torch.Tensor or None")
        if tuple(valid.shape) != (B, N):
            raise ValueError(f"valid has shape {tuple(valid.shape)}, "
                             f"expected {(B, N)}")
        tensors["valid"] = valid
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != white.device:
            raise ValueError(f"{name} is on {t.device}, white on "
                             f"{white.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d < 1:
        raise ValueError("white needs at least one column")
    return B, N, d


def ucv_pair_sums_cuda(white, valid=None):
    """``(s2h, sh)``, each (B,) float32: the UCV pair sums of B problems.

    white: (B, N, d) whitened rows; valid: (B, N), > 0 for a row that
    counts, or None when every row counts. Both float32 and contiguous;
    B, N and d are free (d ≤ 16 takes the templated kernel, wider problems
    a runtime-width one).

    CPU tensors take :func:`ucv_pair_sums_reference`. CUDA tensors launch
    the kernel, counted in ``ucv_pair_sums_cuda.launches``, or raise."""
    B, N, d = _check_args(white, valid)
    if white.device.type == "cpu":
        return ucv_pair_sums_reference(white, valid)
    if white.device.type != "cuda":
        raise ValueError(f"no ucv_pair_sums kernel for {white.device}")
    if B > _MAX_PROBLEMS:
        raise ValueError(f"{B} problems exceed the grid's {_MAX_PROBLEMS}")
    if N >= 2**31:
        raise ValueError("N must fit 32-bit row indices")
    if B == 0:
        empty = torch.empty(0, dtype=torch.float32, device=white.device)
        return empty, empty.clone()
    out = _launch(white, valid)
    ucv_pair_sums_cuda.launches += 1
    return out[:, 0], out[:, 1]


ucv_pair_sums_cuda.launches = 0


def _tile_pairs(N, d):
    """Tile pairs (ti <= tj) of the kernel's partials for N rows of width
    d."""
    nt = -(-N // _load_library().ucv_pair_sums_tile(d))
    return nt * (nt + 1) // 2


def _launch(white, valid):
    """One launch of the kernel and its reduction on checked CUDA arguments
    with B >= 1; returns ``out`` (B, 2). Counts nothing: the wrapper counts
    its own launches."""
    B, N, d = white.shape
    pairs = _tile_pairs(N, d)
    if pairs >= 2**31:
        raise ValueError(f"{pairs} tile pairs exceed the grid's 2**31 - 1")
    device = white.device
    partials = torch.empty((B, pairs, 2), dtype=torch.float64, device=device)
    out = torch.empty((B, 2), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _load_library().ucv_pair_sums_f32(
            white.data_ptr(), None if valid is None else valid.data_ptr(),
            partials.data_ptr(), out.data_ptr(), B, N, d, pairs, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ucv_pair_sums kernel launch failed (B {B}, N {N}, d {d}): "
            f"CUDA error {err}"
        )
    return out


@functools.cache
def _load_library():
    lib = cuda_build.load("ucv_pairs.cu")
    fn = lib.ucv_pair_sums_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    lib.ucv_pair_sums_tile.argtypes = [ctypes.c_int]
    lib.ucv_pair_sums_tile.restype = ctypes.c_int
    return lib
