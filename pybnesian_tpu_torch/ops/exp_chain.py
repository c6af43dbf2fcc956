"""Exp-throughput probe: the card's float32 exp ceiling.

Replaces the Pallas TPU kernel ``kern`` of ``pallas_exp_chain_rate``
(``benchmarks/micro_exp_roofline.py``). Per element of ``x``, 64 dependent
steps of

    acc = 0.5·acc + exp(x − 1e-3·acc − 1)

starting from ``acc = 0``, done ``repeats`` times over (the TPU kernel's
grid of 64 identical steps). The kernels of this package spend their time
in accurate float32 exps, and this probe gives the rate they are held
against: ``n · CHAIN · repeats`` exps over its time.

- :func:`exp_chain_reference`, the plain torch version;
- :func:`exp_chain`, the wrapper: plain version for CPU tensors, the CUDA
  kernel (``pybnesian_tpu_torch/csrc/exp_chain.cu``) for CUDA tensors, with
  a launch counter ``exp_chain.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

__all__ = ["exp_chain", "exp_chain_reference", "CHAIN", "REPEATS", "SHAPE"]

#: dependent exps per element and repetition
CHAIN = 64
#: identical repetitions, as the TPU kernel's grid (64,)
REPEATS = 64
#: the TPU kernel's resident tile
SHAPE = (512, 1024)
_MAX_REPEATS = 65535


def exp_chain_reference(x, repeats: int = REPEATS):
    """Plain torch version of the kernel, same arguments and result as
    :func:`exp_chain`, on any device: ``repeats`` times the same loop."""
    for _ in range(repeats):
        acc = torch.zeros_like(x)
        for _ in range(CHAIN):
            acc = acc * 0.5 + torch.exp(x - acc * 1e-3 - 1.0)
    return acc


def exp_chain(x, repeats: int = REPEATS):
    """The chain of :data:`CHAIN` dependent exps per element of ``x`` (a
    contiguous float32 tensor of any shape), computed ``repeats`` times
    over; returns a tensor of ``x``'s shape.

    CPU tensors take :func:`exp_chain_reference`. CUDA tensors launch the
    kernel, counted in ``exp_chain.launches``, or raise."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError("x must be a float32 torch.Tensor")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 1 <= repeats <= _MAX_REPEATS:
        raise ValueError(f"repeats {repeats} outside 1..{_MAX_REPEATS}")
    if x.device.type == "cpu":
        return exp_chain_reference(x, repeats)
    if x.device.type != "cuda":
        raise ValueError(f"no exp_chain kernel for {x.device}")
    if x.numel() >= 2**31:
        raise ValueError("x must have fewer than 2**31 elements")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.exp_chain_f32(x.data_ptr(), out.data_ptr(), x.numel(),
                                repeats, stream)
    if err != 0:
        raise RuntimeError(f"exp_chain kernel launch failed: CUDA error {err}")
    exp_chain.launches += 1
    return out


exp_chain.launches = 0


@functools.cache
def _load_library():
    lib = cuda_build.load("exp_chain.cu")
    fn = lib.exp_chain_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib
