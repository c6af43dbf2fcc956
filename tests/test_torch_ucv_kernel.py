"""The UCV pair-sums module of the torch port (``ops/ucv_kernel.py``) on the
CPU: its plain version against the JAX package's ``ucv_pair_sums``, the
routing of ``ucv_pair_sums_batch``, the wrapper's argument checks, and the
CUDA entry point's C signature against the ctypes binding.

Float64 parity at rtol 1e-9: both sum the same terms, in another order.
The JAX function wants rows padded to a multiple of its chunk; the padding
rows are invalid (as ``tests/test_torch_ucv.py`` pads them).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu.ops.kde import ucv_pair_sums as jax_pair_sums
from pybnesian_tpu_torch.ops import kde as tkde
from pybnesian_tpu_torch.ops import ucv_kernel
from pybnesian_tpu_torch.ops.ucv_kernel import (
    ucv_pair_sums_cuda,
    ucv_pair_sums_reference,
)
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

SOURCE = (Path(ucv_kernel.__file__).resolve().parent.parent / "csrc"
          / "ucv_pairs.cu")
CHUNK = 64


def _jax(W, valid):
    """The JAX pair sums of one problem, its rows padded with invalid ones
    to a multiple of the chunk."""
    n, d = W.shape
    npad = max(CHUNK, -(-n // CHUNK) * CHUNK)
    Wp = np.zeros((npad, d))
    Wp[:n] = W
    vp = np.zeros(npad)
    vp[:n] = valid
    s2h, sh = jax_pair_sums(jnp.asarray(Wp), jnp.asarray(vp), chunk=CHUNK)
    return float(s2h), float(sh)


def _problems(seed, B, N, d):
    rng = np.random.default_rng(seed)
    W = rng.normal(0, 1.5, (B, N, d))
    valid = (rng.random((B, N)) > 0.15).astype(np.float64)
    return W, valid


@pytest.mark.parametrize("B,N,d,block", [(3, 131, 1, 1 << 25),
                                         (4, 200, 2, 3000),
                                         (2, 257, 3, 1 << 25),
                                         (3, 97, 5, 500)])
def test_reference_matches_jax_on_ragged_batches(B, N, d, block,
                                                 monkeypatch):
    """Problems of different lengths in one batch (a shorter problem is
    padded with invalid rows), N no multiple of the JAX chunk, and row
    blocks of the plain version that no N divides."""
    monkeypatch.setattr(ucv_kernel, "_UCV_BLOCK", block)
    W, valid = _problems(N, B, N, d)
    valid[-1, N // 2:] = 0.0                 # a shorter problem
    s2h, sh = ucv_pair_sums_reference(torch.as_tensor(W),
                                      torch.as_tensor(valid))
    for b in range(B):
        np.testing.assert_allclose([float(s2h[b]), float(sh[b])],
                                   _jax(W[b], valid[b]), rtol=1e-9)


@pytest.mark.parametrize("invalid", [[0, 1], [5, 77], [0, 3, 40, 99]],
                         ids=["first-two", "two", "four"])
def test_reference_matches_jax_with_invalid_rows(invalid):
    """Exactly two (or more) invalid rows: no pair of them may count, as
    none does in the JAX mask."""
    W, _ = _problems(7, 1, 100, 3)
    valid = np.ones((1, 100))
    valid[0, invalid] = 0.0
    s2h, sh = ucv_pair_sums_reference(torch.as_tensor(W),
                                      torch.as_tensor(valid))
    np.testing.assert_allclose([float(s2h[0]), float(sh[0])],
                               _jax(W[0], valid[0]), rtol=1e-9)


def test_all_invalid_problem_gives_zero():
    W, valid = _problems(3, 2, 90, 2)
    valid[0] = 0.0
    s2h, sh = ucv_pair_sums_reference(torch.as_tensor(W),
                                      torch.as_tensor(valid))
    assert float(s2h[0]) == 0.0 and float(sh[0]) == 0.0
    assert _jax(W[0], valid[0]) == (0.0, 0.0)
    np.testing.assert_allclose([float(s2h[1]), float(sh[1])],
                               _jax(W[1], valid[1]), rtol=1e-9)


@pytest.mark.parametrize("valid_row", [True, False])
def test_nan_rows(valid_row):
    """A NaN in a valid row turns its problem NaN in both packages. In an
    invalid row the JAX mask (a select) drops it, while the plain version's
    mask (a product) keeps it, as the CUDA kernel does: NaN there too."""
    W, valid = _problems(11, 2, 120, 2)
    valid[1, 30] = 1.0 if valid_row else 0.0
    W[1, 30, 1] = math.nan
    s2h, sh = ucv_pair_sums_reference(torch.as_tensor(W),
                                      torch.as_tensor(valid))
    assert math.isnan(float(s2h[1])) and math.isnan(float(sh[1]))
    assert all(math.isnan(x) for x in _jax(W[1], valid[1])) == valid_row
    np.testing.assert_allclose([float(s2h[0]), float(sh[0])],
                               _jax(W[0], valid[0]), rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("masked", [False, True])
def test_cpu_tensors_take_the_plain_version(dtype, masked):
    """On the CPU, ucv_pair_sums_batch (either dtype) and the wrapper
    (float32) return the plain version's sums and launch nothing."""
    W, valid = _problems(5, 3, 150, 2)
    white = torch.as_tensor(W, dtype=dtype)
    mask = torch.as_tensor(valid, dtype=dtype) if masked else None
    before = ucv_pair_sums_cuda.launches
    got = tkde.ucv_pair_sums_batch(white, mask)
    want = ucv_pair_sums_reference(white, mask)
    if dtype == torch.float32:
        got_wrapper = ucv_pair_sums_cuda(white, mask)
        for g, w in zip(got_wrapper, want):
            assert torch.equal(g, w)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    assert ucv_pair_sums_cuda.launches == before


def test_one_problem_form_is_a_batch_of_one():
    W, valid = _problems(6, 1, 80, 3)
    s2h, sh = tkde.ucv_pair_sums(torch.as_tensor(W[0]),
                                 torch.as_tensor(valid[0]))
    want = ucv_pair_sums_reference(torch.as_tensor(W), torch.as_tensor(valid))
    assert float(s2h) == float(want[0][0]) and float(sh) == float(want[1][0])


@pytest.mark.parametrize("case", ["rank", "valid-shape", "white-dtype",
                                  "valid-dtype", "white-contiguity",
                                  "valid-contiguity"])
def test_wrapper_argument_checks(case):
    white = torch.zeros((2, 10, 3))
    valid = torch.ones((2, 10))
    if case == "rank":
        white = white[0]
    elif case == "valid-shape":
        valid = valid[:, :9]
    elif case == "white-dtype":
        white = white.double()
    elif case == "valid-dtype":
        valid = valid.double()
    elif case == "white-contiguity":
        white = torch.zeros((2, 3, 10)).transpose(1, 2)
    else:
        valid = torch.ones((10, 2)).T
    with pytest.raises(ValueError):
        ucv_pair_sums_cuda(white, valid)


def test_entry_point_matches_the_binding():
    """The C signature: white, valid, partials, out (pointers), B, N, d,
    pairs (ints), stream; the order in which ``_launch`` passes them."""
    text = SOURCE.read_text()
    params = re.search(r"int ucv_pair_sums_f32\(([^)]*)\)", text).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names == ["white", "valid", "partials", "out", "B", "N", "d",
                     "pairs", "stream"]
    assert re.search(r'extern "C" int ucv_pair_sums_tile\(int d\)', text)
    constants = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(constants["kTile"]) == (int(constants["kThreads"])
                                       * int(constants["kRowsPerThread"]))
    # the sums are deterministic by design: no atomic add in the pair sums'
    # code (the search after it counts with atomics, never on a sum:
    # tests/test_torch_ucv_search.py holds its list)
    pair_sums = text[text.index("namespace {"):
                     text.index("// ------------------------------------"
                                "--------------------------- search")]
    assert "atomicAdd" not in pair_sums
