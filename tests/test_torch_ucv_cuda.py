"""The CUDA kernel behind ``ucv_pair_sums_cuda`` (the UCV pair sums) against
its plain torch version, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so it runs where only torch is
installed (``--noconftest`` skips tests/conftest.py, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_ucv_cuda.py -q

Tolerance: 1e-5 relative per sum, as chip_smoke.py holds the kernel
(float32 terms summed in another order; float64 above a thread's 1,024
terms in the kernel, a row block's in the plain version). Bit-equality where the kernel promises it: one
problem's sums alone, inside a batch, padded with invalid rows, and run
again.
"""

import math

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops import kde as tkde
from pybnesian_tpu_torch.ops.ucv_kernel import (
    ucv_pair_sums_cuda,
    ucv_pair_sums_reference,
)

pytestmark = pytest.mark.cuda
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run chip_smoke.py)")
    return torch.device("cuda")


def _white(device, B, N, d, scale=4.0, seed=0):
    """Whitened rows as a UCV search sees them: a bandwidth of ~1/scale of
    the data's spread."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(0, scale, (B, N, d)),
                           dtype=torch.float32, device=device)


def _check(white, valid=None):
    got = ucv_pair_sums_cuda(white, valid)
    want = ucv_pair_sums_reference(white, valid)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g.double(), w.double(), rtol=RTOL,
                                   atol=0, equal_nan=True)
    return got


@pytest.mark.parametrize("d", [1, 2, 3])
def test_matches_reference_at_the_search_shape(cuda, d):
    """(10, 9000, d): phase 9's searches, one per family width."""
    before = ucv_pair_sums_cuda.launches
    _check(_white(cuda, 10, 9000, d, seed=d))
    assert ucv_pair_sums_cuda.launches == before + 1


@pytest.mark.parametrize("N,d", [(4097, 3), (1001, 2), (777, 1), (300, 16),
                                 (3001, 20), (300, 40), (1, 3), (2, 3),
                                 (0, 2)])
def test_ragged_and_wide_problems(cuda, N, d):
    """N odd and no multiple of the tile, the widest templated width and
    the runtime-width kernel (d > 16), one row and none."""
    white = _white(cuda, 2, N, d, scale=4.0 / math.sqrt(d), seed=N)
    got = _check(white)
    if N < 2:
        assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("N", [100, 255, 257, 1000])
@pytest.mark.parametrize("d", [1, 3, 16, 17])
def test_tile_edges_by_width(cuda, N, d):
    """N below one 256-row tile, one row short of it, one past it and not a
    multiple of it, at d 1, 3, 16 (the widest templated width) and 17 (the
    runtime-width kernel): the diagonal tiles' pairs i < j and the
    off-diagonal tiles' unmasked loop."""
    _check(_white(cuda, 2, N, d, scale=4.0 / math.sqrt(d), seed=N + d))


@pytest.mark.parametrize("d", [1, 3, 16, 17])
def test_a_nan_row_by_width(cuda, d):
    """A NaN coordinate in the last row of a 300-row problem (its pairs all
    lie in a diagonal tile, where the other rows' warps skip its column
    group or keep it) turns the problem's sums NaN; the other stays
    finite."""
    white = _white(cuda, 2, 300, d, scale=4.0 / math.sqrt(d), seed=d)
    white[1, 299, d - 1] = math.nan
    got = _check(white)
    assert all(bool(torch.isnan(s[1])) for s in got)
    assert all(bool(torch.isfinite(s[0])) for s in got)


def test_invalid_rows(cuda):
    """An all-invalid problem gives 0, 0; exactly two invalid rows (which
    a kernel staging both at one far coordinate would pair at distance 0);
    a shorter problem padded with invalid rows."""
    white = _white(cuda, 3, 2000, 3)
    valid = torch.ones((3, 2000), device=cuda)
    valid[0] = 0.0
    valid[1, [3, 1500]] = 0.0
    valid[2, 1234:] = 0.0
    got = _check(white, valid)
    assert float(got[0][0]) == 0.0 and float(got[1][0]) == 0.0


@pytest.mark.parametrize("valid_row", [True, False])
def test_nan_propagates(cuda, valid_row):
    """A NaN coordinate turns its problem's sums NaN, valid row or not, as
    NaN * 0 does in the plain version; the other problems stay finite."""
    white = _white(cuda, 2, 700, 3)
    valid = torch.ones((2, 700), device=cuda)
    valid[1, 40] = 1.0 if valid_row else 0.0
    white[1, 40, 2] = math.nan
    got = _check(white, valid)
    assert all(bool(torch.isnan(s[1])) for s in got)
    assert all(bool(torch.isfinite(s[0])) for s in got)


@pytest.mark.parametrize("d", [3, 20])
def test_bit_equal_alone_in_a_batch_padded_and_rerun(cuda, d):
    """Problem 0's two sums: alone, inside 30 problems, padded with 1,000
    invalid rows to a longer batch, and a second run, all the same bits."""
    N = 9000 if d == 3 else 2000
    batch = _white(cuda, 30, N, d, scale=4.0 / math.sqrt(d), seed=d)
    alone = ucv_pair_sums_cuda(batch[:1].contiguous())
    inside = ucv_pair_sums_cuda(batch)
    again = ucv_pair_sums_cuda(batch)
    pad = torch.cat([batch[:1], torch.zeros((1, 1000, d), device=cuda)], 1)
    valid = torch.ones(pad.shape[:2], device=cuda)
    valid[:, N:] = 0.0
    padded = ucv_pair_sums_cuda(pad.contiguous(), valid)
    torch.cuda.synchronize()
    for i in range(2):
        assert torch.equal(alone[i], inside[i][:1])
        assert torch.equal(inside[i], again[i])
        assert torch.equal(alone[i], padded[i])


def test_routing_by_dtype(cuda):
    """ucv_pair_sums_batch: float32 on the card launches the kernel (a
    transposed view and a float64 mask are made what it takes); float64
    takes the plain version and launches nothing."""
    white = _white(cuda, 4, 500, 2)
    view = white.transpose(1, 2).contiguous().transpose(1, 2)
    valid = torch.ones((4, 500), dtype=torch.float64, device=cuda)
    valid[2, 100:] = 0.0
    before = ucv_pair_sums_cuda.launches
    got = tkde.ucv_pair_sums_batch(view, valid)
    assert ucv_pair_sums_cuda.launches == before + 1
    want = tkde.ucv_pair_sums_batch(white.double(), valid)
    assert ucv_pair_sums_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == torch.float64
        torch.testing.assert_close(g.double(), w, rtol=RTOL, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    white = _white(cuda, 2, 100, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ucv_pair_sums_cuda(white.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        ucv_pair_sums_cuda(white.double())
    with pytest.raises(ValueError, match="shape"):
        ucv_pair_sums_cuda(white, torch.ones((2, 99), device=cuda))
    with pytest.raises(ValueError, match="cpu"):
        ucv_pair_sums_cuda(white, torch.ones((2, 100)))
