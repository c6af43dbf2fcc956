"""The torch port's fitted-model KDE functions (pybnesian_tpu_torch/ops/kde.py)
and the plain version of its KDE kernel (ops/kde_kernel.py) against the JAX
package.

``kde_logl_reference`` is the plain torch version of the CUDA kernel that
replaces the Pallas ``_kde_kernel``; it runs here against
``pallas_kde_logl`` in interpret mode (as tests/factors/test_pallas_kde.py
runs it) and against the XLA function the Pallas kernel replaces,
``kde_logl_whitened``. Tolerances: float32 against the Pallas kernel, atol
1e-4 / rtol 1e-5 per row (both sum the same float32 terms in another
order); float64 rtol 1e-9 / atol 1e-7 (the port forms distances by direct
differences, JAX as ‖a‖² + ‖b‖² − 2a·b); float32 against JAX's float32,
rtol 5e-4 / atol 5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu.ops import kde as jkde
from pybnesian_tpu.ops.pallas_kde import pallas_kde_logl
from pybnesian_tpu_torch.ops import kde as tkde
from pybnesian_tpu_torch.ops.kde_kernel import (
    MAX_D,
    kde_logl,
    kde_logl_reference,
)
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


F64 = dict(rtol=1e-9, atol=1e-7)
F32 = dict(rtol=5e-4, atol=5e-3)
PALLAS = dict(rtol=1e-5, atol=1e-4)


def _rows(n, d, seed, dtype=np.float64, scale=2.0):
    return np.random.default_rng(seed).normal(0, scale, (n, d)).astype(dtype)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jax_padded(fn, test_arrays, m, chunk, make_args):
    """Run a JAX chunked function on test rows zero-padded to a multiple of
    ``chunk`` and cut its result back to ``m`` rows (the port needs no
    padding). ``make_args`` maps the padded arrays to ``fn``'s arguments."""
    pad = -(-m // chunk) * chunk - m
    padded = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
              for a in test_arrays]
    return np.asarray(fn(*make_args(padded), chunk=chunk))[..., :m]


@pytest.mark.parametrize("d", [1, 3, 8])
def test_reference_matches_pallas_interpret(d):
    N, M = 256, 128
    train = _rows(N, d, 0, np.float32)
    test = _rows(M, d, 1, np.float32)
    valid = np.ones(N, np.float32)
    valid[200:] = 0.0  # a masked tail, as padding rows
    lognorm = np.array([-1.5], np.float32)
    want = np.asarray(pallas_kde_logl(
        jnp.asarray(train), jnp.asarray(valid), jnp.asarray(test),
        jnp.asarray(lognorm), block_m=64, block_n=128, interpret=True,
    ))
    got = kde_logl_reference(_t(train)[None], _t(valid)[None],
                             _t(test)[None], _t(lognorm))[0].numpy()
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **PALLAS)


@pytest.mark.parametrize("d", [1, 3, 8])
def test_reference_matches_kde_logl_whitened(d):
    train = _rows(300, d, 2)
    test = _rows(77, d, 3)
    lognorm = -2.25
    want = _jax_padded(
        jkde.kde_logl_whitened, [test], 77, 64,
        lambda p: (jnp.asarray(train), jnp.asarray(p[0]), lognorm),
    )
    got = kde_logl_reference(_t(train)[None], torch.ones(1, 300,
                             dtype=torch.float64), _t(test)[None],
                             _t([lognorm]))[0].numpy()
    np.testing.assert_allclose(got, want, **F64)


def test_all_invalid_first_block():
    """The Pallas kernel's running max starts at −inf, so a first train
    block with no valid row gives exp(−inf − (−inf)) = NaN, which survives
    every later block: its output is NaN on every row (a fault of the
    reference, ROADMAP Queue 3). The port's plain version (and its kernel,
    whose accumulators start at −1e30) gives the logsumexp over the valid
    rows, as ``kde_logl_whitened`` does on those rows alone."""
    N, M, d = 256, 64, 3
    train = _rows(N, d, 4, np.float32)
    test = _rows(M, d, 5, np.float32)
    valid = np.ones(N, np.float32)
    valid[:128] = 0.0
    lognorm = np.array([-0.5], np.float32)
    pallas = np.asarray(pallas_kde_logl(
        jnp.asarray(train), jnp.asarray(valid), jnp.asarray(test),
        jnp.asarray(lognorm), block_m=64, block_n=128, interpret=True,
    ))
    assert np.all(np.isnan(pallas))
    got = kde_logl_reference(_t(train)[None], _t(valid)[None],
                             _t(test)[None], _t(lognorm))[0].numpy()
    assert np.all(np.isfinite(got))
    want = np.asarray(jkde.kde_logl_whitened(
        jnp.asarray(train[128:], jnp.float64),
        jnp.asarray(test, jnp.float64), -0.5, chunk=64))
    np.testing.assert_allclose(got, want, **PALLAS)


def test_reference_all_invalid_program_is_minus_inf():
    train = _t(_rows(40, 2, 6, np.float32))[None]
    test = _t(_rows(9, 2, 7, np.float32))[None]
    got = kde_logl_reference(train, torch.zeros(1, 40), test,
                             torch.tensor([-1.0]))
    assert torch.all(got == -torch.inf)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kde_logl_whitened_matches_jax(dtype):
    train = _rows(300, 3, 8, dtype)
    test = _rows(150, 3, 9, dtype)
    want = _jax_padded(
        jkde.kde_logl_whitened, [test], 150, 64,
        lambda p: (jnp.asarray(train), jnp.asarray(p[0]), -3.0),
    )
    got = tkde.kde_logl_whitened(_t(train), _t(test), -3.0)
    assert got.dtype == (torch.float64 if dtype == np.float64
                         else torch.float32)
    tol = F64 if dtype == np.float64 else F32
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kde_conditional_logsumexp_matches_jax(dtype):
    jtr = _rows(300, 3, 10, dtype)
    jte = _rows(99, 3, 11, dtype)
    mtr, mte = jtr[:, 1:] * 0.8, jte[:, 1:] * 0.8
    want = _jax_padded(
        jkde.kde_conditional_logsumexp, [jte, mte], 99, 64,
        lambda p: (jnp.asarray(jtr), jnp.asarray(p[0]), jnp.asarray(mtr),
                   jnp.asarray(p[1]), -4.0, -2.5),
    )
    got = tkde.kde_conditional_logsumexp(_t(jtr), _t(jte), _t(mtr), _t(mte),
                                         -4.0, -2.5).numpy()
    tol = F64 if dtype == np.float64 else F32
    np.testing.assert_allclose(got, want, **tol)


def _batched_inputs(dtype):
    """Three factors of widths 1, 2 and 3 in a (F, ntr, 3) block, evidence
    first and variable last; factor 0 has 170 train rows, the others 250."""
    rng = np.random.default_rng(12)
    F, ntr, nte, djmax = 3, 250, 90, 3
    widths = [1, 2, 3]
    jtr = np.zeros((F, ntr, djmax), dtype)
    jte = np.zeros((F, nte, djmax), dtype)
    trm = np.zeros((F, ntr), dtype)
    for f, dj in enumerate(widths):
        n = 170 if f == 0 else ntr
        jtr[f, :n, :dj] = rng.normal(0, 1.5, (n, dj))
        jte[f, :, :dj] = rng.normal(0, 1.5, (nte, dj))
        trm[f, :n] = 1.0
    cols = np.array(widths) - 1
    zv_tr = jtr[np.arange(F), :, cols]
    zv_te = jte[np.arange(F), :, cols]
    lndiff = rng.normal(-1.0, 0.2, F).astype(dtype)
    no_ev = (np.array(widths) == 1).astype(dtype)
    return jtr, jte, zv_tr, zv_te, trm, lndiff, no_ev


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batched_ckde_logl_matches_jax(dtype):
    jtr, jte, zv_tr, zv_te, trm, lndiff, no_ev = _batched_inputs(dtype)
    nte = jte.shape[1]
    want = _jax_padded(
        jkde.batched_ckde_logl,
        [jte.transpose(1, 0, 2), zv_te.T], nte, 64,
        lambda p: (jnp.asarray(jtr), jnp.asarray(p[0].transpose(1, 0, 2)),
                   jnp.asarray(zv_tr), jnp.asarray(p[1].T), jnp.asarray(trm),
                   jnp.asarray(lndiff)),
    )
    args = [_t(a) for a in (jtr, jte, zv_tr, zv_te, trm, lndiff)]
    got = tkde.batched_ckde_logl(*args).numpy()
    tol = F64 if dtype == np.float64 else F32
    np.testing.assert_allclose(got, want, **tol)
    # the evidence-free flags only steer the kernel; the plain form ignores
    # them, since its marginal of a width-1 factor is log n_valid already
    flagged = tkde.batched_ckde_logl(*args, no_ev=_t(no_ev)).numpy()
    np.testing.assert_array_equal(flagged, got)


def test_kde_logl_pair_matches_jax():
    train = _rows(200, 2, 13)
    test = _rows(64, 2, 14)
    want = np.asarray(jkde.kde_logl_pair(jnp.asarray(train),
                                         jnp.asarray(test), -0.7, chunk=64))
    got = tkde.kde_logl_pair(_t(train), _t(test), -0.7).numpy()
    assert got.shape == (64, 200)
    np.testing.assert_allclose(got, want, **F64)


def _kernel_args(d=2, G=2, ntr=64, nte=9):
    rng = np.random.default_rng(15)
    arrays = [rng.normal(size=(G, ntr, d)), np.ones((G, ntr)),
              rng.normal(size=(G, nte, d)), np.full(G, -1.0)]
    return [torch.as_tensor(a, dtype=torch.float32) for a in arrays]


def test_wrapper_on_cpu_is_the_reference_and_uncounted():
    args = _kernel_args(d=20, ntr=100, nte=33)
    args[1][1, :40] = 0.0
    before = kde_logl.launches
    got = kde_logl(*args)
    assert kde_logl.launches == before
    torch.testing.assert_close(got, kde_logl_reference(*args), rtol=0, atol=0)


@pytest.mark.parametrize("break_it, error", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError),
    (lambda a: a.__setitem__(1, a[1][:, :-1]), ValueError),
    (lambda a: a.__setitem__(2, a[2][..., :1].contiguous()), ValueError),
    (lambda a: a.__setitem__(3, a[3][:1]), ValueError),
    (lambda a: a.__setitem__(2, a[2].transpose(0, 1)), ValueError),
    (lambda a: a.__setitem__(0, list(a[0])), TypeError),
], ids=["float64", "valid-shape", "test-width", "lognorm-shape",
        "noncontiguous", "not-a-tensor"])
def test_wrapper_rejects_bad_arguments(break_it, error):
    args = _kernel_args()
    break_it(args)
    with pytest.raises(error):
        kde_logl(*args)


def test_wrapper_rejects_too_wide():
    with pytest.raises(ValueError, match="outside"):
        kde_logl(*_kernel_args(d=MAX_D + 1, ntr=4, nte=2))
