"""The torch port's exp-throughput probe (pybnesian_tpu_torch/ops/exp_chain.py)
against the same recurrence written with ``jax.numpy``.

The JAX package's probe kernel ``kern`` is a closure inside
``pallas_exp_chain_rate`` (benchmarks/micro_exp_roofline.py) and compiles
only for a TPU, so it cannot be called alone: the test writes its loop
body, ``acc = acc * 0.5 + exp(x - acc * 1e-3 - 1.0)`` from ``acc = 0``,
with ``jax.numpy`` on the same float32 inputs. Tolerance: 1e-5 absolute,
as chip_smoke.py holds the CUDA kernel (float32 exps of two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops.exp_chain import (
    CHAIN,
    exp_chain,
    exp_chain_reference,
)
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)


ATOL = 1e-5


def _x(shape=(32, 128), seed=0):
    rng = np.random.default_rng(seed)
    # the TPU probe's input: −|N(0, 1)|
    return -np.abs(rng.normal(size=shape)).astype(np.float32)


@jax.jit
def _jax_chain(x):
    acc = jnp.zeros_like(x)
    for _ in range(CHAIN):
        acc = acc * 0.5 + jnp.exp(x - acc * 1e-3 - 1.0)
    return acc


@pytest.mark.parametrize("repeats", [1, 3])
def test_reference_matches_jax_recurrence(repeats):
    x = _x(seed=repeats)
    want = np.asarray(_jax_chain(jnp.asarray(x)))
    got = exp_chain_reference(torch.as_tensor(x), repeats).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_scalar_recurrence():
    """At x = 0 every element follows one scalar recurrence, run here in
    float64 Python."""
    x = torch.zeros(4, dtype=torch.float32)
    out = exp_chain_reference(x, 1)
    acc = 0.0
    for _ in range(CHAIN):
        acc = 0.5 * acc + np.exp(-1e-3 * acc - 1.0)
    np.testing.assert_allclose(out.numpy(), np.full(4, acc, np.float32),
                               atol=ATOL, rtol=0)


def test_wrapper_on_cpu_is_the_reference_and_uncounted():
    x = torch.as_tensor(_x((8, 16)))
    before = exp_chain.launches
    got = exp_chain(x, repeats=2)
    assert exp_chain.launches == before
    torch.testing.assert_close(got, exp_chain_reference(x, 2), rtol=0, atol=0)


@pytest.mark.parametrize("x, repeats, error", [
    (torch.zeros(8, dtype=torch.float64), 1, TypeError),
    (torch.zeros(8, 8)[:, ::2], 1, ValueError),
    (torch.zeros(8), 0, ValueError),
    (torch.zeros(8), 70000, ValueError),
], ids=["float64", "noncontiguous", "no-repeats", "too-many-repeats"])
def test_wrapper_rejects_bad_arguments(x, repeats, error):
    with pytest.raises(error):
        exp_chain(x, repeats)
