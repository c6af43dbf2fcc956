"""Nelder–Mead of the torch port against the JAX package's.

Both minimizers take the same analytic objectives, written once over an
array namespace (``jnp`` or ``torch``), from the same float64 starts: a
quadratic bowl, Rosenbrock, and a terraced objective whose plateaus give
vertices with EQUAL values (the case that needs a stable vertex order).
The two must return the same point, the same value and the same iteration
count per lane, atol 1e-10; a lane that converged must stay where it was
while the others go on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu.ops import nelder_mead as jnm
from pybnesian_tpu_torch.ops import nelder_mead as tnm
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

ATOL = 1e-10
# convergence tolerances of the compared searches: the x spread stays well
# above sqrt(machine epsilon), so the last steps still compare values that
# differ by more than the two packages' rounding
FATOL, XATOL = 1e-7, 1e-4


def quadratic(xp):
    """An anisotropic bowl with its minimum 0 at 1.5 − 0.21·k: unequal
    curvatures keep vertex values from tying up to rounding, which the two
    packages' arithmetic could break differently."""
    def f(x):
        k = xp.arange(x.shape[-1]) * 1.0
        return xp.sum((x - (1.5 - 0.21 * k)) ** 2 * (1.0 + 0.37 * k),
                      axis=-1)
    return f


def rosenbrock(xp):
    def f(x):
        return xp.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                      + (1.0 - x[..., :-1]) ** 2, axis=-1)
    return f


def terraces(xp):
    """Flat steps of height 0.5 around the origin: whole simplices sit on
    one plateau, all vertices equal."""
    def f(x):
        return xp.floor(2.0 * xp.sum(x * x, axis=-1)) * 0.5
    return f


OBJECTIVES = {"quadratic": quadratic, "rosenbrock": rosenbrock,
              "terraces": terraces}


def _starts(n, B=6, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(0.0, 1.5, size=(B, n))
    x0[0, 0] = 0.0          # a zero coordinate: the 0.00025 perturbation
    return x0


CASES = [(name, n) for name in OBJECTIVES for n in (1, 2, 3, 4)
         if not (name == "rosenbrock" and n == 1)]


@pytest.mark.parametrize("name,n", CASES)
def test_batch_form_matches_jax(name, n):
    x0 = _starts(n)
    fat = np.full(len(x0), FATOL)
    fat[1] = 1e-3            # per-lane tolerances
    xat = np.full(len(x0), XATOL)
    xat[2] = 1e-2
    make = OBJECTIVES[name]
    jx, jf, ji = jnm.nelder_mead_batch(
        make(jnp), jnp.asarray(x0), jnp.asarray(fat), jnp.asarray(xat),
        max_iter=150 * n)
    tx, tf, ti = tnm.nelder_mead_batch(
        make(torch), torch.as_tensor(x0), torch.as_tensor(fat),
        torch.as_tensor(xat), max_iter=150 * n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=ATOL)
    assert tx.dtype == torch.float64 and ti.shape == (len(x0),)


@pytest.mark.parametrize("name,n", [c for c in CASES if c[1] != 4])
def test_single_form_matches_jax(name, n):
    make = OBJECTIVES[name]
    for x0 in _starts(n, B=3, seed=n):
        jx, jf, ji = jnm.nelder_mead(make(jnp), jnp.asarray(x0), FATOL, XATOL,
                                     max_iter=120 * n)
        tx, tf, ti = tnm.nelder_mead(make(torch), torch.as_tensor(x0),
                                     FATOL, XATOL, max_iter=120 * n)
        assert int(ti) == int(ji)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(float(tf), float(jf), rtol=0, atol=ATOL)


def test_quadratic_reaches_the_minimum():
    x0 = _starts(3)
    tx, tf, _ = tnm.nelder_mead_batch(quadratic(torch), torch.as_tensor(x0),
                                      1e-12, 1e-9, max_iter=2000)
    np.testing.assert_allclose(
        tx.numpy(), np.tile(1.5 - 0.21 * np.arange(3), (len(x0), 1)),
        atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), 0.0, atol=1e-10)


def test_frozen_lanes_do_not_move():
    """Lane 0 starts on a plateau wider than its simplex and is converged
    before the first iteration; it must come back untouched, with zero
    iterations, while lane 1 runs on. And a lane gives the same answer,
    bit for bit, run alone or beside lanes that stop earlier or later."""
    x0 = np.array([[0.1, 0.1], [2.0, -1.0]])
    f = terraces(torch)
    tx, tf, ti = tnm.nelder_mead_batch(f, torch.as_tensor(x0), 1e-9,
                                       torch.tensor([1.0, 1e-3]),
                                       max_iter=50)
    assert ti.tolist()[0] == 0 and ti.tolist()[1] > 0
    np.testing.assert_array_equal(tx[0].numpy(), x0[0])

    x0 = _starts(2, B=4, seed=5)
    together = tnm.nelder_mead_batch(rosenbrock(torch), torch.as_tensor(x0),
                                     1e-9, 1e-8, max_iter=400)
    for i in range(4):
        one = tnm.nelder_mead_batch(rosenbrock(torch),
                                    torch.as_tensor(x0[i:i + 1]), 1e-9, 1e-8,
                                    max_iter=400)
        np.testing.assert_array_equal(together[0][i].numpy(),
                                      one[0][0].numpy())
        assert int(together[2][i]) == int(one[2][0])


def test_objective_calls_per_iteration():
    """Two batched objective calls per iteration, n more only when some
    lane shrinks, n + 1 for the initial simplex."""
    calls = []

    def f(x):
        calls.append(x.shape)
        return quadratic(torch)(x)

    n = 3
    _, _, it = tnm.nelder_mead_batch(f, torch.as_tensor(_starts(n, B=2)),
                                     1e-9, 1e-8, max_iter=30)
    iters = int(it.max())
    extra = len(calls) - (n + 1) - 2 * iters
    assert extra >= 0 and extra % n == 0
    assert all(s == (2, n) for s in calls)
