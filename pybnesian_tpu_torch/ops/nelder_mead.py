"""Nelder–Mead simplex minimizer on torch tensors.

Port of ``pybnesian_tpu/ops/nelder_mead.py``, the minimizer behind the UCV
bandwidth search (the reference minimizes the UCV objective with NLopt
Nelder–Mead, kde/UCV.cpp:469-505). The JAX package runs the whole search
in one ``lax.while_loop``; here the loop runs on the host over batched
tensor steps, and reads the device twice per iteration: the scalar
``any(shrink)`` and the scalar ``all(done)``. Everything else stays on the
tensors' device, so one iteration of B problems costs two batched objective
calls whatever B is. On the card a float32 UCV search runs as one launch
of a kernel instead (``ops/ucv_search_kernel.py``), and this loop over the
UCV objective is its plain version.

Coefficients and the initial simplex follow scipy.optimize's Nelder–Mead
(rho=1, chi=2, psi=0.5, sigma=0.5; x0 perturbed 5% per coordinate, 0.00025
for zeros). Vertices are ordered with a STABLE sort, as ``jnp.argsort``
orders them: equal vertex values are common (a guarded objective returns
one constant for every bad point), and an unstable order would send the
two packages down different branches.
"""

from __future__ import annotations

import torch

__all__ = ["nelder_mead", "nelder_mead_batch", "nelder_mead_batch_counted"]


def _order(sim, fv):
    idx = torch.argsort(fv, dim=1, stable=True)
    return (
        torch.take_along_dim(sim, idx[:, :, None], dim=1),
        torch.take_along_dim(fv, idx, dim=1),
    )


def nelder_mead_batch_counted(objective, x0s, fatol, xatol,
                              max_iter: int = 400):
    """Lane-batched Nelder–Mead: ``objective`` maps (B, n) points to (B,)
    values (each lane closing over its own data), and every iteration costs
    exactly TWO batched objective calls: the reflection, then ONE second
    point chosen per lane among expansion, outside contraction and inside
    contraction. The shrink step hides behind a SCALAR ``any(shrink)``, so
    its n extra evaluations only run on the (rare) iterations where some
    lane shrinks. ``fatol`` and ``xatol`` are scalars or (B,) tensors, one
    tolerance per lane. A lane that has converged, or has taken
    ``max_iter`` iterations, is frozen: its simplex no longer moves while
    the others go on; a lane whose best value is NaN (every value NaN:
    the sort puts NaN last) never converges, and is done before the first
    iteration. The centroid of the best n vertices is their sum in vertex
    order divided by a tensor of n, operations that round the same on
    every device (``torch.mean`` sums in an order of its own, and dividing
    by a Python number multiplies by its reciprocal on the card). Returns
    (x_best (B, n), f_best (B,), iters (B,), evaluations (B,)): int32
    counts of the evaluations each lane's own search needed — its n + 1
    starting vertices, then per iteration its reflection, its second point
    unless the reflection was kept, and n when it shrank; none once it is
    frozen."""
    B, n = x0s.shape
    rho, chi, psi, sigma = 1.0, 2.0, 0.5, 0.5

    pert = torch.where(x0s != 0.0, x0s * 1.05, 0.00025)
    vertices = [x0s]
    for k in range(n):
        v = x0s.clone()
        v[:, k] = pert[:, k]
        vertices.append(v)
    simplex = torch.stack(vertices, dim=1)                     # (B, n+1, n)
    fvals = torch.stack(
        [objective(simplex[:, v]) for v in range(n + 1)], dim=1
    )
    simplex, fvals = _order(simplex, fvals)

    def converged(sim, fv):
        fspread = torch.amax(torch.abs(fv[:, 1:] - fv[:, :1]), dim=1)
        xspread = torch.amax(torch.abs(sim[:, 1:] - sim[:, :1]), dim=(1, 2))
        return (fspread <= fatol) & (xspread <= xatol)

    iters = torch.zeros(B, dtype=torch.int32, device=x0s.device)
    needed = torch.full((B,), n + 1, dtype=torch.int32, device=x0s.device)
    done = converged(simplex, fvals) | torch.isnan(fvals[:, 0])
    while not bool(done.all()):
        sim, fv = simplex, fvals
        xbar = sim[:, 0]
        for k in range(1, n):
            xbar = xbar + sim[:, k]
        xbar = xbar / torch.full_like(xbar, n)
        xw = sim[:, -1]
        fw = fv[:, -1]
        xr = xbar + rho * (xbar - xw)
        fr = objective(xr)

        best = fr < fv[:, 0]
        mid = (~best) & (fr < fv[:, -2])
        outside = (~best) & (~mid) & (fr < fw)
        x2 = torch.where(
            best[:, None],
            xbar + rho * chi * (xbar - xw),                    # expansion
            torch.where(
                outside[:, None],
                xbar + psi * rho * (xbar - xw),      # outside contraction
                xbar - psi * (xbar - xw),            # inside contraction
            ),
        )
        f2 = objective(x2)

        # accept rules (scipy): expand takes the better of xe/xr; reflect
        # takes xr; contractions accept only when they improve, else shrink
        take2 = torch.where(
            best, f2 < fr, torch.where(outside, f2 <= fr, f2 < fw)
        )
        use_r = mid | (~take2 & best)
        new_x = torch.where(use_r[:, None], xr, x2)
        new_f = torch.where(use_r, fr, f2)
        shrink = (~best) & (~mid) & (
            torch.where(outside, f2 > fr, f2 >= fw)
        ) & (~done)

        sim2 = sim.clone()
        sim2[:, -1] = new_x
        fv2 = fv.clone()
        fv2[:, -1] = new_f
        if bool(shrink.any()):
            shrunk = sim[:, :1] + sigma * (sim - sim[:, :1])
            fs = torch.stack(
                [fv[:, 0]]
                + [objective(shrunk[:, v]) for v in range(1, n + 1)],
                dim=1,
            )
            shrunk[:, 0] = sim[:, 0]           # keep the best vertex exact
            sim2 = torch.where(shrink[:, None, None], shrunk, sim2)
            fv2 = torch.where(shrink[:, None], fs, fv2)
        # frozen lanes keep their simplex untouched
        sim2 = torch.where(done[:, None, None], sim, sim2)
        fv2 = torch.where(done[:, None], fv, fv2)
        simplex, fvals = _order(sim2, fv2)
        needed = needed + torch.where(
            done, 0, 1 + (~mid).to(torch.int32) + n * shrink.to(torch.int32))
        iters = iters + (~done).to(torch.int32)
        done = done | converged(simplex, fvals) | (iters >= max_iter)
    return simplex[:, 0], fvals[:, 0], iters, needed


def nelder_mead_batch(objective, x0s, fatol, xatol, max_iter: int = 400):
    """:func:`nelder_mead_batch_counted` without the counts: (x_best (B,
    n), f_best (B,), iters (B,))."""
    return nelder_mead_batch_counted(objective, x0s, fatol, xatol,
                                     max_iter)[:3]


def nelder_mead(objective, x0, fatol, xatol, max_iter: int = 400):
    """Minimize ``objective`` (a scalar tensor function of a 1-D tensor)
    starting at ``x0``: :func:`nelder_mead_batch` with one lane, whose
    steps are those of the JAX package's single form. Returns (x_best,
    f_best, n_iter) as tensors."""
    xb, fb, it = nelder_mead_batch(
        lambda xs: objective(xs[0]).reshape(1), x0[None], fatol, xatol,
        max_iter=max_iter,
    )
    return xb[0], fb[0], it[0]
