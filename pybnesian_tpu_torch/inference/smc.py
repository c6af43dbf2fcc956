"""SMC: tempered-likelihood sequential Monte Carlo over network parameters.

Particles follow a geometric temperature ladder p_t ∝ prior ·
likelihood^{β_t}; systematic resampling triggers on low ESS; HMC mutations
rejuvenate.

Copied from ``pybnesian_tpu/inference/smc.py``: the particles move as one
(P, dim) tensor, their densities and gradients through ``torch.func.vmap``;
the resampling decision reads the ESS from the device once per step. Draws
come from ``key``, a ``torch.Generator`` on the particles' device or an
``int`` seed.
"""

from __future__ import annotations

import math

import torch
from torch.func import vmap

from .hmc import _generator, _kinetic, _leapfrog, _value_and_grad

__all__ = ["smc"]


def _systematic_resample(u0, log_weights):
    """Indices of a systematic resample of ``log_weights`` (P,) at the
    uniform offset ``u0``. When the cumulative sum ends below 1 by
    rounding, the last points would fall past its end: they take the last
    particle (JAX's gather clamps the index there)."""
    n = log_weights.shape[0]
    w = torch.exp(log_weights - torch.logsumexp(log_weights, 0))
    cdf = torch.cumsum(w, 0)
    points = (u0 + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    return torch.clamp(torch.searchsorted(cdf, points), max=n - 1)


def smc(logprior, loglik, init_particles, key, num_steps: int = 20,
        mutation_steps: int = 5, leapfrog_steps: int = 8,
        step_size: float = 0.05, ess_threshold: float = 0.5):
    """Returns (particles, log_weights, log_evidence_estimate).

    init_particles: (P, dim) — e.g. prior draws or jittered MLE.
    """
    P, dim = init_particles.shape
    like = dict(dtype=init_particles.dtype, device=init_particles.device)
    gen = _generator(key, init_particles.device)
    betas = torch.linspace(0.0, 1.0, num_steps + 1, dtype=torch.float64)
    batched_loglik = vmap(loglik)
    ones = torch.ones(dim, **like)

    def mutate(theta, beta):
        vg = vmap(_value_and_grad(lambda t: logprior(t) + beta * loglik(t)))
        lp, g = vg(theta)
        for _ in range(mutation_steps):
            mom = torch.randn((P, dim), generator=gen, **like)
            new_th, new_mom, (new_lp, new_g) = _leapfrog(
                vg, theta, mom, step_size, ones, leapfrog_steps, (lp, g))
            delta = new_lp - lp - _kinetic(new_mom, ones) + _kinetic(mom,
                                                                     ones)
            ap = torch.nan_to_num(torch.clamp(torch.exp(delta), max=1.0),
                                  nan=0.0)
            accept = torch.rand(P, generator=gen, **like) < ap
            theta = torch.where(accept[:, None], new_th, theta)
            lp = torch.where(accept, new_lp, lp)
            g = torch.where(accept[:, None], new_g, g)
        return theta

    particles = init_particles
    uniform = torch.full((P,), -math.log(P), **like)
    log_w_norm = uniform
    log_z = torch.zeros((), **like)
    for t in range(num_steps):
        beta_prev, beta = float(betas[t]), float(betas[t + 1])
        incr = batched_loglik(particles) * (beta - beta_prev)
        # evidence increment: E_w[ lik^Δβ ]
        log_z = log_z + torch.logsumexp(log_w_norm + incr, 0)
        log_w_norm = log_w_norm + incr
        log_w_norm = log_w_norm - torch.logsumexp(log_w_norm, 0)
        ess = 1.0 / torch.exp(2.0 * log_w_norm).sum()
        if bool(ess < ess_threshold * P):
            u0 = torch.rand((), generator=gen, **like)
            particles = particles[_systematic_resample(u0, log_w_norm)]
            log_w_norm = uniform
        particles = mutate(particles, beta)
    return particles, log_w_norm, log_z
