"""ADVI: automatic differentiation variational inference.

Mean-field Gaussian posterior over the flat parameter vector, ELBO
maximised with the reparameterisation trick and Adam.

Copied from ``pybnesian_tpu/inference/advi.py``: ``optax.adam`` becomes
``torch.optim.Adam`` with the same betas and eps (the same update), the
scan a Python loop; the Monte-Carlo draws come from ``key``, a
``torch.Generator`` on ``init``'s device or an ``int`` seed.
"""

from __future__ import annotations

import math

import torch
from torch.func import vmap

from .hmc import _generator

__all__ = ["advi"]


def advi(logdensity, init, key, num_steps: int = 2000, num_mc: int = 8,
         learning_rate: float = 0.02):
    """Returns (mu, sigma, elbo_trace): the fitted mean-field posterior and
    the ELBO trajectory (a tensor of ``num_steps``)."""
    gen = _generator(key, init.device)
    dim = init.shape[0]
    mu = init.detach().clone().requires_grad_(True)
    log_sigma = torch.full_like(mu, -2.0).requires_grad_(True)
    opt = torch.optim.Adam([mu, log_sigma], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    batched = vmap(logdensity)
    const = 0.5 * dim * (1.0 + math.log(2 * math.pi))
    elbo = []
    for _ in range(num_steps):
        eps = torch.randn((num_mc, dim), generator=gen, dtype=init.dtype,
                          device=init.device)
        thetas = mu[None, :] + eps * torch.exp(log_sigma)[None, :]
        loss = -(batched(thetas).mean() + log_sigma.sum() + const)
        opt.zero_grad()
        loss.backward()
        opt.step()
        elbo.append(-loss.detach())
    return (mu.detach(), torch.exp(log_sigma).detach(),
            torch.stack(elbo) if elbo else init.new_zeros(0))
