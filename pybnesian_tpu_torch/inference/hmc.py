"""Hamiltonian Monte Carlo + NUTS over network parameters.

Copied from ``pybnesian_tpu/inference/hmc.py``: the leapfrog integrator, the
NUTS tree doubling and the warmup adaptation (dual-averaging step size +
diagonal mass matrix) are the same arithmetic, written as tensor code in
Python loops. Gradients come from ``torch.func.grad_and_value`` (and its
``vmap`` over chains); on the card the samplers replay them from a CUDA
graph (:func:`_graphed`). A NUTS transition reads one flag per doubling level
from the device — has the trajectory (every chain's, in the chain-batched
sampler) U-turned? — and stops doubling there.

Randomness: ``key`` is a ``torch.Generator`` on ``init``'s device, or an
``int`` seed for one. Every draw comes from it; the chains of
:func:`nuts_chains` and :func:`sample_chains` draw batched tensors from
the one generator.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import grad_and_value, vmap

__all__ = ["hmc", "nuts", "nuts_chains", "sample_chains",
           "sample_chains_sharded"]


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _generator(key, device) -> torch.Generator:
    """``key`` as a generator on ``device``: an int seeds a new one, a
    generator is used as it is."""
    if isinstance(key, int):
        return torch.Generator(device=device).manual_seed(key)
    return key


def _value_and_grad(logdensity):
    """theta -> (logp, grad), the order of ``jax.value_and_grad``."""
    gv = grad_and_value(logdensity)

    def vg(theta):
        g, lp = gv(theta)
        return lp, g

    return vg


def _graphed(fn, example):
    """``fn`` (tensor -> tuple of tensors, with no host read inside)
    replayed from a CUDA graph captured at ``example``'s shape and dtype:
    one graph launch in place of the few hundred small kernels of a
    density and its gradient, whose launches bound a sampler on the card.
    A call copies its argument into the captured input and returns clones
    of the captured outputs. On the CPU, ``fn`` itself."""
    if example.device.type != "cuda":
        return fn
    static = example.detach().clone()
    side = torch.cuda.Stream(device=example.device)
    side.wait_stream(torch.cuda.current_stream(example.device))
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA asks
        for _ in range(2):
            fn(static)
    torch.cuda.current_stream(example.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(static)

    def replay(theta):
        static.copy_(theta)
        graph.replay()
        return tuple(o.clone() for o in out)

    return replay


def _da_init(step_size):
    log_step = torch.log(step_size)
    return DualAveragingState(
        log_step, torch.zeros_like(log_step), torch.zeros_like(log_step),
        math.log(10.0) + log_step, torch.zeros_like(log_step),
    )


def _da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0,
               kappa=0.75):
    count = state.count + 1.0
    h_avg = (1.0 - 1.0 / (count + t0)) * state.h_avg + (
        target - accept_prob
    ) / (count + t0)
    log_step = state.mu - torch.sqrt(count) / gamma * h_avg
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_avg, state.mu, count)


def _leapfrog(logdensity_grad, theta, momentum, step, inv_mass, n_steps,
              logp_grad=None):
    """Velocity-Verlet with the end-point gradient threaded through the
    loop: the trailing half-kick gradient of step k IS the leading
    half-kick gradient of step k+1, so a trajectory costs exactly
    ``n_steps`` gradient evaluations (not 2·n_steps). Returns
    ``(theta, momentum, (logp, grad))`` with the density/gradient at the
    final point, so callers never re-evaluate it. Batched over leading
    axes when ``logdensity_grad`` is."""
    lp, g = logp_grad if logp_grad is not None else logdensity_grad(theta)
    for _ in range(int(n_steps)):
        momentum = momentum + 0.5 * step * g
        theta = theta + step * momentum * inv_mass
        lp, g = logdensity_grad(theta)
        momentum = momentum + 0.5 * step * g
    return theta, momentum, (lp, g)


def _kinetic(momentum, inv_mass):
    return 0.5 * (momentum.square() * inv_mass).sum(-1)


def _welford(theta, mean, m2, count):
    """One Welford update of the running mean and sum of squares."""
    delta = theta - mean
    mean = mean + delta / count
    return mean, m2 + delta * (theta - mean)


def _warm_inv_mass(m2, count, ones):
    """The diagonal inverse mass of a warmup step: the running variance
    once 10 draws are in, else ones."""
    if count > 10.0:
        return torch.clamp(m2 / max(count - 1.0, 1.0), min=1e-6)
    return ones


def hmc(logdensity: Callable, init, key, num_samples: int = 1000,
        num_warmup: int = 500, num_leapfrog: int = 16,
        initial_step: float = 0.1, target_accept: float = 0.8,
        jitter_steps: bool = True):
    """Adaptive HMC: dual-averaging step size and diagonal mass matrix fitted
    during warmup, trajectory length jittered to decorrelate (the standard
    robust alternative to dynamic termination). Returns (samples, info)."""
    vg = _graphed(_value_and_grad(logdensity), init)
    gen = _generator(key, init.device)
    dim = init.shape[0]
    like = dict(dtype=init.dtype, device=init.device)

    def one_step(theta, logp, grad, step, inv_mass):
        momentum = torch.randn(dim, generator=gen, **like) / torch.sqrt(
            inv_mass)
        steps = num_leapfrog
        if jitter_steps:
            steps = 1 + int(torch.randint(0, num_leapfrog, (), generator=gen,
                                          device=init.device))
        new_theta, new_momentum, (new_logp, new_grad) = _leapfrog(
            vg, theta, momentum, step, inv_mass, steps, (logp, grad)
        )
        delta_h = (
            new_logp - logp - _kinetic(new_momentum, inv_mass)
            + _kinetic(momentum, inv_mass)
        )
        accept_prob = torch.clamp(torch.exp(delta_h), max=1.0)
        accept_prob = torch.nan_to_num(accept_prob, nan=0.0)
        accept = torch.rand((), generator=gen, **like) < accept_prob
        theta = torch.where(accept, new_theta, theta)
        logp = torch.where(accept, new_logp, logp)
        grad = torch.where(accept, new_grad, grad)
        return theta, logp, grad, accept_prob

    theta = init
    logp, grad = vg(init)
    da = _da_init(torch.tensor(initial_step, **like))
    mean = torch.zeros(dim, **like)
    m2 = torch.zeros(dim, **like)
    ones = torch.ones(dim, **like)
    warm_accept = []
    for i in range(num_warmup):
        count = float(i)
        inv_mass = _warm_inv_mass(m2, count, ones)
        theta, logp, grad, accept_prob = one_step(
            theta, logp, grad, torch.exp(da.log_step), inv_mass)
        da = _da_update(da, accept_prob, target=target_accept)
        mean, m2 = _welford(theta, mean, m2, count + 1.0)
        warm_accept.append(accept_prob)
    step = torch.exp(da.log_step_avg)
    inv_mass = torch.clamp(m2 / max(num_warmup - 1.0, 1.0), min=1e-6)

    samples, accepts = [], []
    for _ in range(num_samples):
        theta, logp, grad, accept_prob = one_step(theta, logp, grad, step,
                                                  inv_mass)
        samples.append(theta)
        accepts.append(accept_prob)
    info = {
        "step_size": step,
        "accept_rate": torch.stack(accepts).mean(),
        "warmup_accept_rate": _mean_or_nan(warm_accept, like),
        "inv_mass": inv_mass,
    }
    return torch.stack(samples), info


def _mean_or_nan(values, like):
    """Mean of a list of tensors along a new first axis (NaN when empty,
    as ``jnp.mean`` of an empty scan output)."""
    if not values:
        return torch.tensor(math.nan, **like)
    return torch.stack(values).mean(0)


def _nuts_step(vg, theta, logp, grad, gen, step, inv_mass, max_depth):
    """One multinomial-NUTS transition with tree doubling.

    Each level extends the trajectory away from the current tree by 2^level
    leapfrog steps, with a U-turn check per level; once a level turns (or
    diverges), the remaining levels are skipped (one device read per
    level). Endpoint and sampled-point gradients ride in the tree state, so
    each leapfrog step costs exactly ONE density+gradient evaluation.
    Returns (sample, its logp, its grad, accept statistic, leapfrogs)."""
    dim = theta.shape[0]
    like = dict(dtype=theta.dtype, device=theta.device)
    neg_inf = torch.tensor(-math.inf, **like)
    momentum = torch.randn(dim, generator=gen, **like) / torch.sqrt(inv_mass)
    h0 = logp - _kinetic(momentum, inv_mass)

    # trajectory: endpoints (+ their density/gradient), sampled point
    # (multinomial, + its density/gradient), log weight
    minus = (theta, momentum, logp, grad)
    plus = (theta, momentum, logp, grad)
    sample = (theta, logp, grad)
    logw_sum = torch.tensor(0.0, **like)
    sum_accept = torch.tensor(0.0, **like)
    n_steps = 0

    for level in range(max_depth):
        n_sub = 2**level
        go_right = torch.rand((), generator=gen, **like) < 0.5
        th, r, lp, g = (torch.where(go_right, p, m) for p, m in zip(
            plus, (minus[0], -minus[1], minus[2], minus[3])))
        logw = neg_inf
        seg_sample = (th, lp, g)
        sum_a = torch.tensor(0.0, **like)
        for _ in range(n_sub):
            th, r, (lp, g) = _leapfrog(vg, th, r, step, inv_mass, 1, (lp, g))
            logw_new = lp - _kinetic(r, inv_mass) - h0
            logw_new = torch.where(torch.isnan(logw_new), neg_inf, logw_new)
            sum_a = sum_a + torch.clamp(torch.exp(logw_new), max=1.0)
            # multinomial sampling within the new segment
            total = torch.logaddexp(logw, logw_new)
            take = torch.rand((), generator=gen, **like) < torch.exp(
                logw_new - total)
            seg_sample = tuple(torch.where(take, new, old) for new, old in
                               zip((th, lp, g), seg_sample))
            logw = total
        # candidate merged endpoints
        new_minus = tuple(torch.where(go_right, m, e) for m, e in zip(
            minus, (th, -r, lp, g)))
        new_plus = tuple(torch.where(go_right, e, p) for e, p in zip(
            (th, r, lp, g), plus))
        dtheta = new_plus[0] - new_minus[0]
        turned = ((dtheta * new_minus[1] * inv_mass).sum() < 0) | (
            (dtheta * new_plus[1] * inv_mass).sum() < 0)
        diverged = logw < -1000.0

        # NUTS semantics: a subtree that triggers the U-turn/divergence
        # condition is DISCARDED, not merged — only the stopping flag and
        # accept statistics survive from it.
        total = torch.logaddexp(logw_sum, logw)
        take_new = torch.rand((), generator=gen, **like) < torch.exp(
            logw - total)
        stop = turned | diverged
        keep = ~stop
        take = keep & take_new
        minus = tuple(torch.where(keep, n, o) for n, o in zip(new_minus,
                                                              minus))
        plus = tuple(torch.where(keep, n, o) for n, o in zip(new_plus, plus))
        sample = tuple(torch.where(take, n, o) for n, o in zip(seg_sample,
                                                               sample))
        logw_sum = torch.where(keep, total, logw_sum)
        sum_accept = sum_accept + sum_a
        n_steps += n_sub
        if bool(stop):
            break

    accept_stat = sum_accept / max(n_steps, 1)
    return (*sample, accept_stat, n_steps)


def nuts(logdensity: Callable, init, key, num_samples: int = 1000,
         num_warmup: int = 500, max_depth: int = 6,
         initial_step: float = 0.1, target_accept: float = 0.8):
    """No-U-Turn sampler with multinomial trajectory sampling (see
    _nuts_step). Warmup adapts step size (dual averaging) and a diagonal
    mass matrix. Returns (samples, info); ``info["mean_leapfrogs"]`` is the
    mean number of gradient evaluations per kept sample."""
    vg = _graphed(_value_and_grad(logdensity), init)
    gen = _generator(key, init.device)
    dim = init.shape[0]
    like = dict(dtype=init.dtype, device=init.device)
    theta = init
    logp, grad = vg(init)

    da = _da_init(torch.tensor(initial_step, **like))
    mean = torch.zeros(dim, **like)
    m2 = torch.zeros(dim, **like)
    ones = torch.ones(dim, **like)
    warm_accept = []
    for i in range(num_warmup):
        count = float(i)
        theta, logp, grad, accept, _ = _nuts_step(
            vg, theta, logp, grad, gen, torch.exp(da.log_step),
            _warm_inv_mass(m2, count, ones), max_depth)
        da = _da_update(da, accept, target=target_accept)
        mean, m2 = _welford(theta, mean, m2, count + 1.0)
        warm_accept.append(accept)
    step = torch.exp(da.log_step_avg)
    inv_mass = torch.clamp(m2 / max(num_warmup - 1.0, 1.0), min=1e-6)

    samples, accepts, leapfrogs = [], [], 0
    for _ in range(num_samples):
        theta, logp, grad, accept, n = _nuts_step(
            vg, theta, logp, grad, gen, step, inv_mass, max_depth)
        samples.append(theta)
        accepts.append(accept)
        leapfrogs += n
    info = {
        "step_size": step,
        "accept_rate": torch.stack(accepts).mean(),
        "warmup_accept_rate": _mean_or_nan(warm_accept, like),
        "inv_mass": inv_mass,
        "mean_leapfrogs": leapfrogs / max(num_samples, 1),
    }
    return torch.stack(samples), info


def _nuts_step_chains(vg_b, theta, logp, grad, gen, step, inv_mass,
                      max_depth):
    """Chain-batched :func:`_nuts_step`: the chain axis C is explicit
    (theta (C, d), logp (C,), per-chain step and diagonal mass). Chains
    that have U-turned are masked; a doubling level runs while ANY chain
    still extends (one device read per level), so whole levels are skipped
    once every chain has U-turned. Turned chains keep their state and
    statistics. Returns (sample, logp, grad, accept statistic, leapfrogs),
    each per chain."""
    C, dim = theta.shape
    like = dict(dtype=theta.dtype, device=theta.device)
    neg_inf = torch.full((C,), -math.inf, **like)

    def kin(m):
        return _kinetic(m, inv_mass)

    def sel(cond, a, b):
        """Per-chain select: ``cond`` (C,) against (C,) or (C, d)."""
        return torch.where(cond.reshape(C, *([1] * (a.dim() - 1))), a, b)

    momentum = torch.randn((C, dim), generator=gen, **like) / torch.sqrt(
        inv_mass)
    h0 = logp - kin(momentum)
    minus = (theta, momentum, logp, grad)
    plus = (theta, momentum, logp, grad)
    sample = (theta, logp, grad)
    logw_sum = torch.zeros(C, **like)
    turned_all = torch.zeros(C, dtype=torch.bool, device=theta.device)
    sum_accept = torch.zeros(C, **like)
    n_steps = torch.zeros(C, **like)
    st = step[:, None]

    for level in range(max_depth):
        n_sub = 2**level
        active = ~turned_all
        go_right = torch.rand(C, generator=gen, **like) < 0.5
        th, r, lp, g = (sel(go_right, p, m) for p, m in zip(
            plus, (minus[0], -minus[1], minus[2], minus[3])))
        logw = neg_inf
        seg_sample = (th, lp, g)
        sum_a = torch.zeros(C, **like)
        for _ in range(n_sub):
            r = r + 0.5 * st * g
            th = th + st * r * inv_mass
            lp, g = vg_b(th)
            r = r + 0.5 * st * g
            logw_new = lp - kin(r) - h0
            logw_new = torch.where(torch.isnan(logw_new), neg_inf, logw_new)
            sum_a = sum_a + torch.clamp(torch.exp(logw_new), max=1.0)
            total = torch.logaddexp(logw, logw_new)
            take = torch.rand(C, generator=gen, **like) < torch.exp(
                logw_new - total)
            seg_sample = tuple(sel(take, n, o) for n, o in
                               zip((th, lp, g), seg_sample))
            logw = total
        new_minus = tuple(sel(go_right, m, e) for m, e in zip(
            minus, (th, -r, lp, g)))
        new_plus = tuple(sel(go_right, e, p) for e, p in zip(
            (th, r, lp, g), plus))
        dtheta = new_plus[0] - new_minus[0]
        turned = ((dtheta * new_minus[1] * inv_mass).sum(1) < 0) | (
            (dtheta * new_plus[1] * inv_mass).sum(1) < 0)
        diverged = logw < -1000.0

        total = torch.logaddexp(logw_sum, logw)
        take_new = torch.rand(C, generator=gen, **like) < torch.exp(
            logw - total)
        keep = ~(turned | diverged) & active
        take = keep & take_new
        minus = tuple(sel(keep, n, o) for n, o in zip(new_minus, minus))
        plus = tuple(sel(keep, n, o) for n, o in zip(new_plus, plus))
        sample = tuple(sel(take, n, o) for n, o in zip(seg_sample, sample))
        logw_sum = torch.where(keep, total, logw_sum)
        turned_all = torch.where(active, turned | diverged, turned_all)
        sum_accept = sum_accept + torch.where(active, sum_a, 0.0)
        n_steps = n_steps + active.to(n_steps.dtype) * n_sub
        if bool(turned_all.all()):
            break

    accept_stat = sum_accept / torch.clamp(n_steps, min=1.0)
    return (*sample, accept_stat, n_steps)


def nuts_chains(logdensity: Callable, inits, keys, num_samples: int = 1000,
                num_warmup: int = 500, max_depth: int = 6,
                initial_step: float = 0.1, target_accept: float = 0.8):
    """C chains of :func:`nuts` with the chain axis explicit (see
    :func:`_nuts_step_chains`). Per-chain warmup adaptation mirrors
    :func:`nuts`. ``inits``: (C, dim); ``keys``: one generator (or seed)
    for all chains. Returns (samples (C, num_samples, dim), info)."""
    batched = _graphed(vmap(_value_and_grad(logdensity)), inits)
    gen = _generator(keys, inits.device)
    C, dim = inits.shape
    like = dict(dtype=inits.dtype, device=inits.device)
    theta = inits
    logp, grad = batched(inits)

    da = _da_init(torch.full((C,), initial_step, **like))
    mean = torch.zeros((C, dim), **like)
    m2 = torch.zeros((C, dim), **like)
    ones = torch.ones((C, dim), **like)
    warm_accept = []
    for i in range(num_warmup):
        count = float(i)
        theta, logp, grad, accept, _ = _nuts_step_chains(
            batched, theta, logp, grad, gen, torch.exp(da.log_step),
            _warm_inv_mass(m2, count, ones), max_depth)
        da = _da_update(da, accept, target=target_accept)
        mean, m2 = _welford(theta, mean, m2, count + 1.0)
        warm_accept.append(accept)
    step = torch.exp(da.log_step_avg)
    inv_mass = torch.clamp(m2 / max(num_warmup - 1.0, 1.0), min=1e-6)

    samples, accepts, nlfs = [], [], []
    for _ in range(num_samples):
        theta, logp, grad, accept, nlf = _nuts_step_chains(
            batched, theta, logp, grad, gen, step, inv_mass, max_depth)
        samples.append(theta)
        accepts.append(accept)
        nlfs.append(nlf)
    info = {
        "step_size": step,
        "accept_rate": torch.stack(accepts).mean(0),
        "warmup_accept_rate": _mean_or_nan(warm_accept, like),
        "inv_mass": inv_mass,
        # mean leapfrogs (= gradient evaluations) per kept sample — lets
        # benchmarks audit samples/s against the card's raw gradient rate
        "mean_leapfrogs": torch.stack(nlfs).mean(0),
    }
    return torch.stack(samples, 1), info


def sample_chains(logdensity, init, key, num_chains: int = 4,
                  method: str = "nuts", **kwargs):
    """Multiple chains on one device; jitter the inits. NUTS chains run
    through the chain-batched :func:`nuts_chains` (whole doubling levels
    are skipped once every chain U-turns); HMC chains run one after
    another from the same generator, their outputs stacked."""
    gen = _generator(key, init.device)
    dim = init.shape[0]
    jitter = 0.1 * torch.randn((num_chains, dim), generator=gen,
                               dtype=init.dtype, device=init.device)
    inits = init[None, :] + jitter
    if method == "nuts":
        return nuts_chains(logdensity, inits, gen, **kwargs)
    runs = [hmc(logdensity, i, gen, **kwargs) for i in inits]
    samples = torch.stack([s for s, _ in runs])
    info = {k: torch.stack([torch.as_tensor(inf[k]) for _, inf in runs])
            for k in runs[0][1]}
    return samples, info


def sample_chains_sharded(logdensity, init, key, mesh, axis: str = "data",
                          chains_per_device: int = 1, method: str = "hmc",
                          **kwargs):
    """Chains sharded over several devices: not in the port yet."""
    raise NotImplementedError(
        "sample_chains_sharded comes to the torch port with its multi-device "
        "runtime (ROADMAP Queue 1 item 8); on one device use sample_chains")
