"""The torch port's posterior inference against the JAX package, on the CPU.

Exact parity (1e-9, float64): ``make_logdensity`` and its gradient on
linear-Gaussian, CLG and discrete nodes (the layout, init and values, also
at a point carried over by ``interop.param_layout``), ``_leapfrog`` and
``_da_update`` given the same inputs, the diagnostics, ``apply_params`` and
``posterior_predictive`` given the same draws, and ``_systematic_resample``
given the same uniform.

Distributional parity: the samplers draw from their own generators, so
their samples differ from the reference's; their moments are held to the
tolerances of tests/inference/test_inference.py and test_config5_e2e.py,
at the same or smaller sizes, with fixed seeds so that each test is
deterministic. NUTS over a CLG posterior is held against the reference's
per-configuration MLE (its init).
"""

import importlib

import numpy as np
import pytest
import torch
from scipy.stats import norm

import jax
import jax.numpy as jnp

import pybnesian_tpu as jpb
import pybnesian_tpu_torch as tpb
from pybnesian_tpu import inference as jinf
from pybnesian_tpu_torch import interop
from pybnesian_tpu_torch import inference as tinf
from torch.func import grad_and_value, vmap

from data_gen import discrete_data, mixed_data, normal_chain_data
from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

# the modules, which the packages' functions of the same names shadow
jhmc, jsmc, thmc, tsmc = (importlib.import_module(f"{pkg}.inference.{m}")
                          for pkg in ("pybnesian_tpu", "pybnesian_tpu_torch")
                          for m in ("hmc", "smc"))

EXACT = dict(rtol=1e-9, atol=1e-9)

MODELS = {
    "lg": (lambda pkg: pkg.GaussianNetwork(
        ["a", "b", "c", "d"], [("a", "b"), ("b", "c"), ("c", "d")]),
        lambda: normal_chain_data(400)),
    "clg": (lambda pkg: pkg.CLGNetwork(
        ["A", "B", "X", "Y"], [("A", "X"), ("X", "Y"), ("B", "Y")]),
        lambda: mixed_data(400)),
    "discrete": (lambda pkg: pkg.DiscreteBN(
        ["A", "B", "C", "D"], [("A", "B"), ("B", "C"), ("A", "C"),
                               ("C", "D")]),
        lambda: discrete_data(400)),
}


def _densities(kind):
    make_model, make_df = MODELS[kind]
    df = make_df()
    j = jinf.make_logdensity(make_model(jpb), df, dtype=np.float64)
    t = tinf.make_logdensity(make_model(tpb), df, dtype=np.float64)
    return j, t


def _points(init, count=4, seed=0):
    rng = np.random.default_rng(seed)
    return [init] + [init + 0.2 * rng.standard_normal(init.shape)
                     for _ in range(count)]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_logdensity_and_gradient_match_the_reference(kind):
    (jl, jlay, jinit), (tl, tlay, tinit) = _densities(kind)
    assert tlay.slices == jlay.slices and tlay.size == jlay.size
    np.testing.assert_allclose(tinit.numpy(), np.asarray(jinit), **EXACT)
    jvg = jax.jit(jax.value_and_grad(jl))
    for p in _points(np.asarray(jinit)):
        jv, jg = jvg(jnp.asarray(p))
        tg, tv = grad_and_value(tl)(torch.tensor(p))
        np.testing.assert_allclose(float(tv), float(jv), **EXACT)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **EXACT)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_logdensity_vmaps_and_takes_the_reference_layout(kind):
    (jl, jlay, jinit), (tl, _, _) = _densities(kind)
    points = np.stack(_points(np.asarray(jinit), seed=1))
    layout, theta = interop.param_layout(jlay.slices, points[1])
    assert layout.slices == jlay.slices
    np.testing.assert_allclose(float(tl(theta)),
                               float(jl(jnp.asarray(points[1]))), **EXACT)
    batched = vmap(tl)(torch.from_numpy(points)).numpy()
    np.testing.assert_allclose(
        batched, [float(jl(jnp.asarray(p))) for p in points], **EXACT)
    node = next(iter(jlay.slices))
    np.testing.assert_array_equal(layout.unpack(node, theta).numpy(),
                                  np.asarray(jlay.unpack(node, points[1])))


def test_param_layout_refuses_a_theta_of_another_size():
    with pytest.raises(ValueError, match="layout holds"):
        interop.param_layout({"a": (0, 2, "lg")}, np.zeros(3))


def test_leapfrog_matches_the_reference():
    (jl, _, jinit), (tl, _, _) = _densities("clg")
    rng = np.random.default_rng(2)
    theta = np.array(jinit)
    mom = rng.standard_normal(theta.shape)
    inv_mass = rng.uniform(0.5, 2.0, theta.shape)
    jth, jm, (jlp, jg) = jhmc._leapfrog(
        jax.value_and_grad(jl), jnp.asarray(theta), jnp.asarray(mom), 1e-3,
        jnp.asarray(inv_mass), 5)
    calls = []
    vg = thmc._value_and_grad(tl)

    def counted(th):
        calls.append(1)
        return vg(th)

    tth, tm, (tlp, tg) = thmc._leapfrog(
        counted, torch.from_numpy(theta), torch.from_numpy(mom), 1e-3,
        torch.from_numpy(inv_mass), 5)
    assert len(calls) == 6  # one per step, and the start's
    for got, want in ((tth, jth), (tm, jm), (tlp, jlp), (tg, jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


def test_dual_averaging_matches_the_reference():
    j = jhmc._da_init(jnp.asarray(0.1))
    t = thmc._da_init(torch.tensor(0.1, dtype=torch.float64))
    for a in np.random.default_rng(3).uniform(0, 1, 40):
        j = jhmc._da_update(j, jnp.asarray(a), target=0.75)
        t = thmc._da_update(t, torch.tensor(a, dtype=torch.float64),
                            target=0.75)
    for got, want in zip(t, j):
        np.testing.assert_allclose(float(got), float(want), **EXACT)


def test_diagnostics_match_the_reference_on_arrays_and_tensors():
    rng = np.random.default_rng(0)
    ar = np.zeros((4, 600))
    for t in range(1, 600):
        ar[:, t] = 0.8 * ar[:, t - 1] + rng.normal(size=4)
    ar[0] += 0.3
    for samples in (ar, torch.from_numpy(ar)):
        np.testing.assert_allclose(tinf.potential_scale_reduction(samples),
                                   jinf.potential_scale_reduction(ar),
                                   **EXACT)
        np.testing.assert_allclose(tinf.effective_sample_size(samples),
                                   jinf.effective_sample_size(ar), **EXACT)
    got = tinf.summarize({"x": torch.from_numpy(ar), "y": ar[1]})
    want = jinf.summarize({"x": ar, "y": ar[1]})
    for name in want:
        for key in want[name]:
            np.testing.assert_allclose(got[name][key], want[name][key],
                                       **EXACT)


def _cpd_params(cpd):
    if hasattr(cpd, "_factors"):
        return [p for f in cpd._factors for p in _cpd_params(f)]
    if hasattr(cpd, "_logprob") and cpd._logprob is not None:
        return [np.asarray(cpd._logprob)]
    return [np.asarray(cpd.beta), np.asarray([cpd.variance])]


def test_apply_params_and_posterior_predictive_match_the_reference():
    make_model, make_df = MODELS["clg"]
    df = make_df()
    jm, tm = make_model(jpb), make_model(tpb)
    _, jlay, jinit = jinf.make_logdensity(jm, df, dtype=np.float64)
    _, tlay, _ = tinf.make_logdensity(tm, df, dtype=np.float64)
    draws = np.asarray(jinit)[None] + 0.05 * np.random.default_rng(
        4).standard_normal((6, len(jinit)))
    jfit = jinf.apply_params(jm, df, jlay, draws[2])
    tfit = tinf.apply_params(tm, df, tlay, torch.from_numpy(draws[2]))
    for node in jm.nodes():
        for got, want in zip(_cpd_params(tfit.cpd(node)),
                             _cpd_params(jfit.cpd(node))):
            np.testing.assert_allclose(got, want, **EXACT)
    want = jinf.posterior_predictive(jm, df, jlay, draws, 60, seed=2,
                                     max_draws=4)
    got = tinf.posterior_predictive(tm, df, tlay, torch.from_numpy(draws),
                                    60, seed=2, max_draws=4)
    assert list(got.columns) == list(want.columns) and len(got) == 60
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c], want[c], **EXACT)
        else:
            assert list(got[c].astype(str)) == list(want[c].astype(str))


@pytest.mark.parametrize("n, seed, u", [(16, 0, None), (64, 1, None),
                                        (10, 2, 1.0 - 2.0**-24)])
def test_systematic_resample_matches_the_reference(n, seed, u):
    logw = np.random.default_rng(seed).normal(0, 2, n).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    u0 = (float(jax.random.uniform(key, (), jnp.float32)) if u is None
          else u)
    if u is not None:  # the reference's key draws its own u0: pin it
        want = np.asarray(jnp.searchsorted(
            jnp.cumsum(jax.nn.softmax(jnp.asarray(logw))),
            (u0 + jnp.arange(n, dtype=jnp.float32)) / n))
    else:
        want = np.asarray(jsmc._systematic_resample(key, jnp.asarray(logw)))
    got = tsmc._systematic_resample(torch.tensor(u0, dtype=torch.float32),
                                    torch.from_numpy(logw)).numpy()
    # the reference's gather clamps an index past the end; the port's
    # indices are clamped already
    np.testing.assert_array_equal(got, np.minimum(want, n - 1))
    assert got.max() <= n - 1


# ------------------------------------------------------------ samplers
def _std_normal(theta):
    return -0.5 * (theta**2).sum()


def _zeros(d):
    return torch.zeros(d, dtype=torch.float64)


def test_hmc_standard_normal_moments():
    samples, info = tinf.hmc(_std_normal, _zeros(3), 0, num_samples=1500,
                             num_warmup=400)
    s = samples.numpy()
    assert float(info["accept_rate"]) > 0.5
    assert np.abs(s.mean(0)).max() < 0.15
    assert np.abs(s.std(0) - 1.0).max() < 0.15


def test_nuts_standard_normal_moments():
    samples, info = tinf.nuts(_std_normal, _zeros(3), 1, num_samples=1000,
                              num_warmup=400, max_depth=5)
    s = samples.numpy()
    assert np.abs(s.mean(0)).max() < 0.2
    assert np.abs(s.std(0) - 1.0).max() < 0.2
    assert 1.0 <= info["mean_leapfrogs"] <= 31.0


def test_correlated_gaussian_nuts():
    cov = np.array([[2.0, 1.2], [1.2, 1.0]])
    prec = torch.from_numpy(np.linalg.inv(cov))
    samples, _ = tinf.nuts(lambda t: -0.5 * t @ prec @ t, _zeros(2), 2,
                           num_samples=1500, num_warmup=500, max_depth=6)
    np.testing.assert_allclose(np.cov(samples.numpy().T), cov, atol=0.35)


def test_nuts_chains_and_sample_chains_moments():
    def logd(th):
        return -0.5 * (th**2).sum() - 0.1 * (th**4).sum()

    gen = torch.Generator().manual_seed(0)
    inits = 0.1 * torch.randn((4, 3), generator=gen, dtype=torch.float64)
    s, info = thmc.nuts_chains(logd, inits, gen, num_samples=400,
                               num_warmup=200, max_depth=5)
    assert s.shape == (4, 400, 3)
    assert info["mean_leapfrogs"].shape == (4,)
    # the density is symmetric: every chain's mean near 0
    assert np.abs(s.numpy().mean(1)).max() < 0.3
    samples, info = tinf.sample_chains(_std_normal, _zeros(2), 4,
                                       num_chains=4, method="hmc",
                                       num_samples=500, num_warmup=200)
    assert samples.shape == (4, 500, 2)
    assert info["accept_rate"].shape == (4,)
    assert np.abs(samples.numpy().mean(1)).max() < 0.3


def test_advi_gaussian():
    mu_true = torch.tensor([1.0, -2.0], dtype=torch.float64)
    mu, sigma, elbo = tinf.advi(
        lambda t: -0.5 * ((t - mu_true) ** 2 / 0.25).sum(), _zeros(2), 5,
        num_steps=1500)
    np.testing.assert_allclose(mu.numpy(), [1.0, -2.0], atol=0.1)
    np.testing.assert_allclose(sigma.numpy(), 0.5, atol=0.15)
    assert elbo.shape == (1500,) and elbo[-1] > elbo[0]


def test_smc_evidence_and_posterior():
    def logprior(theta):
        return -0.5 * (theta**2).sum() - 0.5 * np.log(2 * np.pi)

    def loglik(theta):
        return (-0.5 * ((theta - 1.0) ** 2 / 0.25).sum()
                - 0.5 * np.log(2 * np.pi * 0.25))

    gen = torch.Generator().manual_seed(6)
    particles0 = torch.randn((512, 1), generator=gen, dtype=torch.float64)
    particles, log_w, log_z = tinf.smc(logprior, loglik, particles0, 7,
                                       num_steps=15)
    w = torch.softmax(log_w, 0).numpy()
    # analytic posterior: precision 1 + 4 => mean 4/5; evidence N(1; 0, 1.25)
    assert abs(float((particles[:, 0].numpy() * w).sum()) - 0.8) < 0.1
    assert abs(float(log_z) - norm.logpdf(1.0, 0.0, np.sqrt(1.25))) < 0.1


def test_clg_posterior_nuts_concentrates_on_the_reference_mle():
    """test_config5_e2e.py's CLG posterior at a smaller size: the NUTS
    means of Y's blocks within 0.1 of the generator's slope 0.8 and of the
    reference's init, its per-configuration MLE."""
    make_model, _ = MODELS["clg"]
    df = mixed_data(300)
    _, jlay, jinit = jinf.make_logdensity(make_model(jpb), df,
                                          dtype=np.float64)
    tl, _, tinit = tinf.make_logdensity(make_model(tpb), df,
                                        dtype=np.float64)
    tmean = tinf.nuts(tl, tinit, 0, num_samples=100, num_warmup=100,
                      max_depth=4)[0].mean(0).numpy()
    lo, hi, kind = jlay.slices["Y"]
    assert kind == "clg"
    blocks = tmean[lo:hi].reshape(2, 3)
    np.testing.assert_allclose(blocks[:, 1], 0.8, atol=0.1)
    np.testing.assert_allclose(tmean[lo:hi], np.asarray(jinit)[lo:hi],
                               atol=0.1)


def test_sample_chains_sharded_waits_for_item_8():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tinf.sample_chains_sharded(_std_normal, _zeros(2), 0, mesh=None)
