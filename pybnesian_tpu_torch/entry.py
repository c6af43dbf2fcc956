"""Entry points of the torch port, counterparts of the JAX package's
``__graft_entry__.py``.

``entry()``           — the forward step on the flagship model: the
                        semiparametric-BN per-row log-likelihood of one
                        linear-Gaussian node plus one CKDE node (the KDE
                        kernel on the card), and its inputs.
``dryrun_multichip(n)`` — every multi-device check of the JAX dry run, in
                        its order and at its tolerances, on a (data, fam)
                        mesh over ``n`` devices, at tiny shapes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry():
    """``(spbn_forward, args)``: the forward function and its float32
    inputs on the default device (the card unless the caller chose the
    CPU); ``spbn_forward(*args)`` is the (256,) per-row log-likelihood."""
    from .ops.gaussian import lg_logl
    from .ops.kde import kde_conditional_logsumexp
    from .runtime.device import host_to_device

    n_train, m_test = 256, 256

    def spbn_forward(lg_y, lg_X, beta, variance, joint_tr, joint_te, marg_tr,
                     marg_te, jln, mln):
        """Per-row SPBN logl: one LinearGaussian node + one CKDE node."""
        ll_lg = lg_logl(lg_y, lg_X, beta, variance)
        ll_ckde = kde_conditional_logsumexp(
            joint_tr, joint_te, marg_tr, marg_te, jln, mln
        )
        return ll_lg + ll_ckde

    rng = np.random.default_rng(0)
    dtype = np.float32
    args = tuple(host_to_device(a, dtype) for a in (
        rng.normal(size=m_test),
        rng.normal(size=(m_test, 2)),
        np.array([0.1, 0.5, -0.3]),
        np.array(0.8),
        rng.normal(size=(n_train, 2)),
        rng.normal(size=(m_test, 2)),
        rng.normal(size=(n_train, 1)),
        rng.normal(size=(m_test, 1)),
        np.array(-1.2),
        np.array(-0.7),
    ))
    return spbn_forward, args


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _close(got, want, rtol, atol, what):
    got = got.detach().double().cpu().numpy()
    want = want.detach().double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The JAX dry run's checks (``__graft_entry__.py``), in order, on a
    (data, fam) mesh of ``n_devices`` taken from ``devices`` (default: the
    visible cards, or the CPU under ``use_device("cpu")``; repeat a device
    for virtual shards, e.g. ``[torch.device("cuda:0")] * 8``):

    (a) ``sharded_lg_fit`` + ``sharded_batched_bic`` against a 1×1 mesh;
    (b) ``sharded_kde_slogl`` against one shard;
    (c) ``sharded_ckde_cv`` against the serial call on one device;
    (d) ``sample_chains_sharded`` NUTS, 1 and 2 chains per device, each
        shard against ``nuts_chains`` on its own chains and generator;
    (e) RCoT's ``fused_z`` with its lanes split over ``fam`` against one
        call on all lanes;
    (f) ``ucv_minimize_batch`` with its problems split over ``fam``
        against one batch.

    For (e) and (f) the JAX dry run lets GSPMD carry the input shardings
    through one call; the port has no sharding propagation, so it slices
    the lane (problem) axis over the ``fam`` devices, runs each slice on
    its device and concatenates: a check that lanes are independent.
    Raises ``AssertionError`` on the first check that fails."""
    from .inference.hmc import _shard_draws, nuts_chains, sample_chains_sharded
    from .kde.ucv import ucv_minimize_batch
    from .learning.independences.rcot import fused_z
    from .ops.kde import (ckde_cv_alldevice, ckde_cv_alldevice_flash,
                          kernel_route)
    from .parallel import (data_fam_mesh, sharded_batched_bic,
                           sharded_ckde_cv, sharded_kde_slogl, sharded_lg_fit)
    from .runtime.device import visible_devices

    devices = list(devices) if devices is not None else visible_devices()
    fam_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = data_fam_mesh(n_devices, fam=fam_axis, devices=devices)
    mesh1 = data_fam_mesh(1, fam=1, devices=devices[:1])
    data_axis = mesh.shape["data"]
    home = mesh.home

    def on(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=home)

    rng = np.random.default_rng(0)
    # (a) data-parallel MLE fit + candidate scoring against a 1x1 mesh
    n_rows, D, P = 16 * data_axis, 4, 2
    F = 4 * fam_axis
    values = on(rng.normal(size=(n_rows, D)))
    valid = on(np.ones((n_rows, D)))
    var_idx = on(np.arange(F) % D, torch.long)
    parent_idx = on(np.stack([(np.arange(F) + 1) % D,
                              (np.arange(F) + 2) % D], 1), torch.long)
    parent_mask = on(np.ones((F, P)))
    fam_args = (values, valid, var_idx, parent_idx, parent_mask)
    betas, variances = sharded_lg_fit(mesh, *fam_args)
    scores = sharded_batched_bic(mesh, *fam_args)
    _check(betas.shape == (F, P + 1) and variances.shape == (F,)
           and scores.shape == (F,), "(a) shapes")
    _check(bool(torch.all(torch.isfinite(scores))), "(a) finite scores")
    betas1, variances1 = sharded_lg_fit(mesh1, *fam_args)
    scores1 = sharded_batched_bic(mesh1, *fam_args)
    _close(betas, betas1, 1e-4, 1e-5, "(a) betas")
    _close(variances, variances1, 1e-4, 1e-5, "(a) variances")
    _close(scores, scores1, 1e-4, 1e-4, "(a) scores")

    # (b) KDE slogl, training axis over 'data', against one shard
    train_white = on(rng.normal(size=(16 * data_axis, 2)))
    test_white = on(rng.normal(size=(8, 2)))
    sll = sharded_kde_slogl(mesh, train_white, test_white, -1.0)
    _check(bool(torch.isfinite(sll)), "(b) finite slogl")
    sll1 = sharded_kde_slogl(mesh1, train_white, test_white, -1.0)
    _close(sll, sll1, 1e-5, 0.0, "(b) kde slogl")

    # (c) CV-likelihood CKDE scoring, families over 'fam', against the
    # serial call on the home device (the same route)
    n, D, K, ntr, nte = 64, 3, 2, 48, 16
    kdata = on(rng.normal(size=(n, D)))
    knull = on(np.zeros((n, D)))
    Fk = max(2 * fam_axis, 2)
    ck_idx = np.zeros((Fk, 2), np.int64)
    ck_mask = np.zeros((Fk, 2))
    for f in range(Fk):
        ck_idx[f, 0] = f % D
        ck_mask[f, 0] = 1.0
        if f % 2:
            ck_idx[f, 1] = (f + 1) % D
            ck_mask[f, 1] = 1.0
    cv_args = (
        kdata, knull, on(ck_idx, torch.long), on(ck_mask),
        on(np.stack([np.arange(ntr), np.arange(n - ntr, n)]), torch.long),
        on(np.ones((K, ntr))),
        on(np.stack([np.arange(n - nte, n), np.arange(nte)]), torch.long),
        on(np.ones((K, nte))),
    )
    sharded = sharded_ckde_cv(mesh, *cv_args)
    serial = (ckde_cv_alldevice_flash if kernel_route(kdata)
              else ckde_cv_alldevice)(*cv_args)
    _check(sharded.shape == (Fk,) and bool(torch.all(torch.isfinite(sharded))),
           "(c) finite scores of every family")
    _close(sharded, serial, 1e-5, 1e-5, "(c) sharded ckde cv")

    # (d) NUTS chains over 'data', 1 and 2 chains per device: each shard
    # against nuts_chains on its own chains and generator
    def logdensity(theta):
        return -0.5 * torch.sum(torch.square(theta))

    init = on(np.zeros(2))
    nuts_kw = dict(num_samples=4, num_warmup=4, max_depth=4)
    for cpd in (1, 2):
        samples, _ = sample_chains_sharded(
            logdensity, init, 0, mesh, axis="data", chains_per_device=cpd,
            method="nuts", **nuts_kw)
        _check(samples.shape == (data_axis * cpd, 4, 2)
               and bool(torch.all(torch.isfinite(samples))),
               f"(d) {cpd} chains per device: shape and finite samples")
        inits, seeds = _shard_draws(init, 0, data_axis * cpd, data_axis)
        for s in range(data_axis):
            gen = torch.Generator(device=home).manual_seed(seeds[s])
            one, _ = nuts_chains(logdensity, inits[s * cpd: (s + 1) * cpd],
                                 gen, **nuts_kw)
            _close(samples[s * cpd: (s + 1) * cpd], one, 1e-4, 1e-5,
                   f"(d) NUTS shard {s}, {cpd} chains per device")

    fam_devices = list(mesh.devices[0])

    def split(a, j):
        step = a.shape[0] // fam_axis
        return a[j * step: (j + 1) * step]

    # (e) the fused RCoT conditional batch, lanes over 'fam'
    B = 2 * fam_axis
    nr, Cc, fxy, fzn, dz = 32, 4, 3, 4, 2
    rdata = rng.normal(size=(nr, Cc))
    xc = np.arange(B) % Cc
    yc = (np.arange(B) + 1) % Cc
    zc = np.stack([(np.arange(B) + 2) % Cc, (np.arange(B) + 3) % Cc], 1)
    Wx = rng.normal(size=(B, fxy))
    bx = rng.uniform(0, 6.28, size=(B, fxy))
    Wy = rng.normal(size=(B, fxy))
    by = rng.uniform(0, 6.28, size=(B, fxy))
    Wz = rng.normal(size=(B, dz, fzn))
    bz = rng.uniform(0, 6.28, size=(B, fzn))
    lanes = (xc, Wx, bx, yc, Wy, by, zc, Wz, bz)
    kinds = (torch.long, torch.float32, torch.float32) * 2 + (
        torch.long, torch.float32, torch.float32)

    def rcot_on(device, part):
        ts = [torch.as_tensor(a, dtype=k, device=device)
              for a, k in zip(part, kinds)]
        data = torch.as_tensor(rdata, dtype=torch.float32, device=device)
        return fused_z(data, *ts)

    sta_r, eig_r = rcot_on(home, lanes)
    parts = [rcot_on(d, [split(a, j) for a in lanes])
             for j, d in enumerate(fam_devices)]
    sta_s = torch.cat([s.to(home) for s, _ in parts])
    eig_s = torch.cat([e.to(home) for _, e in parts])
    _close(sta_s, sta_r, 2e-4, 1e-5, "(e) RCoT statistics")
    _close(torch.sort(eig_s, dim=-1).values, torch.sort(eig_r, dim=-1).values,
           2e-3, 1e-4, "(e) RCoT eigenvalues")

    # (f) the lane-batched UCV Nelder-Mead, problems over 'fam'
    Bu = 2 * fam_axis
    npad, du = 32, 2
    Xu = rng.normal(size=(Bu, npad, du)).astype(np.float32)
    Vu = np.ones((Bu, npad), np.float32)
    Nu = np.full(Bu, npad, np.float32)
    x0u = np.tile(np.array([0.8, 0.1, 0.7], np.float32), (Bu, 1))
    problems = (Xu, Vu, Nu, x0u)
    ref = ucv_minimize_batch(*problems, du, dtype=np.float32, device=home)
    sh = np.concatenate([
        ucv_minimize_batch(*[split(a, j) for a in problems], du,
                           dtype=np.float32, device=d)
        for j, d in enumerate(fam_devices)])
    np.testing.assert_allclose(sh, ref, rtol=5e-4, atol=5e-5,
                               err_msg="(f) UCV Nelder-Mead")
