"""The port's multi-device layer against the JAX package, on the CPU.

Each ``sharded_*`` of ``pybnesian_tpu_torch.parallel`` against the JAX
function on the same numpy inputs made from a seed: the JAX side on
``make_mesh({"data": 4, "fam": 2})`` over the eight virtual CPU devices
(tests/conftest.py), the port on the same shape over eight virtual shards
of the CPU (``devices=[cpu] * 8``). Float64 within rtol 1e-9 / atol 1e-7,
float32 within 5e-4 / 5e-3 (the sums over ``data`` run in another order
than JAX's ``psum``). Each JAX function is jitted once per module and
dtype: run eagerly, ``shard_map`` costs ~10 s a call here.

Also: the 1×1 mesh, the divisibility errors, ``sample_chains_sharded``
(shapes and info keys as JAX's, each shard bit for bit its own
``nuts_chains`` run), ``entry()`` against the JAX ``entry()`` and the dry
run on the CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pybnesian_tpu import parallel as jpar
from pybnesian_tpu.inference import sample_chains_sharded as j_sharded_chains
from pybnesian_tpu_torch import parallel as tpar
from pybnesian_tpu_torch.entry import dryrun_multichip, entry
from pybnesian_tpu_torch.inference.hmc import (nuts_chains,
                                               sample_chains_sharded)

from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

TOL = {"float64": dict(rtol=1e-9, atol=1e-7),
       "float32": dict(rtol=5e-4, atol=5e-3)}
CPU8 = [torch.device("cpu")] * 8
DTYPES = ("float64", "float32")


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX functions on a (data 4, fam 2) mesh, each jitted once."""
    mesh = jpar.make_mesh({"data": 4, "fam": 2})
    return {
        "fit_bic": jax.jit(lambda *a: (jpar.sharded_lg_fit(mesh, *a),
                                       jpar.sharded_batched_bic(mesh, *a))),
        "ckde_cv": jax.jit(lambda *a: jpar.sharded_ckde_cv(mesh, *a,
                                                            chunk=16)),
        "kde_slogl": jax.jit(lambda *a: jpar.sharded_kde_slogl(mesh, *a)),
    }


def _mesh(**axes):
    return tpar.make_mesh(axes or {"data": 4, "fam": 2}, devices=CPU8)


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got.detach().numpy(), np.float64),
                               np.asarray(want, np.float64), **TOL[dtype])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _family_inputs(dtype, n=64, D=5, F=6, P=2, seed=0):
    """n rows of D columns with ~10% nulls (validity 0), F families of up
    to P parents, one evidence-free."""
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n, D)) @ rng.normal(size=(D, D))
    valid = (rng.random((n, D)) > 0.1).astype(dtype)
    var_idx = np.arange(F, dtype=np.int32) % D
    parent_idx = np.stack([(np.arange(F) + 1) % D, (np.arange(F) + 3) % D],
                          1).astype(np.int32)
    parent_mask = np.ones((F, P), dtype)
    parent_mask[0] = 0.0
    parent_mask[1, 1] = 0.0
    return (values.astype(dtype), valid, var_idx, parent_idx, parent_mask)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_fit_and_bic_match_jax(jax_fns, dtype):
    args = _family_inputs(dtype)
    (jbeta, jvar), jbic = jax_fns["fit_bic"](*map(jnp.asarray, args))
    mesh = _mesh()
    beta, var = tpar.sharded_lg_fit(mesh, *map(_t, args))
    bic = tpar.sharded_batched_bic(mesh, *map(_t, args))
    assert beta.dtype == var.dtype == bic.dtype == getattr(torch, dtype)
    assert bool(torch.all(torch.isfinite(bic)))
    _close(beta, jbeta, dtype)
    _close(var, jvar, dtype)
    _close(bic, jbic, dtype)


def _cv_inputs(dtype, n=120, D=3, K=3, F=4, seed=1):
    """config 6's layout (benchmarks/config6_scaling.py make_inputs) at a
    small size: folds padded to a multiple of 8 rows with masked rows, a
    few nulls, families of 0 and 1 parents, evidence first."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, D))
    null = (rng.random((n, D)) < 0.03).astype(dtype)
    data[null > 0] = 0.0
    folds = np.array_split(rng.permutation(n), K)
    ntr, nte = 88, 48
    tr_idx = np.zeros((K, ntr), np.int32)
    tr_mask = np.zeros((K, ntr), dtype)
    te_idx = np.zeros((K, nte), np.int32)
    te_mask = np.zeros((K, nte), dtype)
    for k in range(K):
        tr = np.concatenate([folds[j] for j in range(K) if j != k])
        tr_idx[k, : len(tr)] = tr
        tr_mask[k, : len(tr)] = 1.0
        te_idx[k, : len(folds[k])] = folds[k]
        te_mask[k, : len(folds[k])] = 1.0
    col_idx = np.zeros((F, 2), np.int32)
    col_mask = np.zeros((F, 2), dtype)
    for f in range(F):
        col_mask[f, 0] = 1.0
        col_idx[f, 0] = f % D
        if f % 2:
            col_idx[f] = [(f + 1) % D, f % D]
            col_mask[f, 1] = 1.0
    return (data.astype(dtype), null, col_idx, col_mask, tr_idx, tr_mask,
            te_idx, te_mask)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_ckde_cv_matches_jax(jax_fns, dtype):
    args = _cv_inputs(dtype)
    want = jax_fns["ckde_cv"](*map(jnp.asarray, args))
    got = tpar.sharded_ckde_cv(_mesh(), *map(_t, args))
    assert got.shape == (4,) and bool(torch.all(torch.isfinite(got)))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_kde_slogl_matches_jax(jax_fns, dtype):
    rng = np.random.default_rng(2)
    train = rng.normal(0, 2, (64, 2)).astype(dtype)
    test = rng.normal(0, 2, (16, 2)).astype(dtype)
    lognorm = np.asarray(-1.0, dtype)
    want = jax_fns["kde_slogl"](jnp.asarray(train), jnp.asarray(test),
                                jnp.asarray(lognorm))
    got = tpar.sharded_kde_slogl(_mesh(), _t(train), _t(test), _t(lognorm))
    _close(got, want, dtype)


def test_one_by_one_mesh_equals_the_sharded_mesh():
    one = tpar.data_fam_mesh(1, fam=1)
    assert one.shape == {"data": 1, "fam": 1}
    assert list(one.devices.flat) == [torch.device("cpu")]
    args = tuple(map(_t, _family_inputs("float64")))
    np.testing.assert_allclose(tpar.sharded_batched_bic(one, *args),
                               tpar.sharded_batched_bic(_mesh(), *args),
                               **TOL["float64"])
    rng = np.random.default_rng(3)
    train, test = _t(rng.normal(size=(64, 2))), _t(rng.normal(size=(9, 2)))
    np.testing.assert_allclose(
        float(tpar.sharded_kde_slogl(one, train, test, -1.0)),
        float(tpar.sharded_kde_slogl(_mesh(), train, test, -1.0)),
        **TOL["float64"])


def test_mesh_layout_and_errors():
    mesh = _mesh()
    assert mesh.shape == {"data": 4, "fam": 2}
    assert mesh.axis_names == ("data", "fam") and mesh.size == 8
    # no repeated device unless the caller lists it
    with pytest.raises(ValueError, match="only 1 available"):
        tpar.make_mesh({"data": 2})
    with pytest.raises(ValueError, match="fam axis must divide"):
        tpar.data_fam_mesh(3, fam=2, devices=CPU8)
    values, valid, vi, pi, pm = map(_t, _family_inputs("float64", n=62))
    with pytest.raises(ValueError, match="62 rows do not divide"):
        tpar.sharded_batched_bic(mesh, values, valid, vi, pi, pm)
    values, valid, vi, pi, pm = map(_t, _family_inputs("float64", F=5))
    with pytest.raises(ValueError, match="5 families do not divide"):
        tpar.sharded_lg_fit(mesh, values, valid, vi, pi, pm)
    args = list(map(_t, _cv_inputs("float64")))
    args[2], args[3] = args[2][:3], args[3][:3]
    with pytest.raises(ValueError, match="3 families do not divide"):
        tpar.sharded_ckde_cv(mesh, *args)
    with pytest.raises(ValueError, match="63 training rows"):
        tpar.sharded_kde_slogl(mesh, torch.zeros(63, 2), torch.zeros(4, 2),
                               0.0)


def _logdensity(theta):
    return -0.5 * torch.sum(torch.square(theta - 1.0))


@pytest.mark.parametrize("method,cpd", [("nuts", 1), ("nuts", 2),
                                        ("hmc", 2)])
def test_sample_chains_sharded(method, cpd):
    """Shapes and info keys as JAX's (traced, not run); each shard equals
    its own sampler call on the draws the docstring's rule gives."""
    kw = dict(num_samples=5, num_warmup=5)
    kw["max_depth" if method == "nuts" else "num_leapfrog"] = 3
    jmesh = jpar.make_mesh({"data": 4, "fam": 2})
    jshape = jax.eval_shape(lambda: j_sharded_chains(
        lambda t: -0.5 * jnp.sum(jnp.square(t - 1.0)), jnp.zeros(3),
        jax.random.PRNGKey(0), jmesh, chains_per_device=cpd, method=method,
        **kw))
    init = torch.zeros(3, dtype=torch.float64)
    samples, info = sample_chains_sharded(
        _logdensity, init, 7, _mesh(), chains_per_device=cpd, method=method,
        **kw)
    assert tuple(samples.shape) == jshape[0].shape == (4 * cpd, 5, 3)
    assert set(info) == set(jshape[1])
    for k, v in info.items():
        assert tuple(v.shape) == jshape[1][k].shape, k

    gen = torch.Generator().manual_seed(7)
    inits = init + 0.1 * torch.randn((4 * cpd, 3), generator=gen,
                                     dtype=init.dtype)
    seeds = torch.randint(0, 2**62, (4,), generator=gen).tolist()
    for s in range(4):
        chains = inits[s * cpd: (s + 1) * cpd]
        shard_gen = torch.Generator().manual_seed(seeds[s])
        if method == "nuts":
            want = nuts_chains(_logdensity, chains, shard_gen, **kw)[0]
        else:
            from pybnesian_tpu_torch.inference import hmc

            want = torch.stack([hmc(_logdensity, c, shard_gen, **kw)[0]
                                for c in chains])
        assert torch.equal(samples[s * cpd: (s + 1) * cpd], want), s


def test_entry_matches_jax():
    jfn, jargs = graft.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = entry()
    assert all(a.device.type == "cpu" and a.dtype == torch.float32
               for a in args)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    assert got.shape == (256,)
    _close(got, want, "float32")


@pytest.mark.parametrize("n_devices", [1, 8])
def test_dryrun_multichip_on_the_cpu(n_devices):
    devices = CPU8 if n_devices == 8 else None  # 1: the default device
    dryrun_multichip(n_devices, devices=devices)
