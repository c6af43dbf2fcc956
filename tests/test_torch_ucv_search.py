"""The UCV bandwidth search of the torch port, on the CPU: the wrapper of
the one-launch search kernel, its plain version, and the plain version
against the JAX package's ``ucv_minimize_batch``.

Float64 inputs made from a numpy seed. The kernel itself runs only on the
card (tests/test_torch_ucv_search_cuda.py); here a CPU tensor takes the
plain version, the host loop of ``nelder_mead_batch`` over the guarded UCV
objective.

Tolerances: a problem searched alone and inside a padded batch gives the
same values to 1e-12 relative (the same float64 operations, the padding
adding exact zeros to the pair sums); against the JAX package, which sums
the pairs in another form, f best to 1e-6 relative, the optima to 1e-5
or, should the two searches branch apart, to an objective within 1e-6.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybnesian_tpu.kde import ucv as jucv
from pybnesian_tpu_torch.kde import ucv as tucv
from pybnesian_tpu_torch.ops import ucv_search_kernel as usk
from pybnesian_tpu_torch.runtime.device import use_device

from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

JAX_CHUNK = 64     # the JAX pair sums want rows padded to their chunk
NPAD = 256


def _problems(B, d, seed=0, ragged=True, diagonal=False, npad=NPAD):
    """B problems of a correlated d-column sample, ~200 rows each (ragged:
    fewer in later problems), padded with zero rows marked invalid, and
    their normal-reference starts: vech(chol(H)) or sqrt(diag(H))."""
    rng = np.random.default_rng(seed)
    mix = np.tril(np.full((d, d), 0.4)) + np.eye(d)
    X = np.zeros((B, npad, d))
    valid = np.zeros((B, npad))
    Ns = np.zeros(B)
    x0 = []
    for b in range(B):
        n = 200 - (17 * b if ragged else 0)
        x = rng.normal(0.0, 1.0 + 0.2 * b, (n, d)) @ mix.T
        X[b, :n], valid[b, :n], Ns[b] = x, 1.0, n
        knr = (4.0 / (n * (d + 2.0))) ** (2.0 / (d + 4.0))
        H = knr * np.atleast_2d(np.cov(x, rowvar=False))
        x0.append(np.sqrt(np.diag(H)) if diagonal
                  else tucv.vech(np.linalg.cholesky(H)))
    return X, valid, Ns, np.array(x0)


def _tensors(*arrays, dtype=torch.float64):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _search(X, valid, Ns, x0, d, diagonal, max_iter=None):
    Xt, Vt, Nt, x0t = _tensors(X, valid, Ns, x0)
    return usk.ucv_search_reference(
        Xt, Vt, Nt, x0t, d, diagonal,
        200 * x0.shape[1] if max_iter is None else max_iter)


# ------------------------------------------------------------- the wrapper
def test_cpu_tensors_take_the_plain_version():
    X, valid, Ns, x0 = _problems(3, 2, seed=1)
    args = _tensors(X, valid, Ns, x0, dtype=torch.float32)
    before = usk.ucv_search_cuda.launches
    got = usk.ucv_search_cuda(*args, 2, False, 40)
    want = usk.ucv_search_reference(*args, 2, False, 40)
    assert usk.ucv_search_cuda.launches == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.device.type == "cpu"
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got.x.dtype == torch.float32
    assert got.iterations.dtype == torch.int32


def test_cpu_evaluate_takes_the_plain_objective():
    X, valid, Ns, x0 = _problems(2, 3, seed=2)
    X, valid, Ns, x0 = _tensors(X, valid, Ns, x0, dtype=torch.float32)
    points = torch.stack([0.8 * x0, 1.3 * x0], 1).contiguous()
    f, sums, W = usk.ucv_search_evaluate(X, valid, Ns, x0, points, 3, False,
                                         white=True)
    want = usk.ucv_objective_reference(X, valid, Ns, x0, points, 3, False)
    torch.testing.assert_close(f, want, rtol=0, atol=0)
    assert sums.shape == (2, 2, 2) and W.shape == (2, 2, NPAD, 3)
    from pybnesian_tpu_torch.ops.kde import ucv_pair_sums_batch
    s2h, sh = ucv_pair_sums_batch(W[:, 1].contiguous(), valid)
    torch.testing.assert_close(sums[:, 1, 0], s2h, rtol=0, atol=0)
    torch.testing.assert_close(sums[:, 1, 1], sh, rtol=0, atol=0)


def _bad_args(case):
    X, valid, Ns, x0 = _tensors(*_problems(2, 2, seed=3), dtype=torch.float32)
    if case == "float64":
        X = X.double()
    elif case == "x0-shape":
        x0 = x0[:, :2].contiguous()
    elif case == "valid-shape":
        valid = valid[:, :10].contiguous()
    elif case == "not-contiguous":
        X = X.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "width":
        X = X[..., :1].contiguous()
    elif case == "meta-device":
        X, valid, Ns, x0 = (t.to("meta") for t in (X, valid, Ns, x0))
    elif case == "mixed-devices":
        Ns = Ns.to("meta")
    elif case == "not-a-tensor":
        x0 = x0.numpy()
    return X, valid, Ns, x0


@pytest.mark.parametrize("case", ["float64", "x0-shape", "valid-shape",
                                  "not-contiguous", "width", "meta-device",
                                  "mixed-devices", "not-a-tensor"])
def test_wrapper_argument_checks(case):
    """A wrong dtype, shape, layout or device raises before any launch;
    a device that is neither the CPU nor a GPU raises too."""
    args = _bad_args(case)
    error = TypeError if case == "not-a-tensor" else ValueError
    with pytest.raises(error):
        usk.ucv_search_cuda(*args, 2, False, 10)


class _Recorder:
    def __init__(self, name, real):
        self.name, self.real, self.calls = name, real, []

    def __call__(self, *args):
        self.calls.append(self.name)
        return self.real(*args)


@pytest.mark.parametrize("routed", [False, True])
def test_minimize_routes_by_kernel_route(monkeypatch, routed):
    """``_minimize`` takes the kernel exactly when ``kernel_route`` says so
    (a float32 tensor on a GPU): here the rule is forced both ways on CPU
    tensors, whose wrapper then runs the plain version itself."""
    kernel = _Recorder("kernel", usk.ucv_search_cuda)
    plain = _Recorder("plain", usk.ucv_search_reference)
    monkeypatch.setattr(tucv, "ucv_search_cuda", kernel)
    monkeypatch.setattr(tucv, "ucv_search_reference", plain)
    monkeypatch.setattr(tucv, "kernel_route", lambda t: routed)
    X, valid, Ns, x0 = _problems(2, 2, seed=4)
    X, valid, Ns = _tensors(X, valid, Ns, dtype=torch.float32)
    search = tucv._minimize(X, valid, Ns, x0, 2, False)
    assert kernel.calls + plain.calls == ["kernel" if routed else "plain"]
    assert search.dtype == "float32" and search.x.shape == (2, 3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_searches_take_the_plain_loop(monkeypatch, dtype):
    """On CPU tensors ``kernel_route`` is False for either dtype."""
    plain = _Recorder("plain", usk.ucv_search_reference)
    monkeypatch.setattr(tucv, "ucv_search_reference", plain)
    X, valid, Ns, x0 = _problems(2, 1, seed=5)
    search = tucv.ucv_search_batch(X, valid, Ns, x0, 1, dtype=dtype,
                                   device="cpu")
    assert plain.calls == ["plain"]
    assert search.dtype == np.dtype(dtype).name


def test_no_gpu_and_no_choice_raises():
    """The CPU is the caller's choice: with nothing chosen and no GPU, a
    search raises rather than moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the search would run on it")
    X, valid, Ns, x0 = _problems(1, 1, seed=6)
    with use_device(None):
        with pytest.raises(RuntimeError, match="GPU"):
            tucv.ucv_search_batch(X, valid, Ns, x0, 1)


def test_minimize_keeps_the_result_of_the_plain_search():
    """The host record of ``_minimize``: the plain search's optima,
    iterations and evaluations, read back as they are."""
    X, valid, Ns, x0 = _problems(3, 2, seed=7)
    search = tucv._minimize(*_tensors(X, valid, Ns), x0, 2, False)
    want = _search(X, valid, Ns, x0, 2, False)
    np.testing.assert_array_equal(search.x, want.x.numpy())
    np.testing.assert_array_equal(search.iterations,
                                  want.iterations.numpy())
    assert search.evaluations == int(want.evaluations)


# ---------------------------------------------------------- the plain search
CASES = [(d, diagonal) for d in (1, 2, 3) for diagonal in (False, True)
         if not (d == 1 and diagonal)]


@pytest.mark.parametrize("d,diagonal", CASES)
def test_plain_search_alone_and_in_a_padded_batch(d, diagonal):
    """Each of 4 ragged problems, searched alone on its own rows, gives
    what it gives inside the padded batch: its x, f, start score and
    iterations."""
    X, valid, Ns, x0 = _problems(4, d, seed=10 + d, diagonal=diagonal)
    batch = _search(X, valid, Ns, x0, d, diagonal)
    for b in range(4):
        n = int(Ns[b])
        one = _search(X[b:b + 1, :n], np.ones((1, n)), Ns[b:b + 1],
                      x0[b:b + 1], d, diagonal)
        for g, w in ((one.x[0], batch.x[b]), (one.f[0], batch.f[b]),
                     (one.start[0], batch.start[b])):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                       atol=0)
        assert int(one.iterations[0]) == int(batch.iterations[b])
    assert bool((batch.f <= batch.start).all())
    assert bool((batch.iterations > 0).all())


def test_nan_start_is_done_at_once():
    """A problem whose start scores NaN (a NaN row) takes no iteration and
    keeps its start, and the others search as they do without it."""
    X, valid, Ns, x0 = _problems(3, 2, seed=20)
    X[1, 5, 0] = np.nan
    got = _search(X, valid, Ns, x0, 2, False)
    assert int(got.iterations[1]) == 0 and bool(got.start[1].isnan())
    np.testing.assert_array_equal(got.x[1].numpy(), x0[1])
    keep = [0, 2]
    rest = _search(X[keep], valid[keep], Ns[keep], x0[keep], 2, False)
    np.testing.assert_array_equal(got.x[keep].numpy(), rest.x.numpy())
    np.testing.assert_array_equal(got.iterations[keep].numpy(),
                                  rest.iterations.numpy())


@pytest.mark.parametrize("max_iter", [1, 2, 5])
def test_evaluations_count_the_plain_loop(max_iter):
    """1 for the starts, nv + 1 for the simplex, 2 an iteration and nv more
    in an iteration where some problem shrinks; no problem passes
    ``max_iter``."""
    X, valid, Ns, x0 = _problems(3, 2, seed=30)
    got = _search(X, valid, Ns, x0, 2, False, max_iter=max_iter)
    nv = x0.shape[1]
    iters = int(got.iterations.max())
    assert iters == max_iter
    extra = int(got.evaluations) - (1 + nv + 1) - 2 * iters
    assert extra >= 0 and extra % nv == 0


# ----------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def jax_optima():
    """The JAX package's ``ucv_minimize_batch`` once per width: it rebuilds
    and recompiles its jitted search on every call."""
    out = {}
    for d in (1, 2, 3):
        X, valid, Ns, x0 = _problems(3, d, seed=40 + d)
        out[d] = np.asarray(jucv.ucv_minimize_batch(
            jnp.asarray(X), jnp.asarray(valid), jnp.asarray(Ns),
            jnp.asarray(x0), d, chunk=JAX_CHUNK))
    return out


@pytest.mark.parametrize("d", [1, 2, 3])
def test_plain_search_matches_jax(jax_optima, d):
    X, valid, Ns, x0 = _problems(3, d, seed=40 + d)
    got = _search(X, valid, Ns, x0, d, False)
    # the JAX function returns the optima alone (the start where it did
    # not improve), so its f best is the objective at its optimum
    assert bool((got.f <= got.start).all())
    want_x = jax_optima[d]
    want_f = usk.ucv_objective_reference(
        *_tensors(X, valid, Ns, x0), torch.as_tensor(want_x)[:, None], d,
        False)[:, 0]
    np.testing.assert_allclose(got.f.numpy(), want_f.numpy(), rtol=1e-6)
    for b in range(3):
        if not np.allclose(got.x[b].numpy(), want_x[b], rtol=1e-5, atol=0):
            assert abs(float(got.f[b]) - float(want_f[b])) <= (
                1e-6 * abs(float(want_f[b])))


# ------------------------------------------------------- the C entry point
SOURCE = (Path(usk.__file__).resolve().parent.parent / "csrc"
          / "ucv_pairs.cu")


def test_search_entry_point_matches_the_binding():
    """The C signature of ``ucv_search_f32``, in the order ``_launch``
    passes its arguments: 5 input pointers, 6 ints, 11 output and scratch
    pointers and the stream; the scratch sizer's; and no atomic anywhere
    in the source (the flags and counts are written by one thread each)."""
    text = SOURCE.read_text()
    params = re.search(r'extern "C" int ucv_search_f32\(([^)]*)\)',
                       text).group(1).split(",")
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names == ["X", "valid", "Ns", "x0", "given", "B", "N", "d",
                     "diagonal", "max_iter", "P", "fscratch", "iscratch",
                     "partials", "x_best", "f_out", "f_start", "iters",
                     "evals", "sums", "white", "stream"]
    kinds = ["p" if "*" in p else "i" for p in params]
    assert kinds == ["p"] * 5 + ["i"] * 6 + ["p"] * 11
    assert re.search(r'extern "C" int ucv_search_scratch\(int B, int N, '
                     r'int d, int diagonal, int P,\s+long long\* sizes\)',
                     text)
    assert "atomicAdd" not in text and "atomicCAS" not in text


def test_kernel_guard_constant_is_machine_tol():
    """The kernel compares the determinant with MACHINE_TOL rounded to
    float32, as the plain objective does."""
    from pybnesian_tpu_torch.utils import MACHINE_TOL

    text = SOURCE.read_text()
    value = re.search(r"kMachineTol = static_cast<float>\(([^)]*)\)",
                      text).group(1)
    assert eval(value) == MACHINE_TOL
