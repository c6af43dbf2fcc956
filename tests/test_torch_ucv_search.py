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
from pybnesian_tpu_torch.ops import nelder_mead as nm
from pybnesian_tpu_torch.ops import ucv_search_kernel as usk
from pybnesian_tpu_torch.runtime.device import use_device

from torch_cpu import _on_the_cpu  # noqa: F401  (autouse)

JAX_CHUNK = 64     # the JAX pair sums want rows padded to their chunk
NPAD = 256


def _problems(B, d, seed=0, ragged=True, diagonal=False, npad=NPAD,
              rows=200, step=17):
    """B problems of a correlated d-column sample, ``rows`` rows each
    (ragged: ``step`` fewer in each later problem), padded with zero rows
    marked invalid, and their normal-reference starts: vech(chol(H)) or
    sqrt(diag(H))."""
    rng = np.random.default_rng(seed)
    mix = np.tril(np.full((d, d), 0.4)) + np.eye(d)
    X = np.zeros((B, npad, d))
    valid = np.zeros((B, npad))
    Ns = np.zeros(B)
    x0 = []
    for b in range(B):
        n = rows - (step * b if ragged else 0)
        x = rng.normal(0.0, 1.0 + 0.2 * b, (n, d)) @ mix.T
        X[b, :n], valid[b, :n], Ns[b] = x, 1.0, n
        knr = (4.0 / (n * (d + 2.0))) ** (2.0 / (d + 4.0))
        H = knr * np.atleast_2d(np.cov(x, rowvar=False))
        x0.append(np.sqrt(np.diag(H)) if diagonal
                  else tucv.vech(np.linalg.cholesky(H)))
    return X, valid, Ns, np.array(x0)


def _tensors(*arrays, dtype=torch.float64):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _search(X, valid, Ns, x0, d, diagonal, max_iter=None,
            dtype=torch.float64):
    Xt, Vt, Nt, x0t = _tensors(X, valid, Ns, x0, dtype=dtype)
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


# ------------------------------------------- what each lane's search needs
def _small(B, d, seed):
    """B problems of 60, 53, 46, ... rows, padded to 64."""
    return _problems(B, d, seed=seed, npad=64, rows=60, step=7)


@pytest.mark.parametrize("B,d,seed", [(3, 1, 70), (4, 2, 71), (5, 1, 72)])
def test_lane_evaluations_are_the_calls_each_lane_needed(monkeypatch, B, d,
                                                         seed):
    """A lane needed a batched call when its value there can change the
    lane's search: the call's values are replaced by -inf (which a needed
    value keeps in the simplex as its best, so the lane ends elsewhere),
    one call at a time, and the lanes whose result moved are counted.
    Frozen lanes, a kept reflection's second point and the shrink calls of
    the lanes that did not shrink must count nothing. In float32, where
    the searches shrink on the objective's plateaus."""
    X, valid, Ns, x0 = _small(B, d, seed)
    max_iter = 25

    def search():
        return _search(X, valid, Ns, x0, d, False, max_iter=max_iter,
                       dtype=torch.float32)

    clean = search()
    guarded, calls = usk._guarded, [0]

    def poisoned(at):
        def wrap(*args):
            out = guarded(*args)
            calls[0] += 1
            return (torch.full_like(out, -np.inf) if calls[0] == at + 1
                    else out)
        return wrap

    monkeypatch.setattr(usk, "_guarded", poisoned(-1))
    search()
    total, needed = calls[0], np.zeros(B, np.int64)
    for at in range(total):
        calls[0] = 0
        monkeypatch.setattr(usk, "_guarded", poisoned(at))
        got = search()
        needed += [not (torch.equal(got.x[b], clean.x[b])
                        and torch.equal(got.f[b], clean.f[b])
                        and int(got.iterations[b]) == int(clean.iterations[b]))
                   for b in range(B)]
    nv = x0.shape[1]
    assert total == int(clean.evaluations) - 1
    np.testing.assert_array_equal(clean.lane_evaluations.numpy(), needed)
    assert bool((clean.lane_evaluations >= nv + 1 + clean.iterations).all())
    assert int(clean.lane_evaluations.sum()) < B * total


def _shrink_rounds(run, lane_max_iters, nv, before):
    """The iterations at which one lane shrank, from its solo runs cut at
    max_iter 1, 2, ... (``before``: its calls before the first iteration):
    an iteration that shrank made nv more calls."""
    out = set()
    for t in range(1, lane_max_iters + 1):
        now = run(t)
        if now - before == 2 + nv:
            out.add(t)
        else:
            assert now - before == 2
        before = now
    return out


def test_evaluations_are_two_a_round_and_nv_a_shrinking_round():
    """The batched count of the plain loop is 1 + (nv + 1) + 2 max_b
    iterations_b + nv |{t : some lane shrank at its iteration t}|, since
    round t is each lane's own iteration t: the rule by which the kernel
    counts them. Lanes 1 and 2 score every point alike, so they shrink at
    each of their iterations, in the same rounds; lanes 0 and 3 are
    quadratics."""
    rng = np.random.default_rng(80)
    B, n = 4, 2
    x0 = torch.as_tensor(rng.normal(1.0, 0.3, (B, n)))
    x0[2] *= 40.0  # a larger simplex: more shrinks before it converges
    centre = torch.as_tensor(rng.normal(0.0, 1.0, (B, n)))
    flat = torch.tensor([False, True, True, False])

    def objective(lanes):
        def f(xs):
            counter[0] += 1
            q = ((xs - centre[lanes]) ** 2).sum(1)
            return torch.where(flat[lanes], torch.zeros_like(q), q)
        return f

    def run(lanes, max_iter):
        counter[0] = 0
        out = nm.nelder_mead_batch_counted(objective(lanes), x0[lanes], 1e-8,
                                           1e-8, max_iter=max_iter)
        return out, counter[0]

    counter = [0]
    (x, f, iters, needed), calls = run(list(range(B)), 60)
    shrunk = [_shrink_rounds(lambda t: run([b], t)[1], int(iters[b]), n,
                             n + 1) for b in range(B)]
    rounds = set().union(*shrunk)
    assert calls == n + 1 + 2 * int(iters.max()) + n * len(rounds)
    assert shrunk[1] & shrunk[2], "no round where two lanes shrank at once"
    assert shrunk[1] == set(range(1, int(iters[1]) + 1))
    for b in range(B):
        solo = run([b], 60)[0]
        assert int(solo[3][0]) == int(needed[b])
    assert bool((needed[1:3] == n + 1 + iters[1:3] * (2 + n)).all())


@pytest.mark.parametrize("seed", [91, 99])
def test_ucv_evaluations_follow_the_lanes_own_rounds(seed):
    """The same identity on UCV problems through ``ucv_search_reference``
    (its count adds 1 for the starts' scores), the shrink rounds read from
    each problem's solo searches (its padded rows alone) cut at max_iter 1,
    2, ... In float32, where the searches shrink on the objective's
    plateaus."""
    d = 1
    X, valid, Ns, x0 = _small(3, d, seed=seed)
    nv, max_iter = x0.shape[1], 20
    got = _search(X, valid, Ns, x0, d, False, max_iter=max_iter,
                  dtype=torch.float32)

    def solo(b):
        return lambda t: int(_search(X[b:b + 1], valid[b:b + 1],
                                     Ns[b:b + 1], x0[b:b + 1], d, False,
                                     max_iter=t,
                                     dtype=torch.float32).evaluations)

    rounds = set().union(*[_shrink_rounds(solo(b), int(got.iterations[b]),
                                          nv, 2 + nv) for b in range(3)])
    assert rounds
    assert int(got.evaluations) == (2 + nv + 2 * int(got.iterations.max())
                                    + nv * len(rounds))


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
    passes its arguments: 5 input pointers, 6 ints, 12 output and scratch
    pointers and the stream; the scratch sizer's; and atomics only where
    the work queue claims an item, publishes a phase, counts items and
    lanes done or sets a shrink flag (and the pair tile's origin row, a
    minimum), never on a value that is summed."""
    text = SOURCE.read_text()
    params = re.search(r'extern "C" int ucv_search_f32\(([^)]*)\)',
                       text).group(1).split(",")
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names == ["X", "valid", "Ns", "x0", "given", "B", "N", "d",
                     "diagonal", "max_iter", "P", "fscratch", "iscratch",
                     "partials", "x_best", "f_out", "f_start", "iters",
                     "evals", "lane_evals", "sums", "white", "stream"]
    kinds = ["p" if "*" in p else "i" for p in params]
    assert kinds == ["p"] * 5 + ["i"] * 6 + ["p"] * 12
    assert re.search(r'extern "C" int ucv_search_scratch\(int B, int N, '
                     r'int d, int diagonal, int P,\s+int max_iter, '
                     r'long long\* sizes\)', text)
    assert _atomics(text) == {
        ("atomicMin", "s_first, row0 + r"),
        ("atomicAdd", "a.queue + b, 1ull"),
        ("atomicExch", "a.queue + b, queue_word(phase_points(a, next) * "
                       "pairs)"),
        ("atomicAdd", "state_of(a, b) + 4, 1"),
        ("atomicSub", "a.live, 1"),
        ("atomicOr", "a.shrunk + t / 32, 1u << (t % 32)")}


def _atomics(text):
    """Each atomic call of ``text``: (function, its arguments)."""
    found = set()
    for m in re.finditer(r"\b(atomic\w+)\(", text):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        found.add((m.group(1), " ".join(text[m.end():i - 1].split())))
    return found


def test_kernel_guard_constant_is_machine_tol():
    """The kernel compares the determinant with MACHINE_TOL rounded to
    float32, as the plain objective does."""
    from pybnesian_tpu_torch.utils import MACHINE_TOL

    text = SOURCE.read_text()
    value = re.search(r"kMachineTol = static_cast<float>\(([^)]*)\)",
                      text).group(1)
    assert eval(value) == MACHINE_TOL
