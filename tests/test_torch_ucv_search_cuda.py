"""The UCV search kernel (``ucv_search_cuda``: the whole Nelder–Mead search
of a batch in one launch) against its plain version, the host loop of
``ucv_search_reference``, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package (``--noconftest`` skips
tests/conftest.py, which sets up JAX):

    python -m pytest --noconftest tests/test_torch_ucv_search_cuda.py -q

The gates, at d 1, 2, 3, 5 and 17 (17: the runtime-width path), B 1, 10
and 30, ragged row counts and invalid padding rows:

1. one evaluation: the kernel's objective at given points within 1e-5
   relative of the plain objective (float32 on both sides; the plain
   version rounds the kernel's operations in the kernel's order, so on an
   H100 the two have given the same bits), and its pair sums on its own
   whitened rows the same bits as ``ucv_pair_sums_cuda``'s;
2. ``max_iter`` 1, 2, 3, 5: the best x and f within 1e-5 relative of the
   plain loop's, and the same iterations;
3. the whole search, per problem: f best at most the plain search's f best
   plus that problem's ``fatol``, and never above its start (at d 17 in
   the diagonal form: 17 coordinates, where the full form's 153 make the
   plain loop minutes long);
4. the CV scores of the kernel's bandwidths within 1e-4 of those of the
   plain search's;
5. a problem alone and inside the batch gives the same bits of x and f
   and the same iterations; two runs give the same bits.

And a problem whose start scores NaN takes no iteration. Below the
normal-reference bandwidth (four clusters far apart, where the UCV
optimum lies at a small fraction of it), the kernel's evaluations at the
points the search visits hold to 1e-5 of the float64 plain objective.

The schedule: the kernel's lanes move on through a work queue, each at
its own pace, so the last group holds whole searches to the plain loop's
bits (x, f, start, iterations, the batched ``evaluations`` and each
problem's ``lane_evaluations``), alone against in the batch, where the
lanes finish far apart: a NaN start, a lane that starts far below the
normal-reference bandwidth, shrinks at each iteration and converges
within its first few (its start scored as on the CPU), lanes cut by a small
``max_iter``; one problem; more problems than the grid has warps; d 1,
3, 5 and 17, full and diagonal; the same batch twice.
"""

import math

import numpy as np
import pytest
import torch

from pybnesian_tpu_torch.ops import ucv_search_kernel as usk
from pybnesian_tpu_torch.ops.ucv_kernel import ucv_pair_sums_cuda

pytestmark = pytest.mark.cuda
RTOL = 1e-5
SCORE_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; run chip_smoke.py)")
    return torch.device("cuda")


def _problems(device, B, N, d, seed=0, ragged=True, diagonal=False,
              dtype=torch.float32, spread=None):
    """B problems of a correlated d-column sample, N rows or fewer
    (ragged: problem b has N - 37 (b mod 8)), zero rows marked invalid
    after them, and their normal-reference starts (vech(chol(H)) or
    sqrt(diag(H))).
    ``spread`` (rows, d) places every row at one of those centres."""
    rng = np.random.default_rng(seed)
    mix = np.tril(np.full((d, d), 0.3)) + np.eye(d)
    X = np.zeros((B, N, d))
    valid = np.zeros((B, N))
    Ns = np.zeros(B)
    x0 = []
    for b in range(B):
        n = N - (37 * (b % 8) if ragged else 0)
        x = rng.normal(0.0, 1.0, (n, d)) @ mix.T
        if spread is not None:
            x = x + spread[rng.integers(0, len(spread), n)]
        X[b, :n], valid[b, :n], Ns[b] = x, 1.0, n
        knr = (4.0 / (n * (d + 2.0))) ** (2.0 / (d + 4.0))
        H = knr * np.atleast_2d(np.cov(x, rowvar=False))
        if diagonal:
            x0.append(np.sqrt(np.diag(H)))
        else:
            L = np.linalg.cholesky(H)
            x0.append(np.concatenate([L[j:, j] for j in range(d)]))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (t(X), t(valid) if ragged else None, t(Ns), t(np.array(x0)))


def _rel(got, want):
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def _max_iter(x0):
    return 200 * x0.shape[1]


SHAPES = [(10, 3000, 1, False), (10, 3000, 2, False), (10, 9000, 3, False),
          (30, 1500, 3, False), (1, 2000, 3, False), (10, 1200, 5, False),
          (4, 700, 17, False), (10, 2000, 2, True), (4, 900, 17, True)]


def _ids(shape):
    B, N, d, diagonal = shape
    return f"B{B}-N{N}-d{d}" + ("-diag" if diagonal else "")


# ----------------------------------------------------------------- gate 1
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_evaluation_matches_the_plain_objective(cuda, shape):
    B, N, d, diagonal = shape
    X, valid, Ns, x0 = _problems(cuda, B, N, d, seed=d, diagonal=diagonal)
    points = torch.stack([0.8 * x0, 1.25 * x0, 0.4 * x0], 1).contiguous()
    before = usk.ucv_search_cuda.launches
    f, sums, W = usk.ucv_search_evaluate(X, valid, Ns, x0, points, d,
                                         diagonal, white=True)
    want = usk.ucv_objective_reference(X, valid, Ns, x0, points, d,
                                       diagonal)
    assert usk.ucv_search_cuda.launches == before
    assert torch.isfinite(f).all()
    assert _rel(f, want) <= RTOL
    for p in range(points.shape[1]):
        s2h, sh = ucv_pair_sums_cuda(W[:, p].contiguous(), valid)
        assert torch.equal(s2h, sums[:, p, 0])
        assert torch.equal(sh, sums[:, p, 1])


# ----------------------------------------------------------------- gate 2
@pytest.mark.parametrize("max_iter", [1, 2, 3, 5])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_first_iterations_match_the_plain_loop(cuda, shape, max_iter):
    B, N, d, diagonal = shape
    X, valid, Ns, x0 = _problems(cuda, B, N, d, seed=10 + d,
                                 diagonal=diagonal)
    got = usk.ucv_search_cuda(X, valid, Ns, x0, d, diagonal, max_iter)
    want = usk.ucv_search_reference(X, valid, Ns, x0, d, diagonal, max_iter)
    assert _rel(got.x, want.x) <= RTOL
    assert _rel(got.f, want.f) <= RTOL
    assert _rel(got.start, want.start) <= RTOL
    assert torch.equal(got.iterations, want.iterations)
    assert int(got.evaluations) == int(want.evaluations)
    assert torch.equal(got.lane_evaluations, want.lane_evaluations)


# ----------------------------------------------------------------- gate 3
@pytest.mark.parametrize("shape", [s for s in SHAPES
                                   if not (s[2] == 17 and not s[3])],
                         ids=_ids)
def test_whole_search_is_as_good_as_the_plain_loop(cuda, shape):
    B, N, d, diagonal = shape
    X, valid, Ns, x0 = _problems(cuda, B, N, d, seed=20 + d,
                                 diagonal=diagonal)
    before = usk.ucv_search_cuda.launches
    got = usk.ucv_search_cuda(X, valid, Ns, x0, d, diagonal, _max_iter(x0))
    assert usk.ucv_search_cuda.launches == before + 1
    want = usk.ucv_search_reference(X, valid, Ns, x0, d, diagonal,
                                    _max_iter(x0))
    fatol = 1e-4 * want.start.abs() + 1e-12
    print(f"\n{_ids(shape)} iterations kernel {got.iterations.tolist()} "
          f"plain {want.iterations.tolist()}; evaluations kernel "
          f"{int(got.evaluations)} plain {int(want.evaluations)}")
    assert bool((got.f <= want.f + fatol).all()), (got.f, want.f)
    assert bool((got.f <= got.start).all())
    assert bool((got.iterations > 0).all())
    assert bool((got.iterations <= _max_iter(x0)).all())


# ----------------------------------------------------------------- gate 4
def test_cv_scores_of_the_kernels_bandwidths(cuda, monkeypatch):
    import pybnesian_tpu_torch as pt
    from pybnesian_tpu_torch.kde import ucv as tucv

    rng = np.random.default_rng(5)
    a = rng.normal(0.0, 1.0, 3000)
    b = np.sin(a) + rng.normal(0.0, 0.5, 3000)
    c = 0.5 * a - b + rng.normal(0.0, 0.7, 3000)
    df = pt.DataFrame.wrap({"a": a.astype(np.float32),
                            "b": b.astype(np.float32),
                            "c": c.astype(np.float32)})
    score = pt.CVLikelihood(df, k=3, seed=0)
    fams = [("a", [], None), ("b", ["a"], None), ("c", ["a", "b"], None)]
    before = usk.ucv_search_cuda.launches
    kernel, _ = score._engine._ucv_bandwidths(fams)
    assert usk.ucv_search_cuda.launches == before + 3   # one per width
    monkeypatch.setattr(tucv, "ucv_search_cuda", usk.ucv_search_reference)
    plain, _ = score._engine._ucv_bandwidths(fams)
    typed = [(v, ps, pt.CKDEType()) for v, ps, _ in fams]
    got = score._engine._ckde_host_batch(typed, h_maps=[kernel[i]
                                                        for i in range(3)])
    want = score._engine._ckde_host_batch(typed, h_maps=[plain[i]
                                                         for i in range(3)])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL)


# ----------------------------------------------------------------- gate 5
@pytest.mark.parametrize("shape", [(10, 3000, 1, False), (10, 2000, 3, False),
                                   (30, 800, 2, False), (10, 1200, 5, False),
                                   (4, 500, 17, False), (10, 2000, 2, True)],
                         ids=_ids)
def test_a_problem_alone_and_in_its_batch(cuda, shape):
    B, N, d, diagonal = shape
    max_iter = 40 if d == 17 and not diagonal else None
    X, valid, Ns, x0 = _problems(cuda, B, N, d, seed=30 + d,
                                 diagonal=diagonal)
    mi = _max_iter(x0) if max_iter is None else max_iter
    batch = usk.ucv_search_cuda(X, valid, Ns, x0, d, diagonal, mi)
    again = usk.ucv_search_cuda(X, valid, Ns, x0, d, diagonal, mi)
    for g, w in zip(batch, again):
        assert torch.equal(g, w)
    for b in {0, B // 2, B - 1}:
        n = int(Ns[b])
        one = usk.ucv_search_cuda(X[b:b + 1, :n].contiguous(), None,
                                  Ns[b:b + 1].contiguous(),
                                  x0[b:b + 1].contiguous(), d, diagonal, mi)
        assert torch.equal(one.x[0], batch.x[b])
        assert torch.equal(one.f[0], batch.f[b])
        assert torch.equal(one.start[0], batch.start[b])
        assert int(one.iterations[0]) == int(batch.iterations[b])


def test_nan_start_is_done_at_once(cuda):
    X, valid, Ns, x0 = _problems(cuda, 3, 2000, 2, seed=40)
    X[1, 17, 1] = math.nan
    got = usk.ucv_search_cuda(X, valid, Ns, x0, 2, False, 400)
    want = usk.ucv_search_reference(X, valid, Ns, x0, 2, False, 400)
    assert got.iterations.tolist()[1] == 0 == want.iterations.tolist()[1]
    assert bool(got.start[1].isnan()) and torch.equal(got.x[1], x0[1])
    keep = [0, 2]
    rest = usk.ucv_search_cuda(X[keep].contiguous(),
                               valid[keep].contiguous(),
                               Ns[keep].contiguous(), x0[keep].contiguous(),
                               2, False, 400)
    assert torch.equal(got.x[keep], rest.x)
    assert torch.equal(got.iterations[keep], rest.iterations)


def test_argument_checks_on_the_card(cuda):
    X, valid, Ns, x0 = _problems(cuda, 2, 300, 2, seed=50)
    with pytest.raises(ValueError):
        usk.ucv_search_cuda(X.double(), valid, Ns, x0, 2, False, 10)
    with pytest.raises(ValueError):
        usk.ucv_search_cuda(X, valid.cpu(), Ns, x0, 2, False, 10)
    with pytest.raises(ValueError):
        usk.ucv_search_cuda(X, valid, Ns, x0[:, :2].contiguous(), 2, False,
                            10)


# ------------------------------------- below the normal-reference bandwidth
def test_evaluations_far_below_the_normal_reference(cuda, monkeypatch):
    """Four clusters on a square of side 40 standard deviations: the
    normal-reference bandwidth, set by the spread of all four, is far
    above the UCV optimum of each cluster's own spread. The plain search
    in float64 records every point it visits; the kernel evaluates them
    all in float32, each within 1e-5 relative of the float64 plain
    objective. The smallest bandwidth scored, as a factor of the normal
    reference's (the d-th root of det L / det L0), is printed."""
    d = 2
    centres = np.array([[0.0, 0.0], [40.0, 0.0], [0.0, 40.0], [40.0, 40.0]])
    X, valid, Ns, x0 = _problems(cuda, 2, 4000, d, seed=60,
                                 spread=centres, dtype=torch.float64)
    visited = []
    raw = usk._raw

    def recording(X_, valid_, Ns_, xs, d_, diagonal_):
        visited.append(xs.clone())
        return raw(X_, valid_, Ns_, xs, d_, diagonal_)

    monkeypatch.setattr(usk, "_raw", recording)
    want = usk.ucv_search_reference(X, valid, Ns, x0, d, False,
                                    _max_iter(x0))
    monkeypatch.setattr(usk, "_raw", raw)
    points = torch.stack(visited, 1)                   # (B, visits, nv)
    f64 = usk.ucv_objective_reference(X, valid, Ns, x0, points, d, False)
    f32 = torch.cat([
        usk.ucv_search_evaluate(
            X.float(), valid.float(), Ns.float(), x0.float(),
            points[:, i: i + 64].float().contiguous(), d, False)[0]
        for i in range(0, points.shape[1], 64)], 1)
    # |det L / det L0| ** (1 / d): a visited point's diagonal may be
    # negative (a bad point, scored f_start + 1e-7)
    start = x0[:, [0, 2]].prod(-1)
    factor = (points[..., [0, 2]].prod(-1) / start[:, None]).abs() ** (1 / d)
    found = (want.x[:, [0, 2]].prod(-1) / start).abs() ** (1 / d)
    rel = _rel(f32, f64)
    # the smallest factor of a point that the guards let through (a bad
    # point scores f_start + 1e-7)
    bad = f64 == (usk._raw(X, valid, Ns, x0, d, False)[0] + 1e-7)[:, None]
    print(f"\nvisits {points.shape[1]}: smallest factor scored "
          f"{float(factor[~bad].min()):.4f}, the optimum at "
          f"{found.tolist()}; max rel {rel:.3e}")
    assert float(found.max()) < 0.25
    assert rel <= RTOL


# ------------------------------------------------------------ the schedule
def _same(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _hold_to_the_plain_loop(X, valid, Ns, x0, d, diagonal, max_iter,
                            alone=(0, -1)):
    """The kernel's search against the plain loop's: every field the same
    bits; a second run the same; problems ``alone`` (their padded rows as
    a batch of one) the same as in the batch. Returns the kernel's."""
    got = usk.ucv_search_cuda(X, valid, Ns, x0, d, diagonal, max_iter)
    want = usk.ucv_search_reference(X, valid, Ns, x0, d, diagonal, max_iter)
    for g, w in zip(got, want):
        _same(g, w)
    again = usk.ucv_search_cuda(X, valid, Ns, x0, d, diagonal, max_iter)
    for g, w in zip(got, again):
        _same(g, w)
    for b in alone:
        b = b % len(x0)
        one = usk.ucv_search_cuda(
            X[b:b + 1].contiguous(),
            None if valid is None else valid[b:b + 1].contiguous(),
            Ns[b:b + 1].contiguous(), x0[b:b + 1].contiguous(), d, diagonal,
            max_iter)
        for name in ("x", "f", "start", "iterations", "lane_evaluations"):
            _same(getattr(one, name)[0], getattr(got, name)[b])
    return got


def test_lanes_that_finish_far_apart(cuda):
    """Lane 1 starts with a NaN row (done at once); lane 2 starts at 1e-4
    of its normal-reference factor, below the determinant's guard rail
    (every point a bad point, scored alike: it shrinks at each iteration
    and converges within its first few); lanes 0 and 3 search as usual,
    max_iter set between their own iteration counts, so that one of them
    is cut by it. d 3, diagonal. Lane 2's start, whose rows lie some 1e4
    bandwidths apart, scores as the plain objective on the CPU scores it
    (a finite value: the pair sums' masked self-pairs are 0 there)."""
    d = 3
    X, valid, Ns, x0 = _problems(cuda, 4, 1500, d, seed=70, diagonal=True)
    X[1, 11, 0] = math.nan
    x0[2] *= 1e-4
    free = usk.ucv_search_reference(X, valid, Ns, x0, d, True, 400)
    low, high = sorted(int(free.iterations[b]) for b in (0, 3))
    assert low < high
    max_iter = (low + high + 1) // 2
    got = _hold_to_the_plain_loop(X, valid, Ns, x0, d, True, max_iter,
                                  alone=(0, 1, 2, 3))
    cpu = [t.cpu() for t in (X, valid, Ns, x0)]
    start = usk.ucv_objective_reference(*cpu, cpu[3][:, None], d, True)
    assert math.isfinite(float(start[2, 0]))
    assert _rel(got.start[2:3].cpu(), start[2]) <= RTOL
    iters = got.iterations.tolist()
    nv = x0.shape[1]
    assert iters[1] == 0 and int(got.lane_evaluations[1]) == nv + 1
    assert 0 < iters[2] < 20
    assert int(got.lane_evaluations[2]) == nv + 1 + iters[2] * (2 + nv)
    assert sorted([iters[0], iters[3]]) == [low, max_iter]
    print(f"\niterations {iters}, lane evaluations "
          f"{got.lane_evaluations.tolist()}, evaluations "
          f"{int(got.evaluations)}, lane 2's start {float(got.start[2])} "
          f"(CPU {float(start[2, 0])})")


def test_one_problem(cuda):
    X, valid, Ns, x0 = _problems(cuda, 1, 2500, 3, seed=71)
    _hold_to_the_plain_loop(X, valid, Ns, x0, 3, False, _max_iter(x0),
                            alone=())


@pytest.mark.parametrize("B,N,d", [(300, 600, 2), (2500, 300, 1)])
def test_more_problems_than_warps(cuda, B, N, d):
    """300 problems of 600 rows, and 2,500 problems (more than the grid's
    warps, so a warp sets up several lanes and most lanes are no block's
    first) of 300 rows."""
    X, valid, Ns, x0 = _problems(cuda, B, N, d, seed=72)
    _hold_to_the_plain_loop(X, valid, Ns, x0, d, False, _max_iter(x0),
                            alone=(0, B // 2, -1))


@pytest.mark.parametrize("d,diagonal", [(1, False), (3, False), (3, True),
                                        (5, False), (5, True), (17, False),
                                        (17, True)],
                         ids=["d1", "d3", "d3-diag", "d5", "d5-diag", "d17",
                              "d17-diag"])
def test_widths(cuda, d, diagonal):
    """d 1 (where the diagonal form is the full form), 3, 5 and 17."""
    N = 700 if d == 17 else 1500
    X, valid, Ns, x0 = _problems(cuda, 6, N, d, seed=73 + d,
                                 diagonal=diagonal)
    max_iter = 30 if d == 17 and not diagonal else _max_iter(x0)
    _hold_to_the_plain_loop(X, valid, Ns, x0, d, diagonal, max_iter)


def test_the_same_batch_twice(cuda):
    """Two runs of one batch, and a third after another batch ran between:
    the same bits, evaluations and lane evaluations."""
    X, valid, Ns, x0 = _problems(cuda, 10, 2000, 3, seed=74)
    first = usk.ucv_search_cuda(X, valid, Ns, x0, 3, False, _max_iter(x0))
    second = usk.ucv_search_cuda(X, valid, Ns, x0, 3, False, _max_iter(x0))
    Y = _problems(cuda, 3, 900, 3, seed=75)
    usk.ucv_search_cuda(*Y, 3, False, 50)
    third = usk.ucv_search_cuda(X, valid, Ns, x0, 3, False, _max_iter(x0))
    for a, b, c in zip(first, second, third):
        _same(a, b)
        _same(a, c)
