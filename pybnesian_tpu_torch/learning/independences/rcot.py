"""RCoT: randomized conditional correlation test (Strobl et al. 2019).

Rebuild of reference learning/independences/continuous/RCoT.{hpp,cpp}:
random Fourier features (5 for x/y, 100 for z by default), median-heuristic
kernel widths (rf_sigma_impl, RCoT.hpp:16-41), residualisation of the x/y
features against z, statistic = N·‖cov(resid_x, resid_y)‖², null distribution
= weighted χ² sum via LPB4 with HBE fallback (RCoT.hpp:340-395).
The feature products and eigenvalues run as dense tensor algebra on the
device — a handful of (N × 100) matrix products per test.

Copied from ``pybnesian_tpu/learning/independences/rcot.py``. The host parts
(the median-heuristic widths, the numpy draws of the features and the
p-value tail) are the same, and every draw keeps the reference's shape, so
a seed gives the same features. The feature maps, covariances, the
conditioning solve and the eigenvalues are torch functions on
:func:`default_device`: the serial path in the data's float64, as there;
the batched path's feature maps in float32, as there, and its algebra in
float64 (:data:`_ALGEBRA_DTYPE`), where the reference's float32 Cholesky
fails at 100,000 rows. Float32 products run in full FP32 (importing
``runtime.device`` switches TF32 off), as ``Precision.HIGHEST`` does there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...data import DataFrame
from ...ops.linalg import cholesky_or_nan
from ...runtime.device import default_device
from ...utils.chisquaresum import (
    chisq_sum_pvalues_batch,
    hbe_complement,
    lpb4_complement,
)
from .base import DynamicIndependenceTest, IndependenceTest

__all__ = ["RCoT", "DynamicRCoT"]

# relative ridge of the conditioning solve: czz has a UNIT diagonal (the
# feature columns are standardized). The serial path applies the same ridge.
_RIDGE = 1e-5
# dtype of the batched path's algebra after its float32 feature maps. The
# reference keeps float32 throughout; at config 4's 100,000 rows a float32
# czz of 100 z features, whose smallest eigenvalues are ~0 (the features
# of one or two columns are nearly collinear), is not positive definite
# within the ridge: its rounding (~sqrt(n)·eps per entry) exceeds 1e-5 and
# the Cholesky gives NaN, so the test's p-value is garbage. In float64 the
# covariances cost the same on the H100 (FP64 tensor cores) and the
# Cholesky holds.
_ALGEBRA_DTYPE = torch.float64


def rf_sigma(m: np.ndarray) -> float:
    """Median pairwise distance over the first min(500, n) rows
    (reference rf_sigma_impl)."""
    if m.ndim == 1:
        m = m[:, None]
    r = min(500, len(m))
    sub = m[:r]
    d = np.sqrt(
        np.maximum(
            ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1), 0.0
        )
    )
    iu = np.triu_indices(r, k=1)
    med = float(np.median(d[iu]))
    return med if med != 0 else 1.0


_TRIU_CACHE: dict[int, tuple] = {}


def _rf_sigma_cols(m: np.ndarray) -> float:
    """``rf_sigma`` via the Gram trick (a²+b²−2ab in f64 — no cancellation
    trouble at 500 rows): O(r²·d) flops through BLAS instead of an
    (r, r, d) broadcast, and the median taken on SQUARED distances
    (median commutes with the monotone sqrt) so the 125k-element sqrt
    disappears."""
    if m.ndim == 1:
        m = m[:, None]
    r = min(500, len(m))
    sub = np.asarray(m[:r], np.float64)
    sq = np.einsum("ij,ij->i", sub, sub)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (sub @ sub.T)
    iu = _TRIU_CACHE.get(r)
    if iu is None:
        iu = np.triu_indices(r, k=1)
        _TRIU_CACHE[r] = iu
    med = math.sqrt(max(float(np.median(d2[iu])), 0.0))
    return med if med != 0 else 1.0


# ------------------------------------------------------------ serial algebra
def _standardize(feat):
    """Columns of ``feat`` (..., n, f) centred and scaled to unit sample
    sd over the n rows; a constant column keeps sd 1 (it becomes 0)."""
    mean = feat.mean(-2, keepdim=True)
    sd = feat.std(-2, correction=1, keepdim=True)
    sd = torch.where(sd == 0, torch.ones_like(sd), sd)
    return (feat - mean) / sd


def rff(m, W, b):
    """The normalized feature map √2·cos(mW + b) of (n, d) ``m``, (d, f)
    ``W`` and (f,) ``b``."""
    return _standardize(math.sqrt(2.0) * torch.cos(m @ W + b[None, :]))


def random_fourier_features(m: np.ndarray, sigma: float, num_features: int,
                            rng, device=None) -> torch.Tensor:
    """√2·cos(mW/σ + b) with W ~ N(0,1), b ~ U(0, 2π)
    (reference RCoT.hpp:209-241). Draws on host (the reference's numpy
    stream) and returns the normalized features as a tensor on ``device``
    (default: :func:`default_device`), in ``m``'s dtype."""
    if m.ndim == 1:
        m = m[:, None]
    W = rng.standard_normal((m.shape[1], num_features)) / sigma
    b = rng.uniform(0, 2 * np.pi, num_features)
    device = device if device is not None else default_device()

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, m.dtype)).to(device)

    return rff(put(m), put(W), put(b))


def _cov(a, b):
    """Sample covariance of the columns of (..., n, c) ``a`` and (..., n, d)
    ``b``: (..., c, d)."""
    ac = a - a.mean(-2, keepdim=True)
    bc = b - b.mean(-2, keepdim=True)
    return ac.transpose(-1, -2) @ bc / (a.shape[-2] - 1.0)


def _prod_eigvals(a, b, n):
    """Eigenvalues (ascending) of the covariance (divisor n) of the
    row-wise products of a's and b's columns, batched over leading axes:
    a (..., n, c), b (..., n, d) -> (..., c·d). A batch member whose
    matrix is not finite gets NaN eigenvalues (as ``jnp.linalg.eigvalsh``
    gives it) where ``torch.linalg.eigvalsh`` would raise."""
    prod = (a[..., :, :, None] * b[..., :, None, :]).reshape(
        *a.shape[:-2], n, -1)
    centred = prod - prod.mean(-2, keepdim=True)
    covp = centred.transpose(-1, -2) @ centred / n
    bad = ~torch.isfinite(covp).all(-1).all(-1)
    eigs = torch.linalg.eigvalsh(
        torch.where(bad[..., None, None], torch.zeros_like(covp), covp))
    return torch.where(bad[..., None], torch.full_like(eigs, math.nan), eigs)


def covs(fx, fy, fz):
    """(cxy, czz, cxz, czy): the covariances of one test's features."""
    return _cov(fx, fy), _cov(fz, fz), _cov(fx, fz), _cov(fz, fy)


def _pair_algebra(fx, fy):
    """(‖cov(fx, fy)‖², product eigenvalues) of marginal tests' features
    (..., n, f)."""
    return ((_cov(fx, fy)**2).sum((-2, -1)),
            _prod_eigvals(fx, fy, fx.shape[-2]))


def resid_eigs(fx, fy, fz, B1, B2):
    """Product eigenvalues of the x/y features residualised on z."""
    return _prod_eigvals(fx - fz @ B1, fy - fz @ B2, fx.shape[0])


def _test_with_z_core(fx, fy, fz):
    """Heavy O(n) algebra on device; the ill-conditioned 100×100 solve stays
    on host in float64."""
    n = len(fx)
    cxy, czz, cxz, czy = (m.cpu().numpy().astype(np.float64)
                          for m in covs(fx, fy, fz))
    # SAME relative ridge as the batched path (unit diagonal after
    # standardization); the reference uses a plain inverse (RCoT.hpp:355)
    # which this regularizes against f32-feature Gram noise
    czz[np.diag_indices_from(czz)] += _RIDGE
    B1 = np.linalg.solve(czz, cxz.T)   # i_czz @ cxz.T  (num_z, num_xy)
    B2 = np.linalg.solve(czz, czy)     # i_czz @ czy
    cxy_z = cxy - cxz @ B2
    sta = n * float(np.sum(cxy_z**2))

    def put(a):
        return torch.from_numpy(a).to(fx.device, fx.dtype)

    return sta, resid_eigs(fx, fy, fz, put(B1), put(B2))


def _pvalue_from_eigs(eigs: np.ndarray, sta: float) -> float:
    pos = eigs[eigs > 0]
    if len(pos) < 4:
        return max(hbe_complement(pos, sta), 0.0)
    try:
        return max(lpb4_complement(pos, sta), 0.0)
    except Exception:
        return max(hbe_complement(pos, sta), 0.0)


# ----------------------------------------------------------- batched algebra
def _feat1(data, col, W, b):
    """Features of one column per test: data (n, C), col (B,), W/b (B, f)
    -> (B, n, f)."""
    X = data[:, col].T
    return _standardize(math.sqrt(2.0) * torch.cos(
        X[:, :, None] * W[:, None, :] + b[:, None, :]))


def _featk(data, cols, W, b):
    """Features of d columns per test: cols (B, d), W (B, d, f), b (B, f)
    -> (B, n, f)."""
    Z = data[:, cols].permute(1, 0, 2)
    return _standardize(math.sqrt(2.0) * torch.cos(Z @ W + b[:, None, :]))


def fused_z(data, xc, Wx, bx, yc, Wy, by, zc, Wz, bz):
    """B conditional tests end to end: feature maps, covariances, the
    (num_z × num_z) conditioning solve, residual products and their
    eigenvalues. ``data`` (n, C) holds every column; ``xc``/``yc`` (B,) and
    ``zc`` (B, d) pick each test's columns; ``Wz`` (B, d, num_z) draws for
    those d columns only (a padded zero column adds nothing to Z @ W).

    The feature maps run in the data's dtype, the algebra after them in
    float64 (:data:`_ALGEBRA_DTYPE`). The solve is a Cholesky of czz +
    :data:`_RIDGE`·I; a test whose matrix is not positive definite gets NaN
    (:func:`cholesky_or_nan`), as the reference's ``jnp.linalg.cholesky``
    gives it. Returns the (B,) statistics and (B, num_xy²) eigenvalues,
    float64."""
    n = data.shape[0]
    fx, fy, fz = (f.to(_ALGEBRA_DTYPE) for f in (
        _feat1(data, xc, Wx, bx), _feat1(data, yc, Wy, by),
        _featk(data, zc, Wz, bz)))
    cxy, czz, cxz, czy = covs(fx, fy, fz)
    eye = torch.eye(czz.shape[-1], dtype=czz.dtype, device=czz.device)
    L = cholesky_or_nan(czz + _RIDGE * eye)
    B1 = torch.cholesky_solve(cxz.transpose(1, 2), L)
    B2 = torch.cholesky_solve(czy, L)
    cxy_z = cxy - cxz @ B2
    sta = n * (cxy_z**2).sum((1, 2))
    return sta, _prod_eigvals(fx - fz @ B1, fy - fz @ B2, n)


def pair_stats(data, xc, Wx, bx, yc, Wy, by):
    """B marginal tests: the (B,) ‖cov(fx, fy)‖² and (B, num_xy²)
    product eigenvalues, float64 (the features in the data's dtype, the
    algebra as :func:`fused_z`'s)."""
    return _pair_algebra(*(f.to(_ALGEBRA_DTYPE) for f in (
        _feat1(data, xc, Wx, bx), _feat1(data, yc, Wy, by))))


def _fetch(sta, eigs):
    """(statistics, eigenvalues) as float64 numpy, in one device copy."""
    arr = torch.cat([sta[:, None], eigs], 1).cpu().numpy().astype(np.float64)
    return arr[:, 0], arr[:, 1:]


class RCoT(IndependenceTest):
    def __init__(self, df, random_fourier_xy: int = 5,
                 random_fourier_z: int = 100, seed: int | None = None):
        self.df = DataFrame.wrap(df)
        self.num_xy = int(random_fourier_xy)
        self.num_z = int(random_fourier_z)
        self._rng = np.random.default_rng(seed)
        self.device = default_device()
        # batched-path caches (full-column values + median-heuristic widths;
        # valid because the batch path only runs on null-free columns)
        self._col_cache: dict[str, np.ndarray] = {}
        self._sig1: dict[str, float] = {}
        self._sigz: dict[tuple, float] = {}
        for c in self.df.column_names():
            if not self.df.is_continuous(c):
                raise ValueError(
                    f"Column '{c}' is not continuous; RCoT requires "
                    "continuous data."
                )

    def variable_names(self) -> list[str]:
        return self.df.column_names()

    def _col(self, name, mask):
        return self.df.to_numpy([name], drop_null=False, dtype=np.float64)[
            mask, 0
        ]

    def _features(self, m, sigma, num_features):
        return random_fourier_features(m, sigma, num_features, self._rng,
                                       self.device)

    def pvalue(self, x: str, y: str, *z) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        mask = self.df.combined_mask(x, y, *z)
        xv = self._col(x, mask)
        yv = self._col(y, mask)
        if xv.var() == 0 or yv.var() == 0:
            return 1.0
        if z:
            zmat = np.column_stack([self._col(e, mask) for e in z])
            # drop constant z columns (reference RCoT.cpp:95-115)
            keep = zmat.var(axis=0) > 0
            zmat = zmat[:, keep]
            if zmat.shape[1] > 0:
                return self._test_with_z(xv, yv, zmat)
        return self._rit(xv, yv)

    def _rit(self, x: np.ndarray, y: np.ndarray) -> float:
        """(reference RIT_impl, RCoT.hpp:288-317)."""
        n = len(x)
        fx = self._features(x, rf_sigma(x), self.num_xy)
        fy = self._features(y, rf_sigma(y), self.num_xy)
        ssq, eigs = _pair_algebra(fx, fy)
        ssq, eigs = _fetch(ssq.reshape(1), eigs[None])
        return _pvalue_from_eigs(eigs[0], n * float(ssq[0]))

    def _test_with_z(self, x: np.ndarray, y: np.ndarray, z: np.ndarray) -> float:
        """(reference TestWithZ_impl, RCoT.hpp:340-395)."""
        fx = self._features(x, rf_sigma(x), self.num_xy)
        fy = self._features(y, rf_sigma(y), self.num_xy)
        sigma_z = rf_sigma(z)
        # z padded to a power-of-two width, as the reference pads it: a
        # zero column adds nothing to z @ W, but the draw of W keeps the
        # reference's shape, and so its stream
        kz = z.shape[1]
        kp = 1
        while kp < kz:
            kp *= 2
        if kp != kz:
            z = np.concatenate([z, np.zeros((len(z), kp - kz))], axis=1)
        fz = self._features(z, sigma_z, self.num_z)
        sta, eigs = _test_with_z_core(fx, fy, fz)
        return self._pvalue_tail(eigs.cpu().numpy().astype(np.float64), sta)

    def _pvalue_tail(self, eigs: np.ndarray, sta: float) -> float:
        if self.num_z == 1:
            pos = eigs[eigs > 0]
            return max(hbe_complement(pos, sta), 0.0)
        return _pvalue_from_eigs(eigs, sta)

    # ------------------------------------------------------- batched path
    # f32-element budget per chunk (~4 GB of intermediates); the dominant
    # per-test footprint is the (n, num_z) z-feature block plus the
    # (n, num_xy²) residual product. It sets the chunk's padded lane count,
    # and so the shape of every draw.
    _ELEM_BUDGET = 1_000_000_000

    def _full_col(self, name: str) -> np.ndarray:
        col = self._col_cache.get(name)
        if col is None:
            col = self.df.to_numpy([name], drop_null=False,
                                   dtype=np.float64)[:, 0]
            self._col_cache[name] = col
        return col

    def _device_data(self):
        """All columns uploaded ONCE as an (n, C) float32 device matrix;
        batched calls gather their (x, y, Z) columns on device, so a
        chunk's host-to-device traffic is only the small W/b draw."""
        if not hasattr(self, "_dev_data"):
            names = self.df.column_names()
            mat = np.column_stack([self._full_col(c) for c in names])
            self._dev_data = torch.from_numpy(
                mat.astype(np.float32)).to(self.device)
            self._dev_pos = {c: i for i, c in enumerate(names)}
        return self._dev_data, self._dev_pos

    def _sigma1(self, name: str, col: np.ndarray) -> float:
        s = self._sig1.get(name)
        if s is None:
            s = rf_sigma(col)
            self._sig1[name] = s
        return s

    def _sigmaz(self, zcols: tuple, zmat: np.ndarray) -> float:
        s = self._sigz.get(zcols)
        if s is None:
            s = _rf_sigma_cols(zmat)
            self._sigz[zcols] = s
        return s

    def _lanes(self, size: int) -> tuple[int, int]:
        """(dp, b_chunk) of a batch of tests conditioned on ``size``
        columns: the power-of-two width its z draws are padded to, and the
        power-of-two lane count every chunk draws for."""
        n = self.df.num_rows
        dp = 1
        while dp < size:
            dp *= 2
        if size == 0:
            per_test = n * (4 * self.num_xy + 2 * self.num_xy * self.num_xy)
        else:
            per_test = n * (dp + 6 * self.num_xy + 2 * self.num_z
                            + 2 * self.num_xy * self.num_xy)
        bmax = max(1, self._ELEM_BUDGET // per_test)
        b_chunk = 1
        while b_chunk * 2 <= bmax:
            b_chunk *= 2
        return dp, b_chunk

    def pvalue_batch(self, triples) -> np.ndarray:
        """Batched tests: stack the (x, y | Z) problems of one sweep and run
        each chunk of them end to end in one batched call (:func:`fused_z`,
        or :func:`pair_stats` without z). Groups by conditioning-set size
        internally; tests over null-bearing columns fall back to the serial
        path (their row masks differ per test).

        Each chunk draws its features for ``b_chunk`` lanes — a power of
        two set by :attr:`_ELEM_BUDGET` — and z draws for a power-of-two
        width, as the reference pads them, so a seed gives the reference's
        draws; only the real lanes and the real z columns are computed."""
        triples = list(triples)
        out = np.empty(len(triples))
        cols = sorted({c for t in triples for c in (t[0], t[1], *t[2])})
        if any(self.df.null_count(c) > 0 for c in cols):
            return super().pvalue_batch(triples)
        data = {c: self._full_col(c) for c in cols}
        var = {c: float(data[c].var()) for c in cols}

        groups: dict[int, list] = {}
        for i, (x, y, zs) in enumerate(triples):
            if var[x] == 0 or var[y] == 0:
                out[i] = 1.0
                continue
            zcols = tuple(c for c in zs if var[c] > 0)
            groups.setdefault(len(zcols), []).append((i, x, y, zcols))

        n = self.df.num_rows
        two_pi = 2 * np.pi
        dev, dpos = self._device_data()

        def put(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device)

        for size, items in groups.items():
            dp, b_chunk = self._lanes(size)
            for start in range(0, len(items), b_chunk):
                chunk = items[start:start + b_chunk]
                real = len(chunk)
                bp = b_chunk
                rng = self._rng
                xc = put([dpos[x] for (_, x, _, _) in chunk], np.int64)
                yc = put([dpos[y] for (_, _, y, _) in chunk], np.int64)
                sigx = np.array([self._sigma1(x, data[x])
                                 for (_, x, _, _) in chunk])
                sigy = np.array([self._sigma1(y, data[y])
                                 for (_, _, y, _) in chunk])
                # draws for all bp lanes (the reference's stream), scaled
                # and computed for the real ones
                Wx = put(rng.standard_normal((bp, self.num_xy))[:real]
                         / sigx[:, None])
                bx = put(rng.uniform(0, two_pi, (bp, self.num_xy))[:real])
                Wy = put(rng.standard_normal((bp, self.num_xy))[:real]
                         / sigy[:, None])
                by = put(rng.uniform(0, two_pi, (bp, self.num_xy))[:real])
                if size == 0:
                    ssq, eigs = _fetch(*pair_stats(dev, xc, Wx, bx, yc, Wy,
                                                   by))
                    pv = chisq_sum_pvalues_batch(eigs, n * ssq)
                    for j in range(real):
                        out[chunk[j][0]] = pv[j]
                    continue
                zc = put([[dpos[c] for c in zcols]
                          for (_, _, _, zcols) in chunk], np.int64)
                sigz = np.array([
                    self._sigmaz(zcols,
                                 np.column_stack([data[c] for c in zcols]))
                    for (_, _, _, zcols) in chunk])
                Wz = put(rng.standard_normal((bp, dp, self.num_z))[
                    :real, :size] / sigz[:, None, None])
                bz = put(rng.uniform(0, two_pi, (bp, self.num_z))[:real])
                sta, eigs = _fetch(*fused_z(dev, xc, Wx, bx, yc, Wy, by, zc,
                                            Wz, bz))
                pv = chisq_sum_pvalues_batch(
                    eigs, sta, force_hbe=self.num_z == 1
                )
                for j in range(real):
                    out[chunk[j][0]] = pv[j]
        return out


class DynamicRCoT(DynamicIndependenceTest):
    test_cls = RCoT
