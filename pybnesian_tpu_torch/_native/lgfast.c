/* Native all-LinearGaussian network core (CPython extension, no numpy dep).
 *
 * Serial-workload tier for small/medium LG networks: the README config-1
 * pipeline (fit + slogl + ancestral sample) is dominated by per-call Python
 * plumbing when each stage routes through per-node numpy; this module runs
 * each stage as ONE C call over the column block, mirroring the shared-Gram
 * closed forms of models/base.py::_fit_lg_fast (reference
 * learning/parameters/mle_LinearGaussianCPD.hpp:12-69 ladder semantics,
 * BayesianNetwork.hpp:960-1066 fit/slogl/sample drivers).
 *
 * Built on first use by pybnesian_tpu._native.build_ext_and_import (g++,
 * -O3 -march=native); loaded as a real extension module so per-call
 * overhead is ~0.2 us instead of ctypes' multi-us argument marshalling.
 *
 * All entry points are INTERNAL: the Python wrappers guarantee dtypes,
 * contiguity and index validity; on any numeric anomaly the C side flags
 * and the wrapper falls back to the generic per-factor path.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __SSE2__
#include <emmintrin.h>
#endif

static const double LOG_2PI = 1.8378770664093454836;
/* numpy float64 eps, mirrors pybnesian_tpu.utils.MACHINE_TOL */
static const double MACHINE_TOL = 2.220446049250313e-16;

/* ------------------------------------------------------------------ views */

typedef struct {
    const double *data; /* base pointer */
    Py_ssize_t n;       /* rows */
    Py_ssize_t d;       /* cols */
    Py_ssize_t rstride; /* element stride between rows within a column */
    Py_ssize_t cstride; /* element stride between columns */
} MatView;

/* Parse a 2-D float64 buffer (C- or F-contiguous, or strided). */
static int get_mat(PyObject *obj, Py_buffer *view, MatView *m) {
    if (PyObject_GetBuffer(obj, view, PyBUF_STRIDES) < 0) return -1;
    if (view->ndim != 2 || view->itemsize != 8) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_TypeError, "expected 2-D float64 matrix");
        return -1;
    }
    m->data = (const double *)view->buf;
    m->n = view->shape[0];
    m->d = view->shape[1];
    m->rstride = view->strides[0] / 8;
    m->cstride = view->strides[1] / 8;
    return 0;
}

static int get_1d(PyObject *obj, Py_buffer *view, Py_ssize_t itemsize) {
    if (PyObject_GetBuffer(obj, view, PyBUF_C_CONTIGUOUS) < 0) return -1;
    if (view->ndim != 1 || view->itemsize != itemsize) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_TypeError, "expected contiguous 1-D array");
        return -1;
    }
    return 0;
}

static int get_2d_c(PyObject *obj, Py_buffer *view) {
    if (PyObject_GetBuffer(obj, view, PyBUF_C_CONTIGUOUS) < 0) return -1;
    if (view->ndim != 2 || view->itemsize != 8) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_TypeError, "expected C-contiguous 2-D float64");
        return -1;
    }
    return 0;
}

/* column pointer helper: valid whenever rstride is the fast axis */
#define COLP(m, j) ((m)->data + (Py_ssize_t)(j) * (m)->cstride)

/* Sum of a strided column with 4-way accumulator unrolling (breaks the FP
 * add dependency chain the strict-FP scalar loop serializes on). */
static double col_sum(const double *p, Py_ssize_t n, Py_ssize_t s) {
    Py_ssize_t i = 0;
#ifdef __SSE2__
    if (s == 1) {
        __m128d v0 = _mm_setzero_pd(), v1 = _mm_setzero_pd();
        for (; i + 4 <= n; i += 4) {
            v0 = _mm_add_pd(v0, _mm_loadu_pd(p + i));
            v1 = _mm_add_pd(v1, _mm_loadu_pd(p + i + 2));
        }
        double lo[2], hi[2];
        _mm_storeu_pd(lo, v0);
        _mm_storeu_pd(hi, v1);
        double a = (lo[0] + lo[1]) + (hi[0] + hi[1]);
        for (; i < n; ++i) a += p[i];
        return a;
    }
#endif
    double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    for (; i + 4 <= n; i += 4) {
        a0 += p[(i + 0) * s];
        a1 += p[(i + 1) * s];
        a2 += p[(i + 2) * s];
        a3 += p[(i + 3) * s];
    }
    for (; i < n; ++i) a0 += p[i * s];
    return (a0 + a1) + (a2 + a3);
}

/* Centered dot of two strided columns. */
static double col_cdot(const double *x, const double *y, double mx, double my,
                       Py_ssize_t n, Py_ssize_t sx, Py_ssize_t sy) {
    double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    Py_ssize_t i = 0;
    for (; i + 4 <= n; i += 4) {
        a0 += (x[(i + 0) * sx] - mx) * (y[(i + 0) * sy] - my);
        a1 += (x[(i + 1) * sx] - mx) * (y[(i + 1) * sy] - my);
        a2 += (x[(i + 2) * sx] - mx) * (y[(i + 2) * sy] - my);
        a3 += (x[(i + 3) * sx] - mx) * (y[(i + 3) * sy] - my);
    }
    for (; i < n; ++i) a0 += (x[i * sx] - mx) * (y[i * sy] - my);
    return (a0 + a1) + (a2 + a3);
}

/* In-place lower Cholesky of a k x k row-major matrix. Returns 0 on
 * success, -1 if a pivot is non-positive. Also reports min/max diagonal. */
static int cholesky(double *a, int k, double *dmin, double *dmax) {
    *dmin = INFINITY;
    *dmax = 0.0;
    for (int j = 0; j < k; ++j) {
        double s = a[j * k + j];
        for (int t = 0; t < j; ++t) s -= a[j * k + t] * a[j * k + t];
        if (!(s > 0.0)) return -1;
        double l = sqrt(s);
        a[j * k + j] = l;
        if (l < *dmin) *dmin = l;
        if (l > *dmax) *dmax = l;
        for (int i = j + 1; i < k; ++i) {
            double v = a[i * k + j];
            for (int t = 0; t < j; ++t) v -= a[i * k + t] * a[j * k + t];
            a[i * k + j] = v / l;
        }
    }
    return 0;
}

/* Compile-time-width fused Gram pass (this file builds as C++ under g++):
 * fixed MC lets the compiler fully unroll the MC²/2 accumulator updates
 * into straight-line independent FMA chains. */
template <int MC>
static void gram_pass_t(const double *const *colp, const double *means,
                        Py_ssize_t n, Py_ssize_t rs, double *gram) {
    double acc[MC * (MC + 1) / 2];
    for (int t = 0; t < MC * (MC + 1) / 2; ++t) acc[t] = 0.0;
    Py_ssize_t i = 0;
#ifdef __SSE2__
    if (rs == 1) {
        /* 2 rows per step: the upper-triangle accumulators become packed
         * 2-lane sums, halving the scalar op count on unit-stride columns */
        __m128d vacc[MC * (MC + 1) / 2];
        __m128d vmeans[MC];
        for (int t = 0; t < MC * (MC + 1) / 2; ++t) vacc[t] = _mm_setzero_pd();
        for (int a = 0; a < MC; ++a) vmeans[a] = _mm_set1_pd(means[a]);
        for (; i + 2 <= n; i += 2) {
            __m128d buf[MC];
            for (int a = 0; a < MC; ++a)
                buf[a] = _mm_sub_pd(_mm_loadu_pd(colp[a] + i), vmeans[a]);
            int t = 0;
            for (int a = 0; a < MC; ++a)
                for (int b = a; b < MC; ++b, ++t)
                    vacc[t] = _mm_add_pd(vacc[t], _mm_mul_pd(buf[a], buf[b]));
        }
        for (int t = 0; t < MC * (MC + 1) / 2; ++t) {
            double lo[2];
            _mm_storeu_pd(lo, vacc[t]);
            acc[t] = lo[0] + lo[1];
        }
    }
#endif
    for (; i < n; ++i) {
        double buf[MC];
        for (int a = 0; a < MC; ++a) buf[a] = colp[a][i * rs] - means[a];
        int t = 0;
        for (int a = 0; a < MC; ++a)
            for (int b = a; b < MC; ++b) acc[t++] += buf[a] * buf[b];
    }
    int t = 0;
    for (int a = 0; a < MC; ++a)
        for (int b = a; b < MC; ++b) {
            gram[a * MC + b] = acc[t];
            gram[b * MC + a] = acc[t];
            ++t;
        }
}

/* -------------------------------------------------------------------- fit */

/* lgf_fit(mat, use_cols, yidx, indptr, pidx, betas, vars, flags) -> int
 *
 * mat:      (n, d_df) float64, any strides (pandas block view works as-is)
 * use_cols: (m,) int32   df-column index of each compacted column
 * yidx:     (dn,) int32  compacted column of each node's target
 * indptr:   (dn+1,) int32 CSR offsets into pidx
 * pidx:     (np,) int32  compacted columns of each node's parents, in
 *                        evidence order (beta follows this order)
 * betas:    (dn, kmax+1) float64 C-contig, written
 * vars:     (dn,) float64, written
 * flags:    (dn,) uint8, written: 1 = params valid, 0 = caller must run the
 *                        generic ladder for this node (numeric guard fired)
 *
 * Returns 0 on success, 1 when a NaN was seen anywhere in the used columns
 * (caller falls back wholesale: null semantics belong to the generic path).
 * Mirrors models/base.py::_fit_lg_fast numerically: shared centered Gram,
 * k = 0/1/2 closed forms, k >= 3 Cholesky with pivot-ratio guard.
 */
static PyObject *lgf_fit(PyObject *self, PyObject *const *args,
                         Py_ssize_t nargs) {
    if (nargs != 8) {
        PyErr_SetString(PyExc_TypeError, "lgf_fit expects 8 args");
        return NULL;
    }
    Py_buffer vmat, vuse, vy, vip, vpi, vb, vv, vf;
    MatView m;
    if (get_mat(args[0], &vmat, &m) < 0) return NULL;
    if (get_1d(args[1], &vuse, 4) < 0) { PyBuffer_Release(&vmat); return NULL; }
    if (get_1d(args[2], &vy, 4) < 0) goto fail2;
    if (get_1d(args[3], &vip, 4) < 0) goto fail3;
    if (get_1d(args[4], &vpi, 4) < 0) goto fail4;
    if (get_2d_c(args[5], &vb) < 0) goto fail5;
    if (get_1d(args[6], &vv, 8) < 0) goto fail6;
    if (get_1d(args[7], &vf, 1) < 0) goto fail7;
    {
        const int32_t *use = (const int32_t *)vuse.buf;
        const int32_t *yidx = (const int32_t *)vy.buf;
        const int32_t *indptr = (const int32_t *)vip.buf;
        const int32_t *pidx = (const int32_t *)vpi.buf;
        double *betas = (double *)vb.buf;
        double *vars = (double *)vv.buf;
        uint8_t *flags = (uint8_t *)vf.buf;
        Py_ssize_t mc = vuse.len / 4;
        Py_ssize_t dn = vy.len / 4;
        Py_ssize_t bcols = vb.shape[1];
        Py_ssize_t n = m.n;
        int rc = 0;

        double means[64];
        double gram[64 * 64];
        if (mc > 64) {
            PyBuffer_Release(&vf); PyBuffer_Release(&vv); PyBuffer_Release(&vb);
            PyBuffer_Release(&vpi); PyBuffer_Release(&vip); PyBuffer_Release(&vy);
            PyBuffer_Release(&vuse); PyBuffer_Release(&vmat);
            PyErr_SetString(PyExc_ValueError, "lgf_fit: > 64 columns");
            return NULL;
        }
        const double *colp[64];
        for (Py_ssize_t j = 0; j < mc; ++j) colp[j] = COLP(&m, use[j]);
        for (Py_ssize_t j = 0; j < mc; ++j) {
            double s = col_sum(colp[j], n, m.rstride);
            means[j] = s / (double)n;
            if (isnan(means[j])) { rc = 1; break; }
        }
        if (rc == 0) {
            int done = 1;
            Py_ssize_t rs = m.rstride;
            switch (mc) {
                case 1: gram_pass_t<1>(colp, means, n, rs, gram); break;
                case 2: gram_pass_t<2>(colp, means, n, rs, gram); break;
                case 3: gram_pass_t<3>(colp, means, n, rs, gram); break;
                case 4: gram_pass_t<4>(colp, means, n, rs, gram); break;
                case 5: gram_pass_t<5>(colp, means, n, rs, gram); break;
                case 6: gram_pass_t<6>(colp, means, n, rs, gram); break;
                case 7: gram_pass_t<7>(colp, means, n, rs, gram); break;
                case 8: gram_pass_t<8>(colp, means, n, rs, gram); break;
                default: done = 0;
            }
            if (!done) {
                for (Py_ssize_t a = 0; a < mc; ++a) {
                    const double *pa = colp[a];
                    for (Py_ssize_t b = a; b < mc; ++b) {
                        const double *pb = colp[b];
                        double g = col_cdot(pa, pb, means[a], means[b], n,
                                            m.rstride, m.rstride);
                        gram[a * mc + b] = g;
                        gram[b * mc + a] = g;
                    }
                }
            }
            double pvar_tol = (double)(n - 1) * MACHINE_TOL;
            for (Py_ssize_t j = 0; j < dn; ++j) {
                int32_t yi = yidx[j];
                int32_t k = indptr[j + 1] - indptr[j];
                const int32_t *p = pidx + indptr[j];
                double *beta = betas + j * bcols;
                flags[j] = 1;
                if (k == 0) {
                    beta[0] = means[yi];
                    vars[j] = gram[yi * mc + yi] / (double)(n - 1);
                    continue;
                }
                double b[32], gy[32];
                if (k > 32) { flags[j] = 0; continue; }
                for (int t = 0; t < k; ++t) gy[t] = gram[p[t] * mc + yi];
                if (k == 1) {
                    double v1 = gram[p[0] * mc + p[0]];
                    if (v1 < pvar_tol) { flags[j] = 0; continue; }
                    b[0] = gy[0] / v1;
                } else if (k == 2) {
                    double v1 = gram[p[0] * mc + p[0]];
                    double v2 = gram[p[1] * mc + p[1]];
                    double c12 = gram[p[0] * mc + p[1]];
                    double det = v1 * v2 - c12 * c12;
                    if (v1 < pvar_tol || v2 < pvar_tol ||
                        det <= 1e3 * MACHINE_TOL * v1 * v2) {
                        flags[j] = 0;
                        continue;
                    }
                    b[0] = (v2 * gy[0] - c12 * gy[1]) / det;
                    b[1] = (v1 * gy[1] - c12 * gy[0]) / det;
                } else {
                    double s[32 * 32];
                    int bad = 0;
                    for (int a = 0; a < k; ++a) {
                        if (gram[p[a] * mc + p[a]] < pvar_tol) { bad = 1; break; }
                        for (int t = 0; t < k; ++t)
                            s[a * k + t] = gram[p[a] * mc + p[t]];
                    }
                    if (bad) { flags[j] = 0; continue; }
                    double dmin, dmax;
                    if (cholesky(s, k, &dmin, &dmax) < 0) { flags[j] = 0; continue; }
                    double r = dmin / dmax;
                    if (r * r < 1e3 * MACHINE_TOL) { flags[j] = 0; continue; }
                    memcpy(b, gy, (size_t)k * sizeof(double));
                    /* forward/back substitution with L in s */
                    for (int i = 0; i < k; ++i) {
                        double v = b[i];
                        for (int t = 0; t < i; ++t) v -= s[i * k + t] * b[t];
                        b[i] = v / s[i * k + i];
                    }
                    for (int i = k - 1; i >= 0; --i) {
                        double v = b[i];
                        for (int t = i + 1; t < k; ++t) v -= s[t * k + i] * b[t];
                        b[i] = v / s[i * k + i];
                    }
                    int fin = 1;
                    for (int t = 0; t < k; ++t)
                        if (!isfinite(b[t])) fin = 0;
                    if (!fin) { flags[j] = 0; continue; }
                }
                double rss = gram[yi * mc + yi];
                for (int t = 0; t < k; ++t) rss -= b[t] * gy[t];
                if (!isfinite(rss) || rss < 0.0) { flags[j] = 0; continue; }
                double b0 = means[yi];
                for (int t = 0; t < k; ++t) b0 -= b[t] * means[p[t]];
                beta[0] = b0;
                for (int t = 0; t < k; ++t) beta[t + 1] = b[t];
                vars[j] = rss / (double)(n - k - 1);
            }
        }
        PyBuffer_Release(&vf); PyBuffer_Release(&vv); PyBuffer_Release(&vb);
        PyBuffer_Release(&vpi); PyBuffer_Release(&vip); PyBuffer_Release(&vy);
        PyBuffer_Release(&vuse); PyBuffer_Release(&vmat);
        return PyLong_FromLong(rc);
    }
fail7: PyBuffer_Release(&vv);
fail6: PyBuffer_Release(&vb);
fail5: PyBuffer_Release(&vpi);
fail4: PyBuffer_Release(&vip);
fail3: PyBuffer_Release(&vy);
fail2: PyBuffer_Release(&vuse);
    PyBuffer_Release(&vmat);
    return NULL;
}

/* ------------------------------------------------------------------ slogl */

/* lgf_slogl(mat, yidx, indptr, pidx, betas, vars) -> float
 *
 * Sum log-likelihood of every node's family over mat rows; indices are DF
 * column positions. Returns NaN when the data contains NaN (caller falls
 * back to the generic path, which owns null semantics).
 */
static PyObject *lgf_slogl(PyObject *self, PyObject *const *args,
                           Py_ssize_t nargs) {
    /* optional 7th arg: (dn,) float64 out — receives PER-NODE slogl so the
     * model total can be formed as the exact left-to-right Python sum of
     * factor slogl values (reference BNGeneric::slogl is literally that
     * sum, and its test asserts bitwise equality). */
    if (nargs != 6 && nargs != 7) {
        PyErr_SetString(PyExc_TypeError, "lgf_slogl expects 6 or 7 args");
        return NULL;
    }
    Py_buffer vmat, vy, vip, vpi, vb, vv;
    Py_buffer vout;
    double *per_node = NULL;
    MatView m;
    if (get_mat(args[0], &vmat, &m) < 0) return NULL;
    if (get_1d(args[1], &vy, 4) < 0) { PyBuffer_Release(&vmat); return NULL; }
    if (get_1d(args[2], &vip, 4) < 0) goto sfail3;
    if (get_1d(args[3], &vpi, 4) < 0) goto sfail4;
    if (get_2d_c(args[4], &vb) < 0) goto sfail5;
    if (get_1d(args[5], &vv, 8) < 0) goto sfail6;
    if (nargs == 7) {
        if (get_1d(args[6], &vout, 8) < 0) {
            PyBuffer_Release(&vv);
            goto sfail6;
        }
        per_node = (double *)vout.buf;
    }
    {
        const int32_t *yidx = (const int32_t *)vy.buf;
        const int32_t *indptr = (const int32_t *)vip.buf;
        const int32_t *pidx = (const int32_t *)vpi.buf;
        const double *betas = (const double *)vb.buf;
        const double *vars = (const double *)vv.buf;
        Py_ssize_t dn = vy.len / 4;
        Py_ssize_t bcols = vb.shape[1];
        Py_ssize_t n = m.n, rs = m.rstride;
        double total = 0.0;

        for (Py_ssize_t j = 0; j < dn; ++j) {
            const double *y = COLP(&m, yidx[j]);
            int32_t k = indptr[j + 1] - indptr[j];
            const int32_t *p = pidx + indptr[j];
            const double *beta = betas + j * bcols;
            double var = vars[j];
            double sse;
#ifdef __SSE2__
            if (rs == 1 && k <= 2) {
                const double *x1 = k >= 1 ? COLP(&m, p[0]) : NULL;
                const double *x2 = k >= 2 ? COLP(&m, p[1]) : NULL;
                __m128d vb0 = _mm_set1_pd(beta[0]);
                __m128d vb1 = _mm_set1_pd(k >= 1 ? beta[1] : 0.0);
                __m128d vb2 = _mm_set1_pd(k >= 2 ? beta[2] : 0.0);
                __m128d s0 = _mm_setzero_pd(), s1 = _mm_setzero_pd();
                Py_ssize_t i = 0;
                if (k == 0) {
                    for (; i + 4 <= n; i += 4) {
                        __m128d r0 = _mm_sub_pd(_mm_loadu_pd(y + i), vb0);
                        __m128d r1 = _mm_sub_pd(_mm_loadu_pd(y + i + 2), vb0);
                        s0 = _mm_add_pd(s0, _mm_mul_pd(r0, r0));
                        s1 = _mm_add_pd(s1, _mm_mul_pd(r1, r1));
                    }
                } else if (k == 1) {
                    for (; i + 4 <= n; i += 4) {
                        __m128d r0 = _mm_sub_pd(
                            _mm_sub_pd(_mm_loadu_pd(y + i), vb0),
                            _mm_mul_pd(vb1, _mm_loadu_pd(x1 + i)));
                        __m128d r1 = _mm_sub_pd(
                            _mm_sub_pd(_mm_loadu_pd(y + i + 2), vb0),
                            _mm_mul_pd(vb1, _mm_loadu_pd(x1 + i + 2)));
                        s0 = _mm_add_pd(s0, _mm_mul_pd(r0, r0));
                        s1 = _mm_add_pd(s1, _mm_mul_pd(r1, r1));
                    }
                } else {
                    for (; i + 4 <= n; i += 4) {
                        __m128d r0 = _mm_sub_pd(
                            _mm_sub_pd(
                                _mm_sub_pd(_mm_loadu_pd(y + i), vb0),
                                _mm_mul_pd(vb1, _mm_loadu_pd(x1 + i))),
                            _mm_mul_pd(vb2, _mm_loadu_pd(x2 + i)));
                        __m128d r1 = _mm_sub_pd(
                            _mm_sub_pd(
                                _mm_sub_pd(_mm_loadu_pd(y + i + 2), vb0),
                                _mm_mul_pd(vb1, _mm_loadu_pd(x1 + i + 2))),
                            _mm_mul_pd(vb2, _mm_loadu_pd(x2 + i + 2)));
                        s0 = _mm_add_pd(s0, _mm_mul_pd(r0, r0));
                        s1 = _mm_add_pd(s1, _mm_mul_pd(r1, r1));
                    }
                }
                double lo[2], hi[2];
                _mm_storeu_pd(lo, s0);
                _mm_storeu_pd(hi, s1);
                double a = (lo[0] + lo[1]) + (hi[0] + hi[1]);
                for (; i < n; ++i) {
                    double r = y[i] - beta[0];
                    if (k >= 1) r -= beta[1] * x1[i];
                    if (k >= 2) r -= beta[2] * x2[i];
                    a += r * r;
                }
                sse = a;
            } else
#endif
            if (k == 0) {
                double b0 = beta[0];
                double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
                Py_ssize_t i = 0;
                for (; i + 4 <= n; i += 4) {
                    double r0 = y[(i + 0) * rs] - b0;
                    double r1 = y[(i + 1) * rs] - b0;
                    double r2 = y[(i + 2) * rs] - b0;
                    double r3 = y[(i + 3) * rs] - b0;
                    a0 += r0 * r0; a1 += r1 * r1; a2 += r2 * r2; a3 += r3 * r3;
                }
                for (; i < n; ++i) {
                    double r = y[i * rs] - b0;
                    a0 += r * r;
                }
                sse = (a0 + a1) + (a2 + a3);
            } else if (k == 1) {
                const double *x = COLP(&m, p[0]);
                double b0 = beta[0], b1 = beta[1];
                double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
                Py_ssize_t i = 0;
                for (; i + 4 <= n; i += 4) {
                    double r0 = y[(i + 0) * rs] - b0 - b1 * x[(i + 0) * rs];
                    double r1 = y[(i + 1) * rs] - b0 - b1 * x[(i + 1) * rs];
                    double r2 = y[(i + 2) * rs] - b0 - b1 * x[(i + 2) * rs];
                    double r3 = y[(i + 3) * rs] - b0 - b1 * x[(i + 3) * rs];
                    a0 += r0 * r0; a1 += r1 * r1; a2 += r2 * r2; a3 += r3 * r3;
                }
                for (; i < n; ++i) {
                    double r = y[i * rs] - b0 - b1 * x[i * rs];
                    a0 += r * r;
                }
                sse = (a0 + a1) + (a2 + a3);
            } else if (k == 2) {
                const double *x1 = COLP(&m, p[0]);
                const double *x2 = COLP(&m, p[1]);
                double b0 = beta[0], b1 = beta[1], b2 = beta[2];
                double a0 = 0, a1 = 0;
                Py_ssize_t i = 0;
                for (; i + 2 <= n; i += 2) {
                    double r0 = y[(i + 0) * rs] - b0 - b1 * x1[(i + 0) * rs] -
                                b2 * x2[(i + 0) * rs];
                    double r1 = y[(i + 1) * rs] - b0 - b1 * x1[(i + 1) * rs] -
                                b2 * x2[(i + 1) * rs];
                    a0 += r0 * r0;
                    a1 += r1 * r1;
                }
                for (; i < n; ++i) {
                    double r = y[i * rs] - b0 - b1 * x1[i * rs] - b2 * x2[i * rs];
                    a0 += r * r;
                }
                sse = a0 + a1;
            } else {
                double a0 = 0;
                for (Py_ssize_t i = 0; i < n; ++i) {
                    double r = y[i * rs] - beta[0];
                    for (int t = 0; t < k; ++t)
                        r -= beta[t + 1] * COLP(&m, p[t])[i * rs];
                    a0 += r * r;
                }
                sse = a0;
            }
            double node_sll = (double)n * (-0.5 * (LOG_2PI + log(var))) -
                              0.5 * sse / var;
            if (per_node) per_node[j] = node_sll;
            total += node_sll;
        }
        if (per_node) PyBuffer_Release(&vout);
        PyBuffer_Release(&vv); PyBuffer_Release(&vb); PyBuffer_Release(&vpi);
        PyBuffer_Release(&vip); PyBuffer_Release(&vy); PyBuffer_Release(&vmat);
        return PyFloat_FromDouble(total);
    }
sfail6: PyBuffer_Release(&vb);
sfail5: PyBuffer_Release(&vpi);
sfail4: PyBuffer_Release(&vip);
sfail3: PyBuffer_Release(&vy);
    PyBuffer_Release(&vmat);
    return NULL;
}

/* ----------------------------------------------------------------- sample */

typedef struct { uint64_t s; } Xrng;

static inline uint64_t xnext(Xrng *r) {
    uint64_t x = r->s;
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    r->s = x;
    return x * 0x2545F4914F6CDD1DULL;
}

static inline double xuniform(Xrng *r) {
    return (double)(xnext(r) >> 11) * (1.0 / 9007199254740992.0);
}

/* Ziggurat standard normals (Marsaglia & Tsang 2000, 128 layers): ~97%
 * of draws are one table lookup + compare + multiply. */
static uint32_t zig_kn[128];
static double zig_wn[128], zig_fn[128];

static void zig_init(void) {
    const double m1 = 2147483648.0; /* 2^31 */
    double dn = 3.442619855899, tn = dn;
    const double vn = 9.91256303526217e-3;
    double q = vn / exp(-0.5 * dn * dn);
    zig_kn[0] = (uint32_t)((dn / q) * m1);
    zig_kn[1] = 0;
    zig_wn[0] = q / m1;
    zig_wn[127] = dn / m1;
    zig_fn[0] = 1.0;
    zig_fn[127] = exp(-0.5 * dn * dn);
    for (int i = 126; i >= 1; --i) {
        dn = sqrt(-2.0 * log(vn / dn + exp(-0.5 * dn * dn)));
        zig_kn[i + 1] = (uint32_t)((dn / tn) * m1);
        tn = dn;
        zig_fn[i] = exp(-0.5 * dn * dn);
        zig_wn[i] = dn / m1;
    }
}

static double zig_nfix(Xrng *r, int32_t hz, int iz) {
    const double rr = 3.442619855899;
    for (;;) {
        double x = hz * zig_wn[iz];
        if (iz == 0) { /* base-strip tail: exact exponential rejection */
            double y;
            do {
                x = -log(xuniform(r)) / rr;
                y = -log(xuniform(r));
            } while (y + y < x * x);
            return (hz > 0) ? rr + x : -rr - x;
        }
        if (zig_fn[iz] + xuniform(r) * (zig_fn[iz - 1] - zig_fn[iz]) <
            exp(-0.5 * x * x))
            return x;
        hz = (int32_t)xnext(r);
        iz = hz & 127;
        uint32_t ahz = hz < 0 ? (uint32_t)(-(int64_t)hz) : (uint32_t)hz;
        if (ahz < zig_kn[iz]) return hz * zig_wn[iz];
    }
}

static inline double xnormal(Xrng *r) {
    int32_t hz = (int32_t)xnext(r);
    int iz = hz & 127;
    uint32_t ahz = hz < 0 ? (uint32_t)(-(int64_t)hz) : (uint32_t)hz;
    return (ahz < zig_kn[iz]) ? hz * zig_wn[iz] : zig_nfix(r, hz, iz);
}

/* lgf_sample(topo, indptr, pidx, betas, vars, m, seed, out) -> None
 *
 * topo:   (dn,) int32, node ids in topological order
 * indptr/pidx: CSR parents in NODE-ID space (rows of `out`)
 * betas:  (dn, kmax+1) float64, vars: (dn,)
 * out:    (dn, m) float64 C-contig; row j receives node j's draws
 *
 * Ancestral sampling with a deterministic per-seed stream. The stream is
 * implementation-defined (contract: deterministic per seed, per-variable
 * identical across `ordered` flags — reference BNGeneric::sample:1024).
 */
static PyObject *lgf_sample(PyObject *self, PyObject *const *args,
                            Py_ssize_t nargs) {
    if (nargs != 8) {
        PyErr_SetString(PyExc_TypeError, "lgf_sample expects 8 args");
        return NULL;
    }
    Py_buffer vt, vip, vpi, vb, vv, vo;
    Py_ssize_t mrows = PyLong_AsSsize_t(args[5]);
    uint64_t seed = (uint64_t)PyLong_AsUnsignedLongLongMask(args[6]);
    if (mrows < 0 && PyErr_Occurred()) return NULL;
    if (get_1d(args[0], &vt, 4) < 0) return NULL;
    if (get_1d(args[1], &vip, 4) < 0) goto pfail2;
    if (get_1d(args[2], &vpi, 4) < 0) goto pfail3;
    if (get_2d_c(args[3], &vb) < 0) goto pfail4;
    if (get_1d(args[4], &vv, 8) < 0) goto pfail5;
    if (get_2d_c(args[7], &vo) < 0) goto pfail6;
    {
        const int32_t *topo = (const int32_t *)vt.buf;
        const int32_t *indptr = (const int32_t *)vip.buf;
        const int32_t *pidx = (const int32_t *)vpi.buf;
        const double *betas = (const double *)vb.buf;
        const double *vars = (const double *)vv.buf;
        double *out = (double *)vo.buf;
        Py_ssize_t dn = vt.len / 4;
        Py_ssize_t bcols = vb.shape[1];

        Xrng rng;
        rng.s = seed * 0x9E3779B97F4A7C15ULL + 0x2545F4914F6CDD1DULL;
        if (!rng.s) rng.s = 0x9E3779B97F4A7C15ULL;
        /* warm the state so nearby seeds decorrelate */
        xnext(&rng); xnext(&rng);

        for (Py_ssize_t t = 0; t < dn; ++t) {
            int32_t j = topo[t];
            int32_t k = indptr[j + 1] - indptr[j];
            const int32_t *p = pidx + indptr[j];
            const double *beta = betas + j * bcols;
            double sd = sqrt(vars[j]);
            double *row = out + (Py_ssize_t)j * mrows;
            if (k == 0) {
                for (Py_ssize_t i = 0; i < mrows; ++i)
                    row[i] = beta[0] + sd * xnormal(&rng);
            } else {
                for (Py_ssize_t i = 0; i < mrows; ++i) {
                    double mu = beta[0];
                    for (int q = 0; q < k; ++q)
                        mu += beta[q + 1] * out[(Py_ssize_t)p[q] * mrows + i];
                    row[i] = mu + sd * xnormal(&rng);
                }
            }
        }
        PyBuffer_Release(&vo); PyBuffer_Release(&vv); PyBuffer_Release(&vb);
        PyBuffer_Release(&vpi); PyBuffer_Release(&vip); PyBuffer_Release(&vt);
        Py_RETURN_NONE;
    }
pfail6: PyBuffer_Release(&vv);
pfail5: PyBuffer_Release(&vb);
pfail4: PyBuffer_Release(&vpi);
pfail3: PyBuffer_Release(&vip);
pfail2: PyBuffer_Release(&vt);
    return NULL;
}

/* ------------------------------------------------------- KMI local shuffle */

/* lgf_local_shuffle(x_rank, neighbors, S, seed, out) -> None
 *
 * x_rank:    (n,) float64 ranked values
 * neighbors: (n, m) int32 — each row's m nearest z-neighbours
 * out:       (S, n) float64 — S locally-shuffled, re-ranked draws
 *
 * The CMIknn local permutation scheme (Runge 2018; reference
 * shuffle_dataframe, mutual_information.hpp:119-160): visit rows in random
 * order, swap each row's value with a random unused z-neighbour (jitter on
 * collision), then re-rank. The Python loop costs ~0.5 s per 1000 draws at
 * n=1000; this runs the whole batch in ~10 ms with a deterministic
 * per-seed stream shared by the serial and batched p-value paths.
 */
static PyObject *lgf_local_shuffle(PyObject *self, PyObject *const *args,
                                   Py_ssize_t nargs) {
    if (nargs != 5) {
        PyErr_SetString(PyExc_TypeError, "lgf_local_shuffle expects 5 args");
        return NULL;
    }
    Py_ssize_t S = PyLong_AsSsize_t(args[2]);
    uint64_t seed = (uint64_t)PyLong_AsUnsignedLongLongMask(args[3]);
    if (S < 0 && PyErr_Occurred()) return NULL;
    Py_buffer vx, vn, vo;
    if (PyObject_GetBuffer(args[0], &vx, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    if (PyObject_GetBuffer(args[1], &vn, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&vx);
        return NULL;
    }
    if (PyObject_GetBuffer(args[4], &vo, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&vn); PyBuffer_Release(&vx);
        return NULL;
    }
    {
        const double *xr = (const double *)vx.buf;
        const int32_t *nb = (const int32_t *)vn.buf;
        double *out = (double *)vo.buf;
        Py_ssize_t n = vx.len / 8;
        Py_ssize_t m = (vn.ndim == 2) ? vn.shape[1] : 0;

        Xrng rng;
        rng.s = seed * 0x9E3779B97F4A7C15ULL + 0xD1B54A32D192ED03ULL;
        if (!rng.s) rng.s = 0x9E3779B97F4A7C15ULL;
        xnext(&rng); xnext(&rng);

        int32_t *order = (int32_t *)PyMem_Malloc(n * sizeof(int32_t));
        int32_t *cand = (int32_t *)PyMem_Malloc((m > 0 ? m : 1) * sizeof(int32_t));
        uint8_t *used = (uint8_t *)PyMem_Malloc(n);
        double *shuf = (double *)PyMem_Malloc(n * sizeof(double));
        int32_t *idxs = (int32_t *)PyMem_Malloc(n * sizeof(int32_t));
        if (!order || !cand || !used || !shuf || !idxs) {
            PyMem_Free(order); PyMem_Free(cand); PyMem_Free(used);
            PyMem_Free(shuf); PyMem_Free(idxs);
            PyBuffer_Release(&vo); PyBuffer_Release(&vn); PyBuffer_Release(&vx);
            return PyErr_NoMemory();
        }
        for (Py_ssize_t s = 0; s < S; ++s) {
            /* Fisher-Yates visit order */
            for (Py_ssize_t i = 0; i < n; ++i) order[i] = (int32_t)i;
            for (Py_ssize_t i = n - 1; i > 0; --i) {
                Py_ssize_t j = (Py_ssize_t)(xnext(&rng) % (uint64_t)(i + 1));
                int32_t t = order[i]; order[i] = order[j]; order[j] = t;
            }
            memset(used, 0, n);
            for (Py_ssize_t oi = 0; oi < n; ++oi) {
                const int32_t idx = order[oi];
                const int32_t *row = nb + (Py_ssize_t)idx * m;
                for (Py_ssize_t j = 0; j < m; ++j) cand[j] = row[j];
                for (Py_ssize_t i = m - 1; i > 0; --i) {
                    Py_ssize_t j =
                        (Py_ssize_t)(xnext(&rng) % (uint64_t)(i + 1));
                    int32_t t = cand[i]; cand[i] = cand[j]; cand[j] = t;
                }
                int32_t pick = cand[m - 1];
                for (Py_ssize_t j = 0; j < m; ++j)
                    if (!used[cand[j]]) { pick = cand[j]; break; }
                if (used[pick])
                    shuf[idx] = xr[pick] + (xuniform(&rng) * 0.8 - 0.4);
                else
                    shuf[idx] = xr[pick];
                used[pick] = 1;
            }
            /* re-rank: stable argsort then inverse */
            for (Py_ssize_t i = 0; i < n; ++i) idxs[i] = (int32_t)i;
            std::stable_sort(idxs, idxs + n, [&](int32_t a, int32_t b) {
                return shuf[a] < shuf[b];
            });
            double *dst = out + s * n;
            for (Py_ssize_t i = 0; i < n; ++i)
                dst[idxs[i]] = (double)i;
        }
        PyMem_Free(order); PyMem_Free(cand); PyMem_Free(used);
        PyMem_Free(shuf); PyMem_Free(idxs);
        PyBuffer_Release(&vo); PyBuffer_Release(&vn); PyBuffer_Release(&vx);
        Py_RETURN_NONE;
    }
}

/* ----------------------------------------------------------------- module */

static PyMethodDef methods[] = {
    {"lgf_fit", (PyCFunction)(void (*)(void))lgf_fit, METH_FASTCALL, NULL},
    {"lgf_slogl", (PyCFunction)(void (*)(void))lgf_slogl, METH_FASTCALL, NULL},
    {"lgf_sample", (PyCFunction)(void (*)(void))lgf_sample, METH_FASTCALL, NULL},
    {"lgf_local_shuffle", (PyCFunction)(void (*)(void))lgf_local_shuffle,
     METH_FASTCALL, NULL},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "lgfast", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit_lgfast(void) {
    zig_init();
    return PyModule_Create(&moduledef);
}
