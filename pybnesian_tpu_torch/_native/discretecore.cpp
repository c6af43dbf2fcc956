// Native discrete-family scoring core.
//
// The reference counts contingency tables in C++ (discrete_indices.cpp
// joint_counts, mle_DiscreteFactor.cpp:5-42) and scores BIC/BDe from them
// (scores/bic.cpp:66-97). This is the TPU-native build's equivalent native
// tier: hill-climbing batches of small discrete families finish faster in
// one compiled pass over the cached codes than either a per-family numpy
// pipeline (allocation-bound) or a remote device dispatch (~25 ms round
// trip). Large batches still go to the device scatter-count kernel
// (ops/discrete.py) — this kernel is the small/medium tier of the same
// adaptive dispatch.
//
// Families are independent, so sufficiently large batches split across
// two hardware threads (the counting pass is memory-stream-bound; the
// host gives near-linear scaling to its core count).
//
// Codes layout: one int32 array per column, -1 marks null; rows with a
// null in any family column are dropped (pairwise deletion, matching
// data/dataframe.py semantics).
//
// Build: g++ -O3 -march=native -pthread -shared -fPIC discretecore.cpp -o
//        libdiscretecore.so   (auto-built on first use, like graphcore)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// kind 0: BIC (log count ratios + penalty). kind 1: BDe with uniform
// iss prior alpha = iss / config_space (reference scores/bde.cpp).
void family_range(const int32_t* codes, int64_t n, const int64_t* cards,
                  const int32_t* fam_var, const int32_t* fam_parents,
                  int32_t f_begin, int32_t f_end, int32_t maxp,
                  int64_t max_configs, int32_t kind, double iss,
                  double* out) {
    std::vector<int64_t> counts;
    std::vector<const int32_t*> col(1 + maxp);
    std::vector<int64_t> stride(1 + maxp);
    for (int f = f_begin; f < f_end; ++f) {
        const int32_t v = fam_var[f];
        int nv = 1;
        col[0] = codes + (int64_t)v * n;
        stride[0] = 1;
        int64_t config_space = cards[v];
        const int64_t k = cards[v];
        for (int j = 0; j < maxp; ++j) {
            const int32_t p = fam_parents[(int64_t)f * maxp + j];
            if (p < 0) break;
            col[nv] = codes + (int64_t)p * n;
            stride[nv] = config_space;
            config_space *= cards[p];
            ++nv;
        }
        if (config_space > max_configs) {
            out[f] = NAN;
            continue;
        }
        counts.assign(config_space, 0);
        int64_t total = 0;
        if (nv == 1) {
            const int32_t* c0 = col[0];
            for (int64_t i = 0; i < n; ++i) {
                const int32_t a = c0[i];
                if (a >= 0) { ++counts[a]; ++total; }
            }
        } else if (nv == 2) {
            const int32_t* c0 = col[0];
            const int32_t* c1 = col[1];
            const int64_t s1 = stride[1];
            for (int64_t i = 0; i < n; ++i) {
                const int32_t a = c0[i], b = c1[i];
                if ((a | b) >= 0) { ++counts[a + s1 * b]; ++total; }
            }
        } else if (nv == 3) {
            const int32_t* c0 = col[0];
            const int32_t* c1 = col[1];
            const int32_t* c2 = col[2];
            const int64_t s1 = stride[1], s2 = stride[2];
            for (int64_t i = 0; i < n; ++i) {
                const int32_t a = c0[i], b = c1[i], c = c2[i];
                if ((a | b | c) >= 0) {
                    ++counts[a + s1 * b + s2 * c];
                    ++total;
                }
            }
        } else {
            for (int64_t i = 0; i < n; ++i) {
                int64_t idx = 0;
                bool ok = true;
                for (int j = 0; j < nv; ++j) {
                    const int32_t cij = col[j][i];
                    if (cij < 0) { ok = false; break; }
                    idx += stride[j] * cij;
                }
                if (ok) { ++counts[idx]; ++total; }
            }
        }
        const int64_t npc = config_space / k;
        if (kind == 1) {
            // BDe: sum over ALL cells/configs — empty cells contribute
            // lgamma(alpha) which the -space*lgamma(alpha) term cancels,
            // empty configs contribute 0 (scores/bde.cpp semantics)
            const double alpha = iss / (double)config_space;
            const double sum_alpha = alpha * (double)k;
            const double lg_a = std::lgamma(alpha);
            const double lg_sa = std::lgamma(sum_alpha);
            double res = -(double)config_space * lg_a;
            for (int64_t pc = 0; pc < npc; ++pc) {
                int64_t tot = 0;
                const int64_t* row = counts.data() + pc * k;
                for (int64_t j = 0; j < k; ++j) {
                    const int64_t c = row[j];
                    tot += c;
                    res += c > 0 ? std::lgamma((double)c + alpha) : lg_a;
                }
                if (tot > 0)
                    res += lg_sa - std::lgamma(sum_alpha + (double)tot);
            }
            out[f] = res;
            continue;
        }
        if (total == 0) {
            // every row null in some family column: route to the caller's
            // fallback tier (which raises, like the host path's log(0))
            out[f] = NAN;
            continue;
        }
        // ll = sum n_ijk * (log n_ijk - log n_ij); penalty over the FULL
        // parent-config space (scores/bic.cpp:66-97)
        double ll = 0.0;
        for (int64_t pc = 0; pc < npc; ++pc) {
            int64_t tot = 0;
            const int64_t* row = counts.data() + pc * k;
            for (int64_t j = 0; j < k; ++j) tot += row[j];
            if (tot == 0) continue;
            const double lt = std::log((double)tot);
            for (int64_t j = 0; j < k; ++j) {
                if (row[j] > 0)
                    ll += (double)row[j] * (std::log((double)row[j]) - lt);
            }
        }
        out[f] = ll - std::log((double)total) * 0.5 * (double)(k - 1)
                          * (double)npc;
    }
}

// Shared-base candidate scoring: families (t, P ∪ {s}) for one target t,
// one base parent set P and many candidate sources s share the (t, P)
// configuration index, so ONE pass over the rows counts every candidate —
// the memory reads drop from (2+|P|)·nc per row to (1+|P|)+nc. This is
// the hc column-update shape (reference operators.cpp:100-180 rescores
// exactly these families after an operator applies).
void addcand_range(const int32_t* codes, int64_t n, const int64_t* cards,
                   int32_t tcol, const int32_t* base, int32_t nb,
                   const int32_t* cand, int32_t c_begin, int32_t c_end,
                   int64_t max_configs, double* out) {
    const int32_t* tcodes = codes + (int64_t)tcol * n;
    const int64_t k = cards[tcol];
    int64_t bs = k;
    std::vector<const int32_t*> bcol(nb);
    std::vector<int64_t> bstride(nb);
    for (int j = 0; j < nb; ++j) {
        bcol[j] = codes + (int64_t)base[j] * n;
        bstride[j] = bs;
        bs *= cards[base[j]];
    }
    const int nc = c_end - c_begin;
    std::vector<const int32_t*> ccol(nc);
    std::vector<int64_t> off(nc);
    std::vector<int64_t> tot(nc, 0);
    std::vector<char> active(nc, 1);
    int64_t buf_size = 0;
    for (int f = 0; f < nc; ++f) {
        const int32_t s = cand[c_begin + f];
        ccol[f] = codes + (int64_t)s * n;
        const int64_t space = bs * cards[s];
        if (space > max_configs) {
            active[f] = 0;
            out[c_begin + f] = NAN;
            off[f] = -1;
            continue;
        }
        off[f] = buf_size;
        buf_size += space;
    }
    std::vector<int64_t> counts(buf_size, 0);
    int64_t* cnt = counts.data();
    for (int64_t i = 0; i < n; ++i) {
        int32_t t = tcodes[i];
        int32_t acc = t;
        int64_t bidx = t;
        for (int j = 0; j < nb; ++j) {
            const int32_t bj = bcol[j][i];
            acc |= bj;
            bidx += bstride[j] * bj;
        }
        if (acc < 0) continue;  // null in (t, P): row invalid for all fams
        for (int f = 0; f < nc; ++f) {
            const int32_t c = ccol[f][i];
            if (c >= 0 && active[f]) {
                ++cnt[off[f] + bidx + bs * c];
                ++tot[f];
            }
        }
    }
    for (int f = 0; f < nc; ++f) {
        if (!active[f]) continue;
        if (tot[f] == 0) {
            out[c_begin + f] = NAN;
            continue;
        }
        const int64_t space = bs * cards[cand[c_begin + f]];
        const int64_t npc = space / k;
        const int64_t* c0 = cnt + off[f];
        double ll = 0.0;
        for (int64_t pc = 0; pc < npc; ++pc) {
            int64_t rt = 0;
            const int64_t* row = c0 + pc * k;
            for (int64_t j = 0; j < k; ++j) rt += row[j];
            if (rt == 0) continue;
            const double lt = std::log((double)rt);
            for (int64_t j = 0; j < k; ++j)
                if (row[j] > 0)
                    ll += (double)row[j] * (std::log((double)row[j]) - lt);
        }
        out[c_begin + f] = ll - std::log((double)tot[f]) * 0.5 *
                                    (double)(k - 1) * (double)npc;
    }
}

// Pearson χ² statistics for F conditional tests x ⊥ y | Z over the code
// block (reference discrete/chi_square.cpp). Layout per test: counts flat
// index = x + c1·y + c1·c2·(Z config), matching the Python serial path
// (create_cardinality_strides puts the tested variable fastest).
void chi2_range(const int32_t* codes, int64_t n, const int64_t* cards,
                const int32_t* tx, const int32_t* ty, const int32_t* tz,
                int32_t f_begin, int32_t f_end, int32_t maxz,
                int64_t max_configs, double* out) {
    std::vector<int64_t> counts;
    std::vector<const int32_t*> col(2 + maxz);
    std::vector<int64_t> stride(2 + maxz);
    std::vector<double> mx, my;
    for (int f = f_begin; f < f_end; ++f) {
        col[0] = codes + (int64_t)tx[f] * n;
        col[1] = codes + (int64_t)ty[f] * n;
        const int64_t c1 = cards[tx[f]];
        const int64_t c2 = cards[ty[f]];
        stride[0] = 1;
        stride[1] = c1;
        int64_t space = c1 * c2;
        int nv = 2;
        for (int j = 0; j < maxz; ++j) {
            const int32_t zc = tz[(int64_t)f * maxz + j];
            if (zc < 0) break;
            col[nv] = codes + (int64_t)zc * n;
            stride[nv] = space;
            space *= cards[zc];
            ++nv;
        }
        if (space > max_configs) {
            out[f] = NAN;
            continue;
        }
        counts.assign(space, 0);
        if (nv == 2) {
            const int32_t* cx = col[0];
            const int32_t* cy = col[1];
            for (int64_t i = 0; i < n; ++i) {
                const int32_t a = cx[i], b = cy[i];
                if ((a | b) >= 0) ++counts[a + c1 * b];
            }
        } else if (nv == 3) {
            const int32_t* cx = col[0];
            const int32_t* cy = col[1];
            const int32_t* cz = col[2];
            const int64_t s2 = stride[2];
            for (int64_t i = 0; i < n; ++i) {
                const int32_t a = cx[i], b = cy[i], c = cz[i];
                if ((a | b | c) >= 0) ++counts[a + c1 * b + s2 * c];
            }
        } else {
            for (int64_t i = 0; i < n; ++i) {
                int64_t idx = 0;
                bool ok = true;
                for (int j = 0; j < nv; ++j) {
                    const int32_t cij = col[j][i];
                    if (cij < 0) { ok = false; break; }
                    idx += stride[j] * cij;
                }
                if (ok) ++counts[idx];
            }
        }
        const int64_t zcfg = space / (c1 * c2);
        mx.assign(c1, 0.0);
        my.assign(c2, 0.0);
        double stat = 0.0;
        for (int64_t k = 0; k < zcfg; ++k) {
            const int64_t* tab = counts.data() + k * c1 * c2;
            double total = 0.0;
            for (int64_t x = 0; x < c1; ++x) mx[x] = 0.0;
            for (int64_t y = 0; y < c2; ++y) {
                double rs = 0.0;
                for (int64_t x = 0; x < c1; ++x) {
                    const double v = (double)tab[x + c1 * y];
                    rs += v;
                    mx[x] += v;
                }
                my[y] = rs;
                total += rs;
            }
            if (total == 0.0) continue;
            for (int64_t y = 0; y < c2; ++y)
                for (int64_t x = 0; x < c1; ++x) {
                    const double e = my[y] * mx[x] / total;
                    if (e > 0.0) {
                        const double dlt = (double)tab[x + c1 * y] - e;
                        stat += dlt * dlt / e;
                    }
                }
        }
        out[f] = stat;
    }
}

// G-test statistics (2·N·MI = Σ c_xyz·log(n_z·c_xyz/(c_xz·c_yz)), here
// returned as N·MI to match MutualInformation.pvalue's gammaincc call) for
// F all-discrete conditional MI tests (reference
// hybrid/mutual_information.cpp cmi_discrete_discrete). Same count layout
// as chi2_range; also emits the per-test valid-row count.
void gtest_range(const int32_t* codes, int64_t n, const int64_t* cards,
                 const int32_t* tx, const int32_t* ty, const int32_t* tz,
                 int32_t f_begin, int32_t f_end, int32_t maxz,
                 int64_t max_configs, double* out, double* out_n) {
    std::vector<int64_t> counts;
    std::vector<const int32_t*> col(2 + maxz);
    std::vector<int64_t> stride(2 + maxz);
    std::vector<double> mx, my;
    for (int f = f_begin; f < f_end; ++f) {
        col[0] = codes + (int64_t)tx[f] * n;
        col[1] = codes + (int64_t)ty[f] * n;
        const int64_t c1 = cards[tx[f]];
        const int64_t c2 = cards[ty[f]];
        stride[0] = 1;
        stride[1] = c1;
        int64_t space = c1 * c2;
        int nv = 2;
        for (int j = 0; j < maxz; ++j) {
            const int32_t zc = tz[(int64_t)f * maxz + j];
            if (zc < 0) break;
            col[nv] = codes + (int64_t)zc * n;
            stride[nv] = space;
            space *= cards[zc];
            ++nv;
        }
        if (space > max_configs) {
            out[f] = NAN;
            out_n[f] = 0.0;
            continue;
        }
        counts.assign(space, 0);
        int64_t totn = 0;
        if (nv == 2) {
            const int32_t* cx = col[0];
            const int32_t* cy = col[1];
            for (int64_t i = 0; i < n; ++i) {
                const int32_t a = cx[i], b = cy[i];
                if ((a | b) >= 0) { ++counts[a + c1 * b]; ++totn; }
            }
        } else {
            for (int64_t i = 0; i < n; ++i) {
                int64_t idx = 0;
                bool ok = true;
                for (int j = 0; j < nv; ++j) {
                    const int32_t cij = col[j][i];
                    if (cij < 0) { ok = false; break; }
                    idx += stride[j] * cij;
                }
                if (ok) { ++counts[idx]; ++totn; }
            }
        }
        out_n[f] = (double)totn;
        const int64_t zcfg = space / (c1 * c2);
        mx.assign(c1, 0.0);
        my.assign(c2, 0.0);
        double stat = 0.0;  // N * MI
        for (int64_t k = 0; k < zcfg; ++k) {
            const int64_t* tab = counts.data() + k * c1 * c2;
            double nz_ = 0.0;
            for (int64_t x = 0; x < c1; ++x) mx[x] = 0.0;
            for (int64_t y = 0; y < c2; ++y) {
                double rs = 0.0;
                for (int64_t x = 0; x < c1; ++x) {
                    const double v = (double)tab[x + c1 * y];
                    rs += v;
                    mx[x] += v;
                }
                my[y] = rs;
                nz_ += rs;
            }
            if (nz_ == 0.0) continue;
            for (int64_t y = 0; y < c2; ++y)
                for (int64_t x = 0; x < c1; ++x) {
                    const double cxy = (double)tab[x + c1 * y];
                    if (cxy > 0.0)
                        stat += cxy * std::log(nz_ * cxy / (my[y] * mx[x]));
                }
        }
        out[f] = stat;
    }
}

// Grouped first/second moments for the hybrid-MI per-configuration
// covariance determinants (reference mutual_information.cpp:958-1033):
// TWO fused passes — counts+sums (→ group means), then products of
// group-CENTRED values — replacing ~d+d²/2 separate weighted-bincount
// sweeps on the Python side. Rows with valid==0 are skipped.
void grouped_moments(const double* vals, const int64_t* idx,
                     const uint8_t* valid, int64_t n, int32_t d,
                     int64_t n_configs, int64_t* counts, double* sums,
                     double* sq) {
    for (int64_t c = 0; c < n_configs; ++c) counts[c] = 0;
    for (int64_t c = 0; c < (int64_t)n_configs * d; ++c) sums[c] = 0.0;
    for (int64_t c = 0; c < (int64_t)n_configs * d * d; ++c) sq[c] = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        if (!valid[i]) continue;
        const int64_t c = idx[i];
        ++counts[c];
        const double* row = vals + i * d;
        double* s = sums + c * d;
        for (int32_t j = 0; j < d; ++j) s[j] += row[j];
    }
    // means in-place scratch: reuse a local buffer per config on pass 2
    std::vector<double> means((size_t)n_configs * d);
    for (int64_t c = 0; c < n_configs; ++c) {
        const double inv = counts[c] > 0 ? 1.0 / (double)counts[c] : 0.0;
        for (int32_t j = 0; j < d; ++j)
            means[c * d + j] = sums[c * d + j] * inv;
    }
    for (int64_t i = 0; i < n; ++i) {
        if (!valid[i]) continue;
        const int64_t c = idx[i];
        const double* row = vals + i * d;
        const double* m = means.data() + c * d;
        double* q = sq + c * d * d;
        double diff[16];
        for (int32_t j = 0; j < d; ++j) diff[j] = row[j] - m[j];
        for (int32_t j = 0; j < d; ++j)
            for (int32_t l = j; l < d; ++l)
                q[j * d + l] += diff[j] * diff[l];
    }
    for (int64_t c = 0; c < n_configs; ++c) {
        double* q = sq + c * d * d;
        for (int32_t j = 0; j < d; ++j)
            for (int32_t l = j + 1; l < d; ++l) q[l * d + j] = q[j * d + l];
    }
}

// ------------------------------------------------------------------ hc core
// Whole greedy hill-climbing loop for discrete-BIC ArcOperatorSet searches
// (the reference runs this loop in C++: operators.cpp:100-437 +
// hillclimbing.hpp:62-199). Mirrors the Python loop decision-for-decision:
//  - delta[s][t] = remove / flip / add score delta for the pair,
//    quantized at DELTA_RESOLUTION with ties-to-even (Python round());
//  - find_max walks deltas in descending order, ties by flat index
//    (np.argsort(-flat, kind="stable")), first LEGAL operator wins;
//  - after applying, only the changed node's column (+ flip-pair cells)
//    recomputes (ArcOperatorSet.update_scores).
// Returns the op sequence so the Python layer replays it on the model.

const double HC_MACHINE_TOL = 2.220446049250313e-16;
const double HC_DELTA_RES = 1e-9;  // operators.DELTA_RESOLUTION

double hc_quantize(double d) {
    if (!std::isfinite(d)) return d;
    return std::nearbyint(d / HC_DELTA_RES) * HC_DELTA_RES;  // ties-to-even
}

// BIC local score of one family; NaN on config-space overflow.
double score_one(const int32_t* codes, int64_t n, const int64_t* cards,
                 int32_t var, const int32_t* parents, int32_t np_,
                 int64_t max_configs, int32_t kind, double iss) {
    double out;
    // reuse the batched kernel on a single family
    std::vector<int32_t> fp(np_ > 0 ? np_ : 1, -1);
    for (int j = 0; j < np_; ++j) fp[j] = parents[j];
    family_range(codes, n, cards, &var, fp.data(), 0, 1,
                 np_ > 0 ? np_ : 1, max_configs, kind, iss, &out);
    return out;
}

struct HcGraph {
    int d;
    uint64_t padj[64];  // padj[t] bit s: arc s -> t (parents mask)
    uint64_t cadj[64];  // cadj[s] bit t: arc s -> t (children mask)

    bool has_arc(int s, int t) const { return (cadj[s] >> t) & 1ull; }
    void add(int s, int t) { cadj[s] |= 1ull << t; padj[t] |= 1ull << s; }
    void remove(int s, int t) {
        cadj[s] &= ~(1ull << t);
        padj[t] &= ~(1ull << s);
    }
    int num_parents(int t) const { return __builtin_popcountll(padj[t]); }
    bool has_path(int a, int b) const {  // length >= 1
        uint64_t frontier = cadj[a], seen = cadj[a];
        while (frontier) {
            if ((seen >> b) & 1ull) return true;
            uint64_t next = 0;
            uint64_t fr = frontier;
            while (fr) {
                int v = __builtin_ctzll(fr);
                fr &= fr - 1;
                next |= cadj[v];
            }
            frontier = next & ~seen;
            seen |= next;
        }
        return (seen >> b) & 1ull;
    }
};

struct HcState {
    const int32_t* codes;
    int64_t n;
    const int64_t* cards;
    const int32_t* node_cols;  // model node -> code-block column
    int d;
    int64_t max_configs;
    int32_t kind;  // 0 BIC, 1 BDe
    double iss;
    HcGraph g;
    double lc[64];         // local score cache per node
    double delta[64 * 64];
    const uint8_t* valid;
    bool overflow;

    double family_score(int t, uint64_t pmask) {
        int32_t ps[64];
        int np_ = 0;
        uint64_t m = pmask;
        while (m) {
            int s = __builtin_ctzll(m);
            m &= m - 1;
            ps[np_++] = node_cols[s];
        }
        double v = score_one(codes, n, cards, node_cols[t], ps, np_,
                             max_configs, kind, iss);
        if (std::isnan(v)) overflow = true;
        return v;
    }

    // delta of the operation encoded at cell (s, t), from CURRENT graph
    double cell_delta(int s, int t) {
        if (g.has_arc(s, t)) {  // remove
            double ns = family_score(t, g.padj[t] & ~(1ull << s));
            return ns - lc[t];
        }
        if (g.has_arc(t, s)) {  // flip t->s (op FlipArc(t, s))
            double ns = family_score(s, g.padj[s] & ~(1ull << t));
            double nt = family_score(t, g.padj[t] | (1ull << s));
            return ns + nt - lc[s] - lc[t];
        }
        double nt = family_score(t, g.padj[t] | (1ull << s));  // add
        return nt - lc[t];
    }

    void recompute_cell(int s, int t) {
        delta[s * d + t] = hc_quantize(cell_delta(s, t));
    }
};

}  // namespace

extern "C" {

// BIC local scores for F discrete families.
//  codes:       (ncols, n) row-major int32 block (column i at codes+i*n)
//  cards:       (ncols,) int64 cardinalities
//  fam_var:     (F,) column index of the child
//  fam_parents: (F, maxp) column indices, -1 padding
//  out:         (F,) scores; NaN when the config space exceeds max_configs
//               (caller falls back to another tier)
void dc_bic_batch(const int32_t* codes, int64_t n, int32_t ncols,
                  const int64_t* cards, const int32_t* fam_var,
                  const int32_t* fam_parents, int32_t F, int32_t maxp,
                  int64_t max_configs, double* out) {
    (void)ncols;
    unsigned hw = std::thread::hardware_concurrency();
    // thread spawn costs tens of µs — engage once a batch carries a few
    // hundred µs of counting (hc's initial n² sweep AND its per-iteration
    // column updates both qualify; 2-family cache refreshes do not)
    if (hw >= 2 && F >= 24 && (int64_t)F * n >= 300000) {
        const int32_t mid = F / 2;
        std::thread t1(family_range, codes, n, cards, fam_var, fam_parents,
                       0, mid, maxp, max_configs, 0, 1.0, out);
        family_range(codes, n, cards, fam_var, fam_parents, mid, F, maxp,
                     max_configs, 0, 1.0, out);
        t1.join();
    } else {
        family_range(codes, n, cards, fam_var, fam_parents, 0, F, maxp,
                     max_configs, 0, 1.0, out);
    }
}

// BDe local scores (uniform iss prior) for F discrete families — same
// contract as dc_bic_batch.
void dc_bde_batch(const int32_t* codes, int64_t n, int32_t ncols,
                  const int64_t* cards, const int32_t* fam_var,
                  const int32_t* fam_parents, int32_t F, int32_t maxp,
                  int64_t max_configs, double iss, double* out) {
    (void)ncols;
    unsigned hw = std::thread::hardware_concurrency();
    if (hw >= 2 && F >= 24 && (int64_t)F * n >= 300000) {
        const int32_t mid = F / 2;
        std::thread t1(family_range, codes, n, cards, fam_var, fam_parents,
                       0, mid, maxp, max_configs, 1, iss, out);
        family_range(codes, n, cards, fam_var, fam_parents, mid, F, maxp,
                     max_configs, 1, iss, out);
        t1.join();
    } else {
        family_range(codes, n, cards, fam_var, fam_parents, 0, F, maxp,
                     max_configs, 1, iss, out);
    }
}

// χ² statistics for F conditional tests (see chi2_range above). Same
// family-parallel two-thread split as dc_bic_batch.
void dc_chi2_batch(const int32_t* codes, int64_t n, const int64_t* cards,
                   const int32_t* tx, const int32_t* ty, const int32_t* tz,
                   int32_t F, int32_t maxz, int64_t max_configs,
                   double* out) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw >= 2 && F >= 24 && (int64_t)F * n >= 300000) {
        const int32_t mid = F / 2;
        std::thread t1(chi2_range, codes, n, cards, tx, ty, tz, 0, mid,
                       maxz, max_configs, out);
        chi2_range(codes, n, cards, tx, ty, tz, mid, F, maxz, max_configs,
                   out);
        t1.join();
    } else {
        chi2_range(codes, n, cards, tx, ty, tz, 0, F, maxz, max_configs,
                   out);
    }
}

// Grouped moments entry (see grouped_moments above). d capped at 16.
void dc_grouped_moments(const double* vals, const int64_t* idx,
                        const uint8_t* valid, int64_t n, int32_t d,
                        int64_t n_configs, int64_t* counts, double* sums,
                        double* sq) {
    if (d > 16) return;  // caller guards; keep diff[] on the stack
    grouped_moments(vals, idx, valid, n, d, n_configs, counts, sums, sq);
}

// N·MI G-test statistics + valid-row counts (see gtest_range above).
void dc_gtest_batch(const int32_t* codes, int64_t n, const int64_t* cards,
                    const int32_t* tx, const int32_t* ty, const int32_t* tz,
                    int32_t F, int32_t maxz, int64_t max_configs,
                    double* out, double* out_n) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw >= 2 && F >= 24 && (int64_t)F * n >= 300000) {
        const int32_t mid = F / 2;
        std::thread t1(gtest_range, codes, n, cards, tx, ty, tz, 0, mid,
                       maxz, max_configs, out, out_n);
        gtest_range(codes, n, cards, tx, ty, tz, mid, F, maxz, max_configs,
                    out, out_n);
        t1.join();
    } else {
        gtest_range(codes, n, cards, tx, ty, tz, 0, F, maxz, max_configs,
                    out, out_n);
    }
}

// Full discrete-BIC ArcOperatorSet hill-climbing (see HcState above).
//  node_cols: (d,) code-block column of each model node
//  adj:       (d,d) row-major uint8, adj[s*d+t] = start arc s->t
//  valid:     (d,d) uint8, operator-set valid mask (blacklist/whitelist)
//  out_ops:   (max_ops, 3) int32 — (kind, s, t); kind 0 add, 1 remove,
//             2 flip (op FlipArc(s=cell target? no: emitted as the
//             operator's (source, target) exactly as Python applies it)
// Returns op count; -1 = config-space overflow (caller runs the generic
// Python path); -2 = out_ops too small.
int32_t dc_hc(const int32_t* codes, int64_t n, const int64_t* cards,
              const int32_t* node_cols, int32_t d, uint8_t* adj,
              const uint8_t* valid, int32_t max_indegree,
              int64_t max_iters, double epsilon, int64_t max_configs,
              int32_t score_kind, double iss,
              int32_t* out_ops, int32_t max_ops) {
    if (d > 64) return -1;
    HcState st;
    st.codes = codes;
    st.n = n;
    st.cards = cards;
    st.node_cols = node_cols;
    st.d = d;
    st.max_configs = max_configs;
    st.kind = score_kind;
    st.iss = iss;
    st.valid = valid;
    st.overflow = false;
    st.g.d = d;
    for (int i = 0; i < 64; ++i) st.g.padj[i] = st.g.cadj[i] = 0;
    for (int s = 0; s < d; ++s)
        for (int t = 0; t < d; ++t)
            if (adj[s * d + t]) st.g.add(s, t);
    for (int t = 0; t < d; ++t) {
        st.lc[t] = st.family_score(t, st.g.padj[t]);
        if (st.overflow) return -1;
    }
    const double NEG_INF = -INFINITY;
    for (int s = 0; s < d; ++s)
        for (int t = 0; t < d; ++t) {
            if (valid[s * d + t])
                st.recompute_cell(s, t);
            else
                st.delta[s * d + t] = NEG_INF;
        }
    if (st.overflow) return -1;

    int32_t nops = 0;
    uint64_t rejected[64];
    for (int64_t iter = 0; iter < max_iters; ++iter) {
        // find_max: best delta, ties by flat index, first LEGAL wins
        for (int i = 0; i < d; ++i) rejected[i] = 0;
        int kind = -1, op_s = -1, op_t = -1;
        double op_delta = 0.0;
        for (;;) {
            int bs = -1, bt = -1;
            double best = NEG_INF;
            for (int s = 0; s < d; ++s)
                for (int t = 0; t < d; ++t) {
                    if (!valid[s * d + t]) continue;
                    if ((rejected[s] >> t) & 1ull) continue;
                    double v = st.delta[s * d + t];
                    if (v > best) {  // strict: ties keep smallest flat idx
                        best = v;
                        bs = s;
                        bt = t;
                    }
                }
            if (bs < 0 || !std::isfinite(best)) break;  // all -inf / none
            // legality of the operator at (bs, bt)
            if (st.g.has_arc(bs, bt)) {  // RemoveArc — always legal
                kind = 1; op_s = bs; op_t = bt; op_delta = best;
                break;
            }
            bool ok = false;
            if (st.g.has_arc(bt, bs)) {
                // FlipArc(bt, bs): legal iff flipping keeps a DAG and
                // max_indegree allows a new parent on bt... (the Python
                // check is num_parents(cell target=bt) >= max_indegree)
                bool can_flip;
                if (st.g.num_parents(bs) == 1 ||
                    __builtin_popcountll(st.g.cadj[bt]) == 1) {
                    can_flip = true;
                } else {
                    // path bt ~> bs avoiding the direct arc bt->bs
                    st.g.remove(bt, bs);
                    can_flip = !st.g.has_path(bt, bs);
                    st.g.add(bt, bs);
                }
                if (can_flip &&
                    !(max_indegree > 0 &&
                      st.g.num_parents(bt) >= max_indegree)) {
                    kind = 2; op_s = bt; op_t = bs; op_delta = best;
                    ok = true;
                }
            } else {
                // AddArc(bs, bt): no path bt ~> bs
                if (!st.g.has_path(bt, bs) &&
                    !(max_indegree > 0 &&
                      st.g.num_parents(bt) >= max_indegree)) {
                    kind = 0; op_s = bs; op_t = bt; op_delta = best;
                    ok = true;
                }
            }
            if (ok) break;
            rejected[bs] |= 1ull << bt;
            kind = -1;
        }
        if (kind < 0) break;                                // no operator
        if (op_delta - epsilon < HC_MACHINE_TOL) break;     // converged
        if (op_delta <= HC_MACHINE_TOL) break;  // zero-patience rollback
        if (nops >= max_ops) return -2;
        // apply
        int changed[2];
        int nchanged;
        if (kind == 0) {
            st.g.add(op_s, op_t);
            changed[0] = op_t;
            nchanged = 1;
        } else if (kind == 1) {
            st.g.remove(op_s, op_t);
            changed[0] = op_t;
            nchanged = 1;
        } else {
            st.g.remove(op_s, op_t);
            st.g.add(op_t, op_s);
            // FlipArc(source=op_s, target=op_t).nodes_changed = [s, t]
            changed[0] = op_s;
            changed[1] = op_t;
            nchanged = 2;
        }
        out_ops[nops * 3 + 0] = kind;
        out_ops[nops * 3 + 1] = op_s;
        out_ops[nops * 3 + 2] = op_t;
        ++nops;
        // update caches + affected delta cells (ArcOperatorSet.update_scores)
        for (int c = 0; c < nchanged; ++c) {
            int nd = changed[c];
            st.lc[nd] = st.family_score(nd, st.g.padj[nd]);
            if (st.overflow) return -1;
        }
        for (int c = 0; c < nchanged; ++c) {
            int nd = changed[c];
            for (int s = 0; s < d; ++s)
                if (valid[s * d + nd]) st.recompute_cell(s, nd);
            for (int t = 0; t < d; ++t)
                if (valid[nd * d + t] &&
                    (st.g.has_arc(nd, t) || st.g.has_arc(t, nd)))
                    st.recompute_cell(nd, t);
            if (st.overflow) return -1;
        }
    }
    return nops;
}

// BIC scores for nc families sharing target + base parents, one per
// candidate extra parent (see addcand_range above).
void dc_bic_addcand(const int32_t* codes, int64_t n, const int64_t* cards,
                    int32_t tcol, const int32_t* base, int32_t nb,
                    const int32_t* cand, int32_t nc, int64_t max_configs,
                    double* out) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw >= 2 && nc >= 6 && (int64_t)nc * n >= 120000) {
        const int32_t mid = nc / 2;
        std::thread t1(addcand_range, codes, n, cards, tcol, base, nb,
                       cand, 0, mid, max_configs, out);
        addcand_range(codes, n, cards, tcol, base, nb, cand, mid, nc,
                      max_configs, out);
        t1.join();
    } else {
        addcand_range(codes, n, cards, tcol, base, nb, cand, 0, nc,
                      max_configs, out);
    }
}

}  // extern "C"
