// Native graph core: bitset adjacency algorithms for the host side of
// structure search.
//
// The reference implements its graph layer in C++ (graph/generic_graph.hpp);
// this is the TPU build's native equivalent for the operations that are hot
// on the host during search: reachability / transitive closure (the
// acyclicity checks of ArcOperatorSet::find_max, operators.hpp:488-560),
// topological sort, and Meek-rule closure support. Exposed as a C ABI for
// ctypes; a pure-numpy fallback lives in pybnesian_tpu/graph/closure.py.
//
// Representation: n x words row-major bitset adjacency, words = ceil(n/64);
// bit j of row i set <=> arc i -> j.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// out = transitive closure (reachability, excluding trivial self loops unless
// present). Warshall over 64-bit words: O(n^2 * words).
void gc_transitive_closure(int n, int words, const uint64_t* adj,
                           uint64_t* out) {
    std::memcpy(out, adj, sizeof(uint64_t) * static_cast<size_t>(n) * words);
    for (int k = 0; k < n; ++k) {
        const uint64_t* row_k = out + static_cast<size_t>(k) * words;
        const int wk = k >> 6;
        const uint64_t bk = 1ULL << (k & 63);
        for (int i = 0; i < n; ++i) {
            uint64_t* row_i = out + static_cast<size_t>(i) * words;
            if (row_i[wk] & bk) {
                for (int w = 0; w < words; ++w) row_i[w] |= row_k[w];
            }
        }
    }
}

// 1 if a path src ~> dst exists (BFS over bitset rows).
int gc_has_path(int n, int words, const uint64_t* adj, int src, int dst) {
    if (src == dst) return 1;
    std::vector<uint64_t> visited(words, 0), frontier(words, 0);
    frontier[src >> 6] |= 1ULL << (src & 63);
    const int wd = dst >> 6;
    const uint64_t bd = 1ULL << (dst & 63);
    while (true) {
        std::vector<uint64_t> next(words, 0);
        bool any = false;
        for (int i = 0; i < n; ++i) {
            if (frontier[i >> 6] & (1ULL << (i & 63))) {
                const uint64_t* row = adj + static_cast<size_t>(i) * words;
                for (int w = 0; w < words; ++w) {
                    uint64_t nb = row[w] & ~visited[w];
                    if (nb) {
                        next[w] |= nb;
                        any = true;
                    }
                }
            }
        }
        if (next[wd] & bd) return 1;
        if (!any) return 0;
        for (int w = 0; w < words; ++w) {
            visited[w] |= next[w];
        }
        frontier.swap(next);
    }
}

// Kahn topological sort. Returns 0 on success (order filled with node ids),
// -1 if the graph has a cycle.
int gc_topological_sort(int n, int words, const uint64_t* adj, int* order) {
    std::vector<int> indegree(n, 0);
    for (int i = 0; i < n; ++i) {
        const uint64_t* row = adj + static_cast<size_t>(i) * words;
        for (int w = 0; w < words; ++w) {
            uint64_t bits = row[w];
            while (bits) {
                int j = (w << 6) + __builtin_ctzll(bits);
                bits &= bits - 1;
                if (j < n) ++indegree[j];
            }
        }
    }
    std::vector<int> stack;
    stack.reserve(n);
    for (int i = n - 1; i >= 0; --i) {
        if (indegree[i] == 0) stack.push_back(i);
    }
    int pos = 0;
    while (!stack.empty()) {
        int i = stack.back();
        stack.pop_back();
        order[pos++] = i;
        const uint64_t* row = adj + static_cast<size_t>(i) * words;
        for (int w = 0; w < words; ++w) {
            uint64_t bits = row[w];
            while (bits) {
                int j = (w << 6) + __builtin_ctzll(bits);
                bits &= bits - 1;
                if (j < n && --indegree[j] == 0) stack.push_back(j);
            }
        }
    }
    return pos == n ? 0 : -1;
}

// Batched add-arc legality for hill climbing: for every (s, t) pair, legal[s*n+t]=1
// iff adding s->t keeps the graph acyclic (no existing path t ~> s) and s != t.
// One closure computation amortizes all n^2 candidate checks
// (replaces per-candidate has_path, reference operators.hpp:488-560).
void gc_add_arc_legality(int n, int words, const uint64_t* adj,
                         uint8_t* legal) {
    std::vector<uint64_t> closure(static_cast<size_t>(n) * words);
    gc_transitive_closure(n, words, adj, closure.data());
    for (int s = 0; s < n; ++s) {
        for (int t = 0; t < n; ++t) {
            if (s == t) {
                legal[static_cast<size_t>(s) * n + t] = 0;
                continue;
            }
            const uint64_t* row_t = closure.data() + static_cast<size_t>(t) * words;
            bool path_t_to_s = row_t[s >> 6] & (1ULL << (s & 63));
            legal[static_cast<size_t>(s) * n + t] = path_t_to_s ? 0 : 1;
        }
    }
}

}  // extern "C"
