// Native host-side sparse preprocessing for the operator containers.
//
// The device compute path is JAX/XLA; this library is the runtime
// around it: converting host CSR/BSR matrices into the fixed-width padded
// layouts the device SpMVs consume (ops/sparse.py), bandwidth-reducing
// RCM reordering, diagonal (banded/stencil) extraction, and nnz-balanced
// row partitioning for the mesh. These are O(nnz) pointer-chasing loops —
// the wrong shape for numpy and far too slow as Python loops at the
// 10M-row scale the benchmarks target (BASELINE config #5).
//
// The reference has no native source of its own (its native boundary is
// LAPACK ccalls, SURVEY.md §2); this component is new runtime work.
//
// ABI: plain C, int64_t sizes/indptr, int32_t column indices, explicit
// f32/f64 instantiations. All buffers are caller-allocated (numpy).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- ELL pack

// Max nonzeros per row (the required ELL width).
int64_t csr_max_degree(const int64_t* indptr, int64_t n) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i)
        w = std::max(w, indptr[i + 1] - indptr[i]);
    return w;
}

}  // extern "C"

template <typename T>
static void csr_to_ell_impl(int64_t n, int64_t w, const int64_t* indptr,
                            const int32_t* indices, const T* data,
                            T* out_vals, int32_t* out_cols) {
    // Padded slots stay (value 0, col 0): gather-safe.
    std::memset(out_vals, 0, sizeof(T) * n * w);
    std::memset(out_cols, 0, sizeof(int32_t) * n * w);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t lo = indptr[i], hi = indptr[i + 1];
        T* vrow = out_vals + i * w;
        int32_t* crow = out_cols + i * w;
        for (int64_t k = lo; k < hi; ++k) {
            vrow[k - lo] = data[k];
            crow[k - lo] = indices[k];
        }
    }
}

extern "C" {

void csr_to_ell_f64(int64_t n, int64_t w, const int64_t* indptr,
                    const int32_t* indices, const double* data,
                    double* out_vals, int32_t* out_cols) {
    csr_to_ell_impl<double>(n, w, indptr, indices, data, out_vals, out_cols);
}

void csr_to_ell_f32(int64_t n, int64_t w, const int64_t* indptr,
                    const int32_t* indices, const float* data,
                    float* out_vals, int32_t* out_cols) {
    csr_to_ell_impl<float>(n, w, indptr, indices, data, out_vals, out_cols);
}

// ------------------------------------------------------------ BlockELL pack

// Pack BSR (block-CSR: nbr block rows, (br*bc)-sized dense blocks) into
// fixed-width blocked ELL. Padded block slots are zero blocks at bcol 0.
}  // extern "C"

template <typename T>
static void bsr_to_blockell_impl(int64_t nbr, int64_t w, int64_t bsz,
                                 const int64_t* indptr,
                                 const int32_t* indices, const T* data,
                                 T* out_blocks, int32_t* out_bcols) {
    std::memset(out_blocks, 0, sizeof(T) * nbr * w * bsz);
    std::memset(out_bcols, 0, sizeof(int32_t) * nbr * w);
    for (int64_t i = 0; i < nbr; ++i) {
        const int64_t lo = indptr[i], hi = indptr[i + 1];
        for (int64_t k = lo; k < hi; ++k) {
            std::memcpy(out_blocks + (i * w + (k - lo)) * bsz,
                        data + k * bsz, sizeof(T) * bsz);
            out_bcols[i * w + (k - lo)] = indices[k];
        }
    }
}

extern "C" {

void bsr_to_blockell_f64(int64_t nbr, int64_t w, int64_t bsz,
                         const int64_t* indptr, const int32_t* indices,
                         const double* data, double* out_blocks,
                         int32_t* out_bcols) {
    bsr_to_blockell_impl<double>(nbr, w, bsz, indptr, indices, data,
                                 out_blocks, out_bcols);
}

void bsr_to_blockell_f32(int64_t nbr, int64_t w, int64_t bsz,
                         const int64_t* indptr, const int32_t* indices,
                         const float* data, float* out_blocks,
                         int32_t* out_bcols) {
    bsr_to_blockell_impl<float>(nbr, w, bsz, indptr, indices, data,
                                out_blocks, out_bcols);
}

// ----------------------------------------------------- banded extraction

// Extract diagonal storage: diags[k][i] = A[i, i + offsets[k]].
// Entries at columns not covered by `offsets` are counted in *out_dropped
// so the caller can reject a lossy conversion.
}  // extern "C"

template <typename T>
static void csr_to_banded_impl(int64_t n, int64_t noff,
                               const int64_t* offsets, const int64_t* indptr,
                               const int32_t* indices, const T* data,
                               T* out_diags, int64_t* out_dropped) {
    std::memset(out_diags, 0, sizeof(T) * noff * n);
    // offset -> slot lookup over the (small) band range
    int64_t omin = 0, omax = 0;
    for (int64_t k = 0; k < noff; ++k) {
        omin = std::min(omin, offsets[k]);
        omax = std::max(omax, offsets[k]);
    }
    std::vector<int64_t> slot(omax - omin + 1, -1);
    for (int64_t k = 0; k < noff; ++k) slot[offsets[k] - omin] = k;
    int64_t dropped = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            const int64_t o = (int64_t)indices[k] - i;
            if (o < omin || o > omax || slot[o - omin] < 0) {
                ++dropped;
                continue;
            }
            out_diags[slot[o - omin] * n + i] = data[k];
        }
    }
    *out_dropped = dropped;
}

extern "C" {

void csr_to_banded_f64(int64_t n, int64_t noff, const int64_t* offsets,
                       const int64_t* indptr, const int32_t* indices,
                       const double* data, double* out_diags,
                       int64_t* out_dropped) {
    csr_to_banded_impl<double>(n, noff, offsets, indptr, indices, data,
                               out_diags, out_dropped);
}

void csr_to_banded_f32(int64_t n, int64_t noff, const int64_t* offsets,
                       const int64_t* indptr, const int32_t* indices,
                       const float* data, float* out_diags,
                       int64_t* out_dropped) {
    csr_to_banded_impl<float>(n, noff, offsets, indptr, indices, data,
                              out_diags, out_dropped);
}

// Distinct offsets present in a CSR matrix (for automatic banded
// conversion). Returns the count; writes up to max_out offsets sorted
// ascending. A return of -1 means more than max_out distinct offsets.
int64_t csr_band_offsets(int64_t n, const int64_t* indptr,
                         const int32_t* indices, int64_t* out_offsets,
                         int64_t max_out) {
    std::vector<int64_t> offs;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            const int64_t o = (int64_t)indices[k] - i;
            auto it = std::lower_bound(offs.begin(), offs.end(), o);
            if (it == offs.end() || *it != o) {
                if ((int64_t)offs.size() >= max_out) return -1;
                offs.insert(it, o);
            }
        }
    }
    for (size_t k = 0; k < offs.size(); ++k) out_offsets[k] = offs[k];
    return (int64_t)offs.size();
}

// ------------------------------------------------------------ RCM ordering

// Reverse Cuthill–McKee bandwidth-reducing permutation of a symmetric
// pattern. perm[new_index] = old_index.
void rcm_ordering(int64_t n, const int64_t* indptr, const int32_t* indices,
                  int32_t* perm) {
    std::vector<int64_t> degree(n);
    for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
    std::vector<char> visited(n, 0);
    std::vector<int32_t> order;
    order.reserve(n);
    std::vector<int32_t> nbrs;

    for (int64_t comp = 0; comp < n; ++comp) {
        if (visited[comp]) continue;
        // Start each component at its minimum-degree unvisited vertex.
        int64_t start = comp;
        for (int64_t i = comp + 1; i < n; ++i)
            if (!visited[i] && degree[i] < degree[start]) start = i;
        visited[start] = 1;
        order.push_back((int32_t)start);
        for (size_t head = order.size() - 1; head < order.size(); ++head) {
            const int64_t u = order[head];
            nbrs.clear();
            for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
                const int32_t v = indices[k];
                if (!visited[v]) {
                    visited[v] = 1;
                    nbrs.push_back(v);
                }
            }
            std::sort(nbrs.begin(), nbrs.end(),
                      [&](int32_t a, int32_t b) {
                          return degree[a] < degree[b];
                      });
            for (int32_t v : nbrs) order.push_back(v);
        }
    }
    // Reverse for RCM.
    for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

// ----------------------------------------------------- row partitioning

// Contiguous nnz-balanced partition of n rows into p parts: writes p+1
// boundaries (0 = first, n = last) minimizing the maximum part nnz,
// via binary search on the bottleneck + greedy fill.
void balance_partition(int64_t n, int64_t p, const int64_t* indptr,
                       int64_t* out_bounds) {
    const int64_t total = indptr[n];
    int64_t lo = 0, hi = total;
    // max single row
    for (int64_t i = 0; i < n; ++i)
        lo = std::max(lo, indptr[i + 1] - indptr[i]);
    auto feasible = [&](int64_t cap) {
        int64_t parts = 1, startnnz = 0;
        for (int64_t i = 0; i < n; ++i) {
            const int64_t end = indptr[i + 1];
            if (end - startnnz > cap) {
                ++parts;
                startnnz = indptr[i];
                if (end - startnnz > cap) return false;
            }
        }
        return parts <= p;
    };
    while (lo < hi) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (feasible(mid)) hi = mid; else lo = mid + 1;
    }
    const int64_t cap = lo;
    out_bounds[0] = 0;
    int64_t part = 0, startnnz = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (indptr[i + 1] - startnnz > cap) {
            out_bounds[++part] = i;
            startnnz = indptr[i];
        }
    }
    for (int64_t q = part + 1; q <= p; ++q) out_bounds[q] = n;
}

}  // extern "C"

// ------------------------------------------------------------- SELL pack
// Plan + fill for the SELL-window layout (ops/sell.py): rows
// grouped in 128s (row-per-lane), v = ceil(maxdeg/8) tiles of (8, 128)
// per group, per-group aligned x-window. Two-call protocol so the caller
// owns all allocations:
//   sell_plan  -> group_ptr (G+1), win_row (G); returns total tiles T,
//                 or -(g+1) if group g's columns exceed its window.
//   sell_fill_* -> vals (T,8,128), lidx (T,8,128) filled in one pass.

extern "C" {

// group_ptr: (G+1); win_row: per 8-group BLOCK (B = ceil(G/8)).
int64_t sell_plan(int64_t n, int64_t window, const int64_t* indptr,
                  const int32_t* indices, int32_t* group_ptr,
                  int32_t* win_row) {
    const int64_t G = (n + 127) / 128;
    const int64_t B = (G + 7) / 8;
    group_ptr[0] = 0;
    for (int64_t b = 0; b < B; ++b) {
        const int64_t rb0 = b * 8 * 128;
        const int64_t rb1 = std::min(n, rb0 + 8 * 128);
        int64_t cmin = INT64_MAX, cmax = -1;
        for (int64_t k = indptr[rb0]; k < indptr[rb1]; ++k) {
            cmin = std::min<int64_t>(cmin, indices[k]);
            cmax = std::max<int64_t>(cmax, indices[k]);
        }
        int64_t ws = 0;
        if (cmax >= 0) {
            ws = (cmin / 128) * 128;
            if (cmax >= ws + window) return -(b + 1);
        }
        win_row[b] = (int32_t)(ws / 128);
        for (int64_t g = b * 8; g < std::min(G, (b + 1) * 8); ++g) {
            const int64_t r0 = g * 128;
            const int64_t r1 = std::min(n, r0 + 128);
            int64_t maxdeg = 0;
            for (int64_t r = r0; r < r1; ++r)
                maxdeg = std::max(maxdeg, indptr[r + 1] - indptr[r]);
            const int64_t v = std::max<int64_t>(1, (maxdeg + 7) / 8);
            group_ptr[g + 1] = group_ptr[g] + (int32_t)v;
        }
    }
    return group_ptr[G];
}

}  // extern "C"

template <typename T>
static void sell_fill_impl(int64_t n, const int64_t* indptr,
                           const int32_t* indices, const T* data,
                           const int32_t* group_ptr, const int32_t* win_row,
                           int64_t T_tiles, T* vals, int32_t* lidx) {
    std::memset(vals, 0, sizeof(T) * T_tiles * 8 * 128);
    std::memset(lidx, 0, sizeof(int32_t) * T_tiles * 8 * 128);
    for (int64_t r = 0; r < n; ++r) {
        const int64_t g = r / 128;
        const int64_t lane = r % 128;
        const int64_t t0 = group_ptr[g];
        const int32_t ws = win_row[g / 8] * 128;
        int64_t i = 0;
        for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k, ++i) {
            const int64_t t = t0 + i / 8;
            const int64_t s = i % 8;
            vals[(t * 8 + s) * 128 + lane] = data[k];
            lidx[(t * 8 + s) * 128 + lane] = indices[k] - ws;
        }
    }
}

extern "C" {

void sell_fill_f32(int64_t n, const int64_t* indptr, const int32_t* indices,
                   const float* data, const int32_t* group_ptr,
                   const int32_t* win_row, int64_t T_tiles, float* vals,
                   int32_t* lidx) {
    sell_fill_impl<float>(n, indptr, indices, data, group_ptr, win_row,
                          T_tiles, vals, lidx);
}

void sell_fill_f64(int64_t n, const int64_t* indptr, const int32_t* indices,
                   const double* data, const int32_t* group_ptr,
                   const int32_t* win_row, int64_t T_tiles, double* vals,
                   int32_t* lidx) {
    sell_fill_impl<double>(n, indptr, indices, data, group_ptr, win_row,
                           T_tiles, vals, lidx);
}

}  // extern "C"

// ---------------------------------------------------- SELL rowsel pack
// Per-sublane window-row binding: every (tile, sublane) is assigned ONE
// window row qrow; slot (s, lane) may hold any nnz of row `lane` whose
// window row equals qrow_s. qrow is stored in the index high bits
// (li = qrow<<7 | r), so no extra metadata stream exists.
//
// Greedy multiset choice per tile: repeatedly pick the window row with
// the largest marginal coverage (#rows whose remaining count in that
// window row exceeds its current multiplicity in the tile).

#include <array>

namespace {

struct RowselPlan {
    // per group: tile count; deterministic greedy shared by plan & fill
};

template <typename T, bool FILL>
int64_t rowsel_group(int64_t n, int64_t g, const int64_t* indptr,
                     const int32_t* indices, const T* data, int64_t ws,
                     int64_t wrows, int64_t tile0, T* vals, int32_t* lidx) {
    const int64_t r0 = g * 128;
    const int64_t r1 = std::min(n, r0 + 128);
    const int64_t L = r1 - r0;
    // remaining per (local row, window row) as index lists
    // counts c[l][rho]; positions pos[l][rho] = next unplaced nnz index
    std::array<std::array<int16_t, 64>, 128> cnt{};
    std::array<std::array<int32_t, 64>, 128> pos{};
    int64_t remaining = 0;
    for (int64_t l = 0; l < L; ++l) {
        const int64_t r = r0 + l;
        for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k) {
            const int64_t rho = (indices[k] - ws) >> 7;
            if (cnt[l][rho] == 0) pos[l][rho] = (int32_t)k;
            cnt[l][rho]++;
            remaining++;
        }
    }
    int64_t t = 0;
    while (remaining > 0) {
        // greedy qrow multiset for this tile
        int16_t mult[64] = {0};
        int8_t qrow[8];
        for (int s = 0; s < 8; ++s) {
            int64_t best_rho = 0, best_cov = -1;
            for (int64_t rho = 0; rho < wrows; ++rho) {
                int64_t cov = 0;
                for (int64_t l = 0; l < L; ++l)
                    if (cnt[l][rho] > mult[rho]) ++cov;
                if (cov > best_cov) { best_cov = cov; best_rho = rho; }
            }
            qrow[s] = (int8_t)best_rho;
            mult[best_rho]++;
        }
        // Default index for every slot: (qrow_s << 7) | 0 — padded slots
        // MUST stay on their sublane's bound window row so the two-step
        // gather's per-sublane row uniformity holds (their value is 0).
        if (FILL) {
            for (int s = 0; s < 8; ++s)
                for (int64_t l = 0; l < 128; ++l)
                    lidx[((tile0 + t) * 8 + s) * 128 + l] =
                        (int32_t)((int64_t)qrow[s] << 7);
        }
        // place: per row, per sublane, one remaining nnz of that qrow
        for (int64_t l = 0; l < L; ++l) {
            for (int s = 0; s < 8; ++s) {
                const int64_t rho = qrow[s];
                if (cnt[l][rho] > 0) {
                    // consume the nnz at pos[l][rho] (CSR is column
                    // sorted; entries of one window row are contiguous)
                    const int64_t k = pos[l][rho];
                    if (FILL) {
                        const int64_t slot =
                            ((tile0 + t) * 8 + s) * 128 + l;
                        vals[slot] = data[k];
                        lidx[slot] = (int32_t)(((int64_t)rho << 7)
                                               | ((indices[k] - ws) & 127));
                    }
                    pos[l][rho] = (int32_t)(k + 1);
                    cnt[l][rho]--;
                    remaining--;
                }
            }
        }
        ++t;
    }
    return t == 0 ? 1 : t;
}

}  // namespace

extern "C" {

// Plan: group_ptr (G+1), win_row (B,) out; returns T or -(block+1).
int64_t sell_rowsel_plan(int64_t n, int64_t window, const int64_t* indptr,
                         const int32_t* indices, int32_t* group_ptr,
                         int32_t* win_row) {
    const int64_t G = (n + 127) / 128;
    const int64_t B = (G + 7) / 8;
    const int64_t wrows = window / 128;
    if (wrows > 64) return -1000000;   // qrow field limit
    group_ptr[0] = 0;
    for (int64_t b = 0; b < B; ++b) {
        const int64_t rb0 = b * 8 * 128;
        const int64_t rb1 = std::min(n, rb0 + 8 * 128);
        int64_t cmin = INT64_MAX, cmax = -1;
        for (int64_t k = indptr[rb0]; k < indptr[rb1]; ++k) {
            cmin = std::min<int64_t>(cmin, indices[k]);
            cmax = std::max<int64_t>(cmax, indices[k]);
        }
        int64_t ws = 0;
        if (cmax >= 0) {
            ws = (cmin / 128) * 128;
            if (cmax >= ws + window) return -(b + 1);
        }
        win_row[b] = (int32_t)(ws / 128);
        for (int64_t g = b * 8; g < std::min(G, (b + 1) * 8); ++g) {
            const int64_t v = rowsel_group<float, false>(
                n, g, indptr, indices, nullptr, ws, wrows, 0, nullptr,
                nullptr);
            group_ptr[g + 1] = group_ptr[g] + (int32_t)v;
        }
    }
    return group_ptr[G];
}

void sell_rowsel_fill_f32(int64_t n, int64_t window, const int64_t* indptr,
                          const int32_t* indices, const float* data,
                          const int32_t* group_ptr, const int32_t* win_row,
                          int64_t T_tiles, float* vals, int32_t* lidx) {
    const int64_t G = (n + 127) / 128;
    const int64_t wrows = window / 128;
    std::memset(vals, 0, sizeof(float) * T_tiles * 8 * 128);
    std::memset(lidx, 0, sizeof(int32_t) * T_tiles * 8 * 128);
    for (int64_t g = 0; g < G; ++g) {
        const int64_t ws = (int64_t)win_row[g / 8] * 128;
        rowsel_group<float, true>(n, g, indptr, indices, data, ws, wrows,
                                  group_ptr[g], vals, lidx);
    }
}

void sell_rowsel_fill_f64(int64_t n, int64_t window, const int64_t* indptr,
                          const int32_t* indices, const double* data,
                          const int32_t* group_ptr, const int32_t* win_row,
                          int64_t T_tiles, double* vals, int32_t* lidx) {
    const int64_t G = (n + 127) / 128;
    const int64_t wrows = window / 128;
    std::memset(vals, 0, sizeof(double) * T_tiles * 8 * 128);
    std::memset(lidx, 0, sizeof(int32_t) * T_tiles * 8 * 128);
    for (int64_t g = 0; g < G; ++g) {
        const int64_t ws = (int64_t)win_row[g / 8] * 128;
        rowsel_group<double, true>(n, g, indptr, indices, data, ws, wrows,
                                   group_ptr[g], vals, lidx);
    }
}

}  // extern "C"
