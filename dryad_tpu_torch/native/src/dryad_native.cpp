// dryad_tpu_torch native host layer: the quantile sketch and dense binning.
//
// The port's own copy of the reference's routines
// (dryad_tpu/native/src/dryad_native.cpp: sketch_numerical, bin_numerical,
// bin_categorical, bin_matrix).  Its tree traversal (tree_leaves,
// predict_accumulate) is not copied: it serves the reference's numpy
// predict backend, whose counterpart in the port is device="cpu" in torch.
//
// One departure: the sketch takes the column's finite values already
// sorted.  The reference sorts them here with std::sort, which numpy's
// vectorised sort beats several times over on the card's host; the bridge
// sorts with numpy (the same sort the numpy path runs) and this file keeps
// the dedup and the edges.
//
// BIT-IDENTITY CONTRACT: every routine reproduces the numpy path of
// dryad_tpu_torch/data/sketch.py bit for bit; the numpy path is the spec and
// this is the fast path (tests/test_torch_native.py diffs them).  All float
// work is float32 in numpy's op order.
//
// Built at first use by dryad_tpu_torch/native/__init__.py with
// g++ -O3 -fPIC -shared -std=c++17 (no dependencies), loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Bumped on any signature change: the loader refuses a library whose
// version differs instead of calling through a stale ABI.
int64_t dryad_abi_version() { return 2; }

// ---------------------------------------------------------------------------
// Numerical quantile sketch, as data/sketch.py::_sketch_numerical_np.
//   sorted: the column's n finite values, ascending
//   out_edges: caller-allocated, at least max_bins entries
//   returns the number of edges written (k); the feature has k + 2 bins
// ---------------------------------------------------------------------------
int64_t sketch_sorted(const float* sorted, int64_t n, int64_t max_bins,
                      float* out_edges) {
    if (n == 0) return 0;
    // distinct values (np.unique: the first of each run of equal values)
    int64_t n_distinct = 1;
    for (int64_t i = 1; i < n; ++i) {
        if (sorted[i] != sorted[i - 1]) ++n_distinct;
    }
    const int64_t max_edges = max_bins - 2;
    int64_t k = 0;
    if (n_distinct - 1 <= max_edges) {
        // midpoints between neighbours in float32, as numpy's
        // (a + b) * float32(0.5)
        float prev = sorted[0];
        for (int64_t i = 1; i < n; ++i) {
            if (sorted[i] != prev) {
                out_edges[k++] = (prev + sorted[i]) * 0.5f;
                prev = sorted[i];
            }
        }
    } else {
        // equal-frequency positions over the sorted sample, deduplicated
        float prev = 0.0f;
        bool has_prev = false;
        for (int64_t i = 1; i <= max_edges; ++i) {
            const int64_t pos = (i * n) / (max_edges + 1);
            const float e = sorted[pos];
            if (!has_prev || e != prev) {   // np.unique of ascending picks
                out_edges[k++] = e;
                prev = e;
                has_prev = true;
            }
        }
    }
    return k;
}

// ---------------------------------------------------------------------------
// Numerical binning: out[i] = 1 + lower_bound(edges, x); NaN -> 0, as
// BinMapper.transform_column's searchsorted(side='left') and missing rule.
// ---------------------------------------------------------------------------
void bin_numerical(const float* col, int64_t n, const float* edges,
                   int64_t n_edges, int32_t* out) {
    const float* lo = edges;
    const float* hi = edges + n_edges;
    for (int64_t i = 0; i < n; ++i) {
        const float x = col[i];
        if (std::isnan(x)) {
            out[i] = 0;
        } else {
            out[i] = 1 + (int32_t)(std::lower_bound(lo, hi, x) - lo);
        }
    }
}

// ---------------------------------------------------------------------------
// Categorical binning: a lookup in the value-sorted vocabulary; a miss
// takes the overflow bin, NaN bin 0 (transform_column's categorical arm).
// ---------------------------------------------------------------------------
void bin_categorical(const float* col, int64_t n, const float* cat_values,
                     const int32_t* cat_bins, int64_t n_cats,
                     int32_t overflow_bin, int32_t* out) {
    const float* lo = cat_values;
    const float* hi = cat_values + n_cats;
    for (int64_t i = 0; i < n; ++i) {
        const float x = col[i];
        if (std::isnan(x)) {
            out[i] = 0;
            continue;
        }
        if (n_cats == 0) {
            out[i] = overflow_bin;
            continue;
        }
        const float* it = std::lower_bound(lo, hi, x);
        if (it != hi && *it == x) {
            out[i] = cat_bins[it - lo];
        } else {
            out[i] = overflow_bin;
        }
    }
}

// ---------------------------------------------------------------------------
// Dense matrix binning, one feature at a time.
//   X: (n, F) row-major float32
//   edges_flat + edge_offsets[f..f+1]: feature f's edges
//   catv_flat/catb_flat + cat_offsets: categorical vocabularies
//   is_cat: per-feature flag;  overflow: per-feature overflow bin
//   out: (n, F) row-major uint16
// ---------------------------------------------------------------------------
void bin_matrix(const float* X, int64_t n, int64_t F,
                const float* edges_flat, const int64_t* edge_offsets,
                const float* catv_flat, const int32_t* catb_flat,
                const int64_t* cat_offsets, const uint8_t* is_cat,
                const int32_t* overflow, uint16_t* out) {
    std::vector<float> colbuf(n);
    std::vector<int32_t> outbuf(n);
    for (int64_t f = 0; f < F; ++f) {
        for (int64_t i = 0; i < n; ++i) colbuf[i] = X[i * F + f];
        if (is_cat[f]) {
            bin_categorical(colbuf.data(), n, catv_flat + cat_offsets[f],
                            catb_flat + cat_offsets[f],
                            cat_offsets[f + 1] - cat_offsets[f], overflow[f],
                            outbuf.data());
        } else {
            bin_numerical(colbuf.data(), n, edges_flat + edge_offsets[f],
                          edge_offsets[f + 1] - edge_offsets[f],
                          outbuf.data());
        }
        for (int64_t i = 0; i < n; ++i) out[i * F + f] = (uint16_t)outbuf[i];
    }
}

}  // extern "C"
