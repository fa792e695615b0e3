// Exact std::sort permutation service.
//
// The reference pipeline's output depends on the *unstable* permutation
// libstdc++'s std::sort applies to tie groups (e.g. anchors sharing an
// anchor-x sorted descending, src/pmpfinder.cpp:2465; block pointers
// sharing a cord-x, src/cluster_util.cpp:558; equal-score chain trees,
// src/cluster_util.cpp:269).  On repeat-rich genomes those ties decide
// which repeat copy a read maps to, so bit-identical output requires the
// identical permutation.  Every such call site sorts by a single derived
// integer key, so the host engine precomputes the keys and sorts an index
// array here with the very same std::sort + comparator — by construction
// the same swap sequence the reference executes on its element arrays.
#include <algorithm>
#include <cstdint>
#include <functional>

extern "C" {

// Sort idx[0..n) with comparator keys[a] < keys[b] (asc) or > (desc).
void lt_sort_idx_i64(int64_t* idx, const int64_t* keys, int64_t n, int desc) {
    if (desc) {
        std::sort(idx, idx + n, [keys](int64_t a, int64_t b) { return keys[a] > keys[b]; });
    } else {
        std::sort(idx, idx + n, [keys](int64_t a, int64_t b) { return keys[a] < keys[b]; });
    }
}

// Sort u64 values in place by full value (asc/desc); tie groups carry
// equal values so the permutation within them is immaterial, but having
// the native path keeps big sorts out of Python.
void lt_sort_u64(uint64_t* vals, int64_t n, int desc) {
    if (desc) {
        std::sort(vals, vals + n, std::greater<uint64_t>());
    } else {
        std::sort(vals, vals + n);
    }
}

}  // extern "C"
