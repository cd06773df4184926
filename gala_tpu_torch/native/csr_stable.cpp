// Stable parallel counting sort of a COO edge list into dst-sorted CSR.
//
// The port's own source, built into one library with the verbatim copy
// csr_ops.cpp (whose coo_to_csr_i32 places each edge through an atomic
// per-row cursor, so a row's edge order follows thread timing).  Here the
// edges are cut into T contiguous chunks, one a thread; each thread counts
// its chunk's edges per row, a prefix over rows and then over threads
// gives every (thread, row) pair its first slot, and each thread places
// its chunk's edges in edge order.  A row's edges therefore keep their
// input order: the result is the stable order of
// numpy.argsort(dst, kind="stable"), bitwise, for every thread count.
//
// Memory: T * n_rows counters of 8 bytes.  T is capped at
// n_edges / n_rows, so the counters never outgrow one int64 per edge.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

void coo_to_csr_stable_i32(
    int64_t n_rows, int64_t n_edges,
    const int32_t* src, const int32_t* dst, const float* vals,
    int64_t* row_ptr, int32_t* out_src, int32_t* out_dst, float* out_vals)
{
    int64_t threads = 1;
#ifdef _OPENMP
    threads = omp_get_max_threads();
#endif
    threads = std::max<int64_t>(
        1, std::min<int64_t>(threads, n_edges / std::max<int64_t>(n_rows, 1)));
    // counts[t * n_rows + r]: thread t's edges into row r, then its first slot there
    std::vector<int64_t> counts(static_cast<size_t>(threads * n_rows), 0);
    auto chunk = [&](int64_t t, int64_t* lo, int64_t* hi) {
        *lo = n_edges * t / threads;
        *hi = n_edges * (t + 1) / threads;
    };

#pragma omp parallel for num_threads(threads) schedule(static, 1)
    for (int64_t t = 0; t < threads; ++t) {
        int64_t lo, hi;
        chunk(t, &lo, &hi);
        int64_t* c = counts.data() + t * n_rows;
        for (int64_t e = lo; e < hi; ++e) ++c[dst[e]];
    }

    // row totals, then each row's start, then each (thread, row) start
    std::memset(row_ptr, 0, sizeof(int64_t) * (n_rows + 1));
#pragma omp parallel for num_threads(threads)
    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t total = 0;
        for (int64_t t = 0; t < threads; ++t) total += counts[t * n_rows + r];
        row_ptr[r + 1] = total;
    }
    for (int64_t r = 0; r < n_rows; ++r) row_ptr[r + 1] += row_ptr[r];
#pragma omp parallel for num_threads(threads)
    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t at = row_ptr[r];
        for (int64_t t = 0; t < threads; ++t) {
            int64_t n = counts[t * n_rows + r];
            counts[t * n_rows + r] = at;
            at += n;
        }
    }

#pragma omp parallel for num_threads(threads) schedule(static, 1)
    for (int64_t t = 0; t < threads; ++t) {
        int64_t lo, hi;
        chunk(t, &lo, &hi);
        int64_t* cursor = counts.data() + t * n_rows;
        for (int64_t e = lo; e < hi; ++e) {
            int64_t pos = cursor[dst[e]]++;
            out_src[pos] = src[e];
            out_dst[pos] = dst[e];
            out_vals[pos] = vals ? vals[e] : 1.0f;
        }
    }
}

}  // extern "C"
