// CPU reference implementation of the sketch distance inner loop, used as
// the benchmark baseline (stand-in for pp-sketchlib's CPU path, which is an
// external dependency not available in this environment). Implements the
// same computation as the bin-match kernel: per (query, ref, k) popcount of
// bins agreeing on all b bit planes, with -O3 + OpenMP threading +
// hardware popcount — i.e. an honest, optimised CPU contender.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -o libcpu_baseline.so cpu_baseline.cpp
// Called from bench.py via ctypes.

#include <cstdint>
#include <cstddef>

extern "C" {

// planes layout: [n, K, P, W64] uint64 (plane-major, W64 = sketchsize64*... )
// out: [nq, nr, K] int32 match counts
void match_counts_cpu(const uint64_t *planes_q, const uint64_t *planes_r,
                      int64_t nq, int64_t nr, int64_t K, int64_t P,
                      int64_t W, int32_t *out, int threads) {
#pragma omp parallel for schedule(static) num_threads(threads) collapse(2)
  for (int64_t q = 0; q < nq; ++q) {
    for (int64_t r = 0; r < nr; ++r) {
      for (int64_t k = 0; k < K; ++k) {
        const uint64_t *xq = planes_q + ((q * K + k) * P) * W;
        const uint64_t *xr = planes_r + ((r * K + k) * P) * W;
        uint64_t diff[1024];  // W <= 1024 (sketch sizes up to 65536 bins)
        for (int64_t w = 0; w < W; ++w) {
          diff[w] = xq[w] ^ xr[w];
        }
        for (int64_t p = 1; p < P; ++p) {
          const uint64_t *xqp = xq + p * W;
          const uint64_t *xrp = xr + p * W;
          for (int64_t w = 0; w < W; ++w) {
            diff[w] |= xqp[w] ^ xrp[w];
          }
        }
        int32_t count = 0;
        for (int64_t w = 0; w < W; ++w) {
          count += __builtin_popcountll(~diff[w]);
        }
        out[(q * nr + r) * K + k] = count;
      }
    }
  }
}

}  // extern "C"
