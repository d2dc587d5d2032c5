// Raw int8 dot products, no selection: out (B, N) int32 = qi . codes^T.
//
// Replaces radiant_rag_tpu/ops/pallas_kernels.py: int8_scores_pallas
// (_int8_scan_kernel). No mask: every row is scored, as there.
//
// Bound on an H100: the output. B * N * 4 bytes (4.3 GB at B = 1024,
// N = 2^20) over 3.35 TB/s is 1.3 ms; the 2 * B * N * D int8 operations
// (0.82 TOP at D = 384) take 0.42 ms at the 1,979 TOP/s tensor-core peak.
//
// Design. The int8 tensor-core tile (int8_mma_tile.cuh, int8 rows copied by
// cp.async) at 128 queries x 128 rows per CTA under the staged-store
// epilogue of tc_scores.cuh.

#include "tc_scores.cuh"

namespace {

using namespace rr::tc;

struct Same {
  __device__ __forceinline__ int operator()(int a) const { return a; }
};

__global__ void __launch_bounds__(THREADS, 2)
int8_scores_kernel(const void* codes, const void* qi, int64_t n, int d, int b,
                   int64_t rows_per_cta, int* __restrict__ out) {
  Int8Rows<SCORES_QB> prod{static_cast<const int8_t*>(codes), static_cast<const int8_t*>(qi), d,
                           b};
  scores_body(prod, n, b, rows_per_cta, out, Same{});
}

}  // namespace

extern "C" int rr_int8_scores(const void* codes, const void* qi, int64_t n, int d, int b,
                              void* out, void* stream) {
  return scores_launch(int8_scores_kernel, codes, qi, n, d, b, out, stream);
}
