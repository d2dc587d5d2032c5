// Hamming scans over packed sign codes, as a +-1 int8 product on the
// tensor-core tile: three entries.
//
// Replaces radiant_rag_tpu/ops/pallas_kernels.py:
//   rr_hamming_scores     <- hamming_scores_pallas   (_hamming_kernel)
//   rr_hamming_scores_t   <- hamming_scores_pallas_t (_hamming_kernel_t)
//   rr_hamming_scan_topk  <- the binary stage 1 of ops/similarity.py
//                            hamming_scan_topk: the same product with a
//                            top-k epilogue, so no (B, N) matrix is written.
// Codes are W 32-bit words per row holding the JAX package's uint32 sign
// bits (the port keeps them in int32 tensors; read here as uint32).
// distance(q, c) = sum_w popc(q[w] ^ c[w]); the scan ranks by
// raw = 32 W - 2 distance, the cosine of the sign vectors times 32 W.
//
// The identity: with each bit mapped to +1 where set and -1 where clear,
// <s_q, s_c> over the 32 W bits = 32 W - 2 distance(q, c). That is the
// scan's raw score itself, and distance = (32 W - <s_q, s_c>) / 2. The bit
// order is free as long as queries and codes share it (bit j of word x is
// K byte 32 x + j here), and |raw| <= 32 W <= 1024, so int32 accumulation
// is exact.
//
// Bound on an H100: 2 * B * N * 32 W int8 operations (1.65 T at B = 2048,
// N = 2^20, W = 12) at 1,979 TOP/s, ~0.83 ms. The codes are 48 bytes a row
// (50 MB at 2^20 rows). The two score entries also write B * N * 4 bytes,
// which bounds them by the memory rate instead (1.28 ms at B = 1024).
//
// Design. The int8 tensor-core tile (int8_mma_tile.cuh) with the SignWords
// producer: each thread holds the packed words of the next slice in
// registers and unpacks them to +-1 bytes in the free ring stage while the
// current slice's wgmma runs. The (W, N) layout is only another read
// pattern of the same producer. The scan runs the int8 scan's filtered
// top-k epilogue and launch plan (tc_scan_topk.cuh: 64 queries per CTA up to
// k = 363, 32 above; order raw descending, then row ascending; empty slots
// (-3e38, -1); masked rows excluded), the score entries the staged-store
// epilogue of int8_scores (tc_scores.cuh) on (32 W - acc) >> 1. Ties decide
// the candidate set often here (raw takes at most 32 W + 1 values); the
// epilogue compares full (score, row) keys, so the lowest rows are kept.
// Flat offsets are 64-bit.

#include "tc_scan_topk.cuh"
#include "tc_scores.cuh"

namespace {

using namespace rr::tc;

template <int QB>
__global__ void __launch_bounds__(THREADS, 2)
hamming_topk_partial(const void* codes, const void* q, const uint8_t* __restrict__ mask,
                     int64_t n, int w, int b, int k, int64_t rows_per_split,
                     int* __restrict__ part_s, int* __restrict__ part_r) {
  SignWords<QB, false> prod{static_cast<const uint32_t*>(codes), static_cast<const uint32_t*>(q),
                            n, w, b};
  scan_topk_body<QB>(prod, mask, n, b, k, rows_per_split, part_s, part_r);
}

// distance = (32 W - <s_q, s_c>) / 2
struct Distance {
  int top;  // 32 W
  __device__ __forceinline__ int operator()(int a) const { return (top - a) >> 1; }
};

template <bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS, 2)
hamming_scores_kernel(const void* codes, const void* q, int64_t n, int w, int b,
                      int64_t rows_per_cta, int* __restrict__ out) {
  SignWords<SCORES_QB, TRANSPOSED> prod{static_cast<const uint32_t*>(codes),
                                        static_cast<const uint32_t*>(q), n, w, b};
  scores_body(prod, n, b, rows_per_cta, out, Distance{32 * w});
}

}  // namespace

extern "C" int rr_hamming_scores(const void* codes, const void* q, int64_t n, int w, int b,
                                 void* out, void* stream) {
  return scores_launch(hamming_scores_kernel<false>, codes, q, n, w, b, out, stream);
}

extern "C" int rr_hamming_scores_t(const void* codes_t, const void* q, int64_t n, int w, int b,
                                   void* out, void* stream) {
  return scores_launch(hamming_scores_kernel<true>, codes_t, q, n, w, b, out, stream);
}

extern "C" int rr_hamming_scan_topk_ctas_per_sm(int k, int* ctas) {
  return scan_ctas_per_sm(hamming_topk_partial<64>, hamming_topk_partial<32>, k, ctas);
}

extern "C" int rr_hamming_scan_topk(const void* codes, const void* q, const void* mask,
                                    int64_t n, int w, int b, int k, int splits,
                                    int64_t rows_per_split, int merge_p,
                                    int64_t smem_expected, void* part_s, void* part_r,
                                    void* out_s, void* out_r, void* stream) {
  return scan_topk_launch(hamming_topk_partial<64>, hamming_topk_partial<32>, codes, q, mask, n,
                          w, b, k, splits, rows_per_split, merge_p, smem_expected, part_s,
                          part_r, out_s, out_r, stream);
}
