// Fused int8 scan -> exact per-query top-k, without a (B, N) score matrix.
//
// Replaces radiant_rag_tpu/ops/pallas_kernels.py: int8_scan_topk_pallas
// (_scan_topk_kernel). Same function: scores = qi . codes^T accumulated in
// int32, rows whose mask byte is 0 excluded, the k best per query in the
// order (score descending, row ascending) -- the Pallas kernel's first-
// index rule and lax.top_k's. Empty slots return score -3e38 and row -1.
//
// Bound on an H100: the int8 operations, 2*B*N*D (1.65 TOP for the dense leg
// and 4.40 TOP for the BM25 sketch leg at B = 2048, N = 2^20), against
// 1,979 dense int8 TOP/s; the codes are read once (0.4 / 1.1 GB). Before
// that: the code bytes crossing from L2 once per 64 queries, and the list
// upkeep, during which a CTA's tensor cores wait.
//
// Design. The TPU kernel carried a running top-k across a sequential grid.
// Here CTAs run in parallel, so the work is split in two launches:
//   1. grid (query blocks) x (corpus splits). A CTA streams its split in
//      128-row tiles through the int8 tensor-core tile (int8_mma_tile.cuh,
//      64 queries, int8 rows copied by cp.async) and keeps each query's
//      top-k behind the filtered epilogue of tc_scan_topk.cuh.
//   2. one CTA per query merges its splits * k partial entries with a
//      bitonic sort of 64-bit (score, row) keys and writes the first k
//      (topk_list.cuh).
// Flat offsets are 64-bit.

#include "tc_scan_topk.cuh"

namespace {

using namespace rr::tc;

template <int QB>
__global__ void __launch_bounds__(THREADS, 2)
scan_topk_partial(const void* codes, const void* qi, const uint8_t* __restrict__ mask, int64_t n,
                  int d, int b, int k, int64_t rows_per_split, int* __restrict__ part_s,
                  int* __restrict__ part_r) {
  Int8Rows<QB> prod{static_cast<const int8_t*>(codes), static_cast<const int8_t*>(qi), d, b};
  scan_topk_body<QB>(prod, mask, n, b, k, rows_per_split, part_s, part_r);
}

}  // namespace

extern "C" int rr_int8_scan_topk_ctas_per_sm(int k, int* ctas) {
  return scan_ctas_per_sm(scan_topk_partial<64>, scan_topk_partial<32>, k, ctas);
}

extern "C" int rr_int8_scan_topk(const void* codes, const void* qi, const void* mask,
                                 int64_t n, int d, int b, int k, int splits,
                                 int64_t rows_per_split, int merge_p, int64_t smem_expected,
                                 void* part_s, void* part_r, void* out_s, void* out_r,
                                 void* stream) {
  return scan_topk_launch(scan_topk_partial<64>, scan_topk_partial<32>, codes, qi, mask, n, d, b,
                          k, splits, rows_per_split, merge_p, smem_expected, part_s, part_r,
                          out_s, out_r, stream);
}
