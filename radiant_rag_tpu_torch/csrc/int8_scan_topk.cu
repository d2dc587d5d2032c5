// Fused int8 scan -> exact per-query top-k, without a (B, N) score matrix.
//
// Replaces radiant_rag_tpu/ops/pallas_kernels.py: int8_scan_topk_pallas
// (_scan_topk_kernel). Same function: scores = qi . codes^T accumulated in
// int32, rows whose mask byte is 0 excluded, the k best per query in the
// order (score descending, row ascending) -- the Pallas kernel's first-index
// rule and lax.top_k's. Empty slots return score -3e38 and row -1.
//
// Bound on an H100: the int8 operations, 2*B*N*D (1.65 TOP for the dense leg
// and 4.40 TOP for the BM25 sketch leg at B = 2048, N = 2^20), against
// 1,979 dense int8 TOP/s; the codes are read once (0.4 / 1.1 GB). This
// first version runs on __dp4a (CUDA cores, not tensor cores), so it sits
// far from that bound; wgmma + TMA are later work.
//
// Design. The TPU kernel carried a running top-k across a sequential grid.
// Here CTAs run in parallel, so the work is split in two launches:
//   1. grid (query blocks of 32) x (corpus splits). A CTA streams its split
//      in 64-row tiles (int8_tile.cuh) and keeps each query's top-k as a
//      sorted list in shared memory (topk_list.cuh). Rows arrive in
//      ascending order, so a row enters the list only when its score is
//      strictly above the k-th and ties keep the lower row. One warp
//      updates one list: ballot over the tile, then a warp-parallel
//      shifted insert per accepted row. k <= 512; the lists take
//      32 * k * 8 bytes of shared memory beside the tile's.
//   2. one CTA per query merges its splits * k partial entries with a
//      bitonic sort of 64-bit (score, row) keys and writes the first k.
// Flat offsets are 64-bit: at B = 2048 and N = 2^20, B * N = 2^31.

#include "int8_tile.cuh"

namespace {

using namespace rr;

size_t partial_smem_bytes(int d, int k) {
  return tile_smem_bytes(d) + list_smem_bytes(k);
}

template <int SLOTS>
__global__ void __launch_bounds__(THREADS)
scan_topk_partial(const int8_t* __restrict__ codes, const int8_t* __restrict__ qi,
                  const uint8_t* __restrict__ mask, int64_t n, int d, int b, int k,
                  int64_t rows_per_split, int* __restrict__ part_s, int* __restrict__ part_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_q = reinterpret_cast<int8_t*>(smem);
  int8_t* s_c = s_q + QB * d;
  int* s_score = reinterpret_cast<int*>(s_c + TILE * (d + PAD));
  int* s_ls = s_score + QB * TILE;
  int* s_lr = s_ls + QB * k;
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_lr + QB * k);

  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int64_t r_begin = int64_t(split) * rows_per_split;
  const int64_t r_end = r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_queries(qi, b, d, q0, s_q);
  init_lists(s_ls, s_lr, k);
  for (int64_t t0 = r_begin; t0 < r_end; t0 += TILE) {
    __syncthreads();  // previous tile fully consumed
    load_tile(codes, mask, t0, r_end, d, s_c, s_valid);
    __syncthreads();
    score_tile(s_q, s_c, s_valid, d, s_score);
    __syncthreads();
    for (int j = 0; j < QB / 8; ++j) {
      const int q = warp + 8 * j;
      if (q0 + q < b) {
        insert_tile<SLOTS>(s_score + q * TILE, s_ls + q * k, s_lr + q * k, k, t0, lane);
      }
    }
  }
  __syncthreads();
  store_lists(s_ls, s_lr, q0, b, k, split, splits, part_s, part_r);
}

}  // namespace

extern "C" int rr_int8_scan_topk(const void* codes, const void* qi, const void* mask,
                                 int64_t n, int d, int b, int k, int splits,
                                 int64_t rows_per_split, int merge_p, int64_t smem_expected,
                                 void* part_s, void* part_r, void* out_s, void* out_r,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem_bytes(d, k);
  if (static_cast<int64_t>(smem) != smem_expected) return LAYOUT_MISMATCH;
  const auto partial = list_wide(k) ? scan_topk_partial<16> : scan_topk_partial<8>;
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, splits);
  partial<<<grid, THREADS, smem, st>>>(
      static_cast<const int8_t*>(codes), static_cast<const int8_t*>(qi),
      static_cast<const uint8_t*>(mask), n, d, b, k, rows_per_split,
      static_cast<int*>(part_s), static_cast<int*>(part_r));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_topk_merge(static_cast<const int*>(part_s), static_cast<const int*>(part_r), b,
                           splits, k, merge_p, static_cast<float*>(out_s),
                           static_cast<int*>(out_r), st);
}
