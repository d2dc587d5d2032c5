// Hamming scans over packed sign codes: one popcount tile, three entries.
//
// Replaces radiant_rag_tpu/ops/pallas_kernels.py:
//   rr_hamming_scores     <- hamming_scores_pallas   (_hamming_kernel)
//   rr_hamming_scores_t   <- hamming_scores_pallas_t (_hamming_kernel_t)
//   rr_hamming_scan_topk  <- the binary stage 1 of ops/similarity.py
//                            hamming_scan_topk: the same tile with a top-k
//                            epilogue, so no (B, N) matrix is written.
// Codes are W 32-bit words per row holding the JAX package's uint32 sign
// bits (the port keeps them in int32 tensors; read here as uint32).
// distance(q, c) = sum_w popc(q[w] ^ c[w]); the scan ranks by
// raw = 32 W - 2 distance, the cosine of the sign vectors times 32 W.
//
// Bound on an H100: the same function is a product of +-1 int8 sign
// matrices, <s_q, s_c> = 32 W - 2 distance, so the card can do it on its
// int8 tensor cores: 2 * B * N * 32 W operations (1.65 T at B = 2048,
// N = 2^20, W = 12) at 1,979 TOP/s, ~0.83 ms. The codes are 48 bytes a row
// (50 MB at 2^20 rows). The two score entries also write B * N * 4 bytes,
// which bounds them by the memory rate instead (1.28 ms at B = 1024).
// This first version runs on CUDA cores: B * N * W __popc (25.8 G at the
// scan's shape), at 16 per clock per SM for compute capability 9.0 (the
// CUDA programming guide's throughput table) x 132 SMs x 1.98 GHz = 4.2 T/s,
// so it cannot beat ~6.2 ms there.
//
// Design. A CTA holds 32 queries' words in shared memory and streams
// 64-row tiles of codes through it (row stride W or W + 1, whichever is
// odd, so the lanes' reads fall on distinct banks; the query words are
// broadcast). Each thread owns a 4-query x 2-row micro-tile in registers,
// as the int8 tile does. The transposed (W, N) layout is only another
// load of the same tile. The scan keeps each query's top-k with the list
// insert and merge launch of topk_list.cuh (order raw descending, then row
// ascending; empty slots (-3e38, -1); masked rows excluded). Ties decide
// the candidate set often here (raw takes at most 32 W + 1 values): rows
// arrive in ascending order and enter a list only strictly above its k-th
// score, and the merge orders ties by row, so the lowest rows are kept.
// Flat offsets are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "topk_list.cuh"

namespace {

using namespace rr;

constexpr int QB = LIST_QB;     // queries per CTA
constexpr int TILE = LIST_TILE; // code rows per shared-memory tile
constexpr int THREADS = 256;    // 8 warps: warp = query group, lane = row

__host__ __device__ constexpr int code_stride(int w) { return (w % 2) ? w : w + 1; }

__host__ __device__ constexpr size_t tile_bytes(int w) {
  return size_t(4) * (size_t(QB) * w + size_t(TILE) * code_stride(w));
}

__host__ __device__ constexpr size_t topk_smem_bytes(int w, int k) {
  return tile_bytes(w) + size_t(4) * QB * TILE + list_smem_bytes(k) + TILE;
}

// Query words [q0, q0 + QB) into s_q (row stride w); rows past b are zero.
__device__ inline void load_query_words(const uint32_t* q, int b, int w, int q0, uint32_t* s_q) {
  for (int i = threadIdx.x; i < QB * w; i += blockDim.x) {
    const int qq = i / w;
    s_q[i] = (q0 + qq < b) ? q[int64_t(q0) * w + i] : 0u;
  }
}

// Code rows [r0, r0 + TILE) into s_c (row stride code_stride(w)); rows at
// or past r_end are zero. TRANSPOSED reads (w, n_total) codes.
template <bool TRANSPOSED>
__device__ inline void load_code_tile(const uint32_t* codes, int64_t n_total, int w, int64_t r0,
                                      int64_t r_end, uint32_t* s_c) {
  const int cs = code_stride(w);
  for (int i = threadIdx.x; i < TILE * w; i += blockDim.x) {
    int r, x;
    if (TRANSPOSED) {
      x = i / TILE;
      r = i % TILE;
    } else {
      r = i / w;
      x = i % w;
    }
    const int64_t row = r0 + r;
    uint32_t v = 0u;
    if (row < r_end) v = TRANSPOSED ? codes[int64_t(x) * n_total + row] : codes[row * w + x];
    s_c[r * cs + x] = v;
  }
}

// acc[j][c] = distance(query tq + 8 j, row tr + 32 c) of the tile.
__device__ inline void hamming_tile(const uint32_t* s_q, const uint32_t* s_c, int w,
                                    int acc[4][2]) {
  const int tq = threadIdx.x / 32;
  const int tr = threadIdx.x % 32;
  const int cs = code_stride(w);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = 0;
  for (int x = 0; x < w; ++x) {
    const uint32_t a = s_c[tr * cs + x];
    const uint32_t c = s_c[(tr + 32) * cs + x];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t qw = s_q[(tq + 8 * j) * w + x];
      acc[j][0] += __popc(qw ^ a);
      acc[j][1] += __popc(qw ^ c);
    }
  }
}

template <bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS)
hamming_scores_kernel(const uint32_t* __restrict__ codes, const uint32_t* __restrict__ q,
                      int64_t n, int w, int b, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_q = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_c = s_q + QB * w;
  const int q0 = blockIdx.x * QB;
  const int tq = threadIdx.x / 32, tr = threadIdx.x % 32;
  const int64_t ntiles = (n + TILE - 1) / TILE;

  load_query_words(q, b, w, q0, s_q);
  for (int64_t t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int64_t r0 = t * TILE;
    __syncthreads();  // previous tile fully consumed
    load_code_tile<TRANSPOSED>(codes, n, w, r0, n, s_c);
    __syncthreads();
    int acc[4][2];
    hamming_tile(s_q, s_c, w, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qq = q0 + tq + 8 * j;
      if (qq >= b) continue;
      int* o = out + int64_t(qq) * n + r0;
      if (r0 + tr < n) o[tr] = acc[j][0];
      if (r0 + tr + 32 < n) o[tr + 32] = acc[j][1];
    }
  }
}

template <int SLOTS>
__global__ void __launch_bounds__(THREADS)
hamming_topk_partial(const uint32_t* __restrict__ codes, const uint32_t* __restrict__ q,
                     const uint8_t* __restrict__ mask, int64_t n, int w, int b, int k,
                     int64_t rows_per_split, int* __restrict__ part_s,
                     int* __restrict__ part_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_q = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_c = s_q + QB * w;
  int* s_score = reinterpret_cast<int*>(s_c + TILE * code_stride(w));
  int* s_ls = s_score + QB * TILE;
  int* s_lr = s_ls + QB * k;
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_lr + QB * k);

  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int64_t r_begin = int64_t(split) * rows_per_split;
  const int64_t r_end = r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int top = 32 * w;

  load_query_words(q, b, w, q0, s_q);
  init_lists(s_ls, s_lr, k);
  for (int64_t t0 = r_begin; t0 < r_end; t0 += TILE) {
    __syncthreads();  // previous tile fully consumed
    load_code_tile<false>(codes, n, w, t0, r_end, s_c);
    for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
      const int64_t row = t0 + r;
      s_valid[r] = (row < r_end) && (mask == nullptr || mask[row] != 0);
    }
    __syncthreads();
    int acc[4][2];
    hamming_tile(s_q, s_c, w, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qq = warp + 8 * j;
      s_score[qq * TILE + lane] = s_valid[lane] ? top - 2 * acc[j][0] : LIST_NONE;
      s_score[qq * TILE + lane + 32] = s_valid[lane + 32] ? top - 2 * acc[j][1] : LIST_NONE;
    }
    __syncthreads();
    for (int j = 0; j < QB / 8; ++j) {
      const int qq = warp + 8 * j;
      if (q0 + qq < b) {
        insert_tile<SLOTS>(s_score + qq * TILE, s_ls + qq * k, s_lr + qq * k, k, t0, lane);
      }
    }
  }
  __syncthreads();
  store_lists(s_ls, s_lr, q0, b, k, split, splits, part_s, part_r);
}

template <bool TRANSPOSED>
int launch_scores(const void* codes, const void* q, int64_t n, int w, int b, void* out,
                  void* stream) {
  const size_t smem = tile_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(hamming_scores_kernel<TRANSPOSED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t ntiles = (n + TILE - 1) / TILE;
  dim3 grid((b + QB - 1) / QB, static_cast<unsigned>(ntiles < 65535 ? ntiles : 65535));
  hamming_scores_kernel<TRANSPOSED><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), static_cast<const uint32_t*>(q), n, w, b,
      static_cast<int*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int rr_hamming_scores(const void* codes, const void* q, int64_t n, int w, int b,
                                 void* out, void* stream) {
  return launch_scores<false>(codes, q, n, w, b, out, stream);
}

extern "C" int rr_hamming_scores_t(const void* codes_t, const void* q, int64_t n, int w, int b,
                                   void* out, void* stream) {
  return launch_scores<true>(codes_t, q, n, w, b, out, stream);
}

extern "C" int rr_hamming_scan_topk(const void* codes, const void* q, const void* mask,
                                    int64_t n, int w, int b, int k, int splits,
                                    int64_t rows_per_split, int merge_p,
                                    int64_t smem_expected, void* part_s, void* part_r,
                                    void* out_s, void* out_r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = topk_smem_bytes(w, k);
  if (static_cast<int64_t>(smem) != smem_expected) return LAYOUT_MISMATCH;
  const auto partial = list_wide(k) ? hamming_topk_partial<16> : hamming_topk_partial<8>;
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, splits);
  partial<<<grid, THREADS, smem, st>>>(
      static_cast<const uint32_t*>(codes), static_cast<const uint32_t*>(q),
      static_cast<const uint8_t*>(mask), n, w, b, k, rows_per_split,
      static_cast<int*>(part_s), static_cast<int*>(part_r));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_topk_merge(static_cast<const int*>(part_s), static_cast<const int*>(part_r), b,
                           splits, k, merge_p, static_cast<float*>(out_s),
                           static_cast<int*>(out_r), st);
}
