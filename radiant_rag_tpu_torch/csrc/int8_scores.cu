// Raw int8 dot products, no selection: out (B, N) int32 = qi . codes^T.
//
// Replaces radiant_rag_tpu/ops/pallas_kernels.py: int8_scores_pallas
// (_int8_scan_kernel). No mask: every row is scored, as there.
//
// Bound on an H100: the output. B * N * 4 bytes (4.3 GB at B = 1024,
// N = 2^20) over 3.35 TB/s is 1.3 ms; the 2 * B * N * D int8 operations
// (0.82 TOP at D = 384) take 0.42 ms at the 1,979 TOP/s tensor-core peak.
//
// Design. The tile of the int8 scans (int8_tile.cuh: 32 queries x 64 rows
// per CTA, __dp4a on a 4-query x 2-row register micro-tile) with a store
// epilogue: the CTA's 32 x 64 block goes from shared memory to the output
// in rows of 64 consecutive ints, so the stores coalesce. A CTA walks the
// corpus tiles blockIdx.y, blockIdx.y + gridDim.y, ... so any N fits the
// grid. Flat offsets are 64-bit.

#include "int8_tile.cuh"

namespace {

using namespace rr;

__global__ void __launch_bounds__(THREADS)
int8_scores_kernel(const int8_t* __restrict__ codes, const int8_t* __restrict__ qi, int64_t n,
                   int d, int b, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_q = reinterpret_cast<int8_t*>(smem);
  int8_t* s_c = s_q + QB * d;
  int* s_score = reinterpret_cast<int*>(s_c + TILE * (d + PAD));
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_score + QB * TILE);

  const int q0 = blockIdx.x * QB;
  const int64_t ntiles = (n + TILE - 1) / TILE;
  load_queries(qi, b, d, q0, s_q);
  for (int64_t t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int64_t r0 = t * TILE;
    __syncthreads();  // previous tile fully stored
    load_tile(codes, nullptr, r0, n, d, s_c, s_valid);
    __syncthreads();
    score_tile(s_q, s_c, s_valid, d, s_score);
    __syncthreads();
    for (int i = threadIdx.x; i < QB * TILE; i += blockDim.x) {
      const int q = i / TILE, r = i % TILE;
      if (q0 + q < b && r0 + r < n) out[int64_t(q0 + q) * n + r0 + r] = s_score[i];
    }
  }
}

}  // namespace

extern "C" int rr_int8_scores(const void* codes, const void* qi, int64_t n, int d, int b,
                              void* out, void* stream) {
  const size_t smem = tile_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      int8_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t ntiles = (n + TILE - 1) / TILE;
  dim3 grid((b + QB - 1) / QB, static_cast<unsigned>(ntiles < 65535 ? ntiles : 65535));
  int8_scores_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int8_t*>(qi), n, d, b,
      static_cast<int*>(out));
  return cudaGetLastError();
}
