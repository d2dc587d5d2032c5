// Per-512-row-tile top-2 of the int8 scan (block-max candidate generation).
//
// Replaces radiant_rag_tpu/ops/pallas_kernels.py: blockmax2_pallas
// (_blockmax2_kernel). For every 512-row tile of the corpus and every query:
// the best and second-best valid rows in the order (score descending, row
// ascending), scores as the exact int32 accumulators in f32, rows global,
// -1 (score -3e38) where the tile has fewer than 2 valid rows. Output layout
// (B, 2 * NT): all tiles' first entries, then all tiles' second entries --
// the caller's top-k over it breaks ties by position, so the layout is part
// of the semantics, as is the 512-row tile. No bf16 cast: the Pallas cast
// only worked around Mosaic's int8 lowering.
//
// Bound on an H100: the same int8 operations as the scan it replaces,
// 2*B*N*D against 1,979 dense int8 TOP/s; the codes are read once. This
// first version uses __dp4a on the CUDA cores (int8_tile.cuh).
//
// Design. Grid (query blocks of 32) x (512-row tiles); the query block is
// the fast grid index, so the CTAs that share one corpus tile run together
// and read it through L2. A CTA scores its tile in eight 64-row sub-tiles;
// one warp keeps the running top-2 of four queries as 64-bit (score, row)
// keys in registers, reducing each sub-tile with a butterfly of shuffles.

#include "int8_tile.cuh"

namespace {

using namespace rr;

constexpr int BLOCKMAX_TILE = 512;

__device__ inline void top2_merge(unsigned long long& a1, unsigned long long& a2,
                                  unsigned long long b1, unsigned long long b2) {
  if (a1 > b1) {
    a2 = a2 > b1 ? a2 : b1;
  } else {
    a2 = a1 > b2 ? a1 : b2;
    a1 = b1;
  }
}

__global__ void __launch_bounds__(THREADS)
blockmax2_kernel(const int8_t* __restrict__ codes, const int8_t* __restrict__ qi,
                 const uint8_t* __restrict__ mask, int64_t n, int d, int b,
                 float* __restrict__ out_s, int* __restrict__ out_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_q = reinterpret_cast<int8_t*>(smem);
  int8_t* s_c = s_q + QB * d;
  int* s_score = reinterpret_cast<int*>(s_c + TILE * (d + PAD));
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_score + QB * TILE);

  const int q0 = blockIdx.x * QB;
  const int64_t tile = blockIdx.y;
  const int64_t nt = gridDim.y;
  const int64_t t_begin = tile * BLOCKMAX_TILE;
  const int64_t t_end = t_begin + BLOCKMAX_TILE < n ? t_begin + BLOCKMAX_TILE : n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  unsigned long long top1[QB / 8] = {}, top2[QB / 8] = {};
  load_queries(qi, b, d, q0, s_q);
  for (int sub = 0; sub < BLOCKMAX_TILE; sub += TILE) {
    __syncthreads();
    load_tile(codes, mask, t_begin + sub, t_end, d, s_c, s_valid);
    __syncthreads();
    score_tile(s_q, s_c, s_valid, d, s_score);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
      const int* sc = s_score + (warp + 8 * j) * TILE;
      const unsigned long long a = order_key(sc[lane], sub + lane);
      const unsigned long long c = order_key(sc[lane + 32], sub + lane + 32);
      unsigned long long k1 = a > c ? a : c, k2 = a > c ? c : a;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o1 = __shfl_xor_sync(0xffffffffu, k1, off);
        const unsigned long long o2 = __shfl_xor_sync(0xffffffffu, k2, off);
        top2_merge(k1, k2, o1, o2);
      }
      top2_merge(top1[j], top2[j], k1, k2);
    }
  }
  if (lane != 0) return;
#pragma unroll
  for (int j = 0; j < QB / 8; ++j) {
    const int q = q0 + warp + 8 * j;
    if (q >= b) continue;
    const int64_t o = int64_t(q) * 2 * nt + tile;
    out_s[o] = top1[j] ? static_cast<float>(key_score(top1[j])) : NEG;
    out_r[o] = top1[j] ? static_cast<int>(t_begin) + key_row(top1[j]) : -1;
    out_s[o + nt] = top2[j] ? static_cast<float>(key_score(top2[j])) : NEG;
    out_r[o + nt] = top2[j] ? static_cast<int>(t_begin) + key_row(top2[j]) : -1;
  }
}

}  // namespace

extern "C" int rr_blockmax2(const void* codes, const void* qi, const void* mask, int64_t n,
                            int d, int b, void* out_s, void* out_r, void* stream) {
  const size_t smem = tile_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      blockmax2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t nt = (n + BLOCKMAX_TILE - 1) / BLOCKMAX_TILE;
  dim3 grid((b + QB - 1) / QB, static_cast<unsigned>(nt));
  blockmax2_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int8_t*>(qi),
      static_cast<const uint8_t*>(mask), n, d, b, static_cast<float*>(out_s),
      static_cast<int*>(out_r));
  return cudaGetLastError();
}
