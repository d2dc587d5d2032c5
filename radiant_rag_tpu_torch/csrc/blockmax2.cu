// Per-512-row-tile top-2 of the int8 scan (block-max candidate generation).
//
// Replaces radiant_rag_tpu/ops/pallas_kernels.py:269 blockmax2_pallas (body
// _blockmax2_kernel, :227). For every 512-row tile of the corpus and every
// query: the best and second-best valid rows in the order (score
// descending, row ascending), scores as the exact int32 accumulators in f32,
// rows global, -1 (score -3e38) where the tile has fewer than 2 valid rows.
// Output layout (B, 2 * NT): all tiles' first entries, then all tiles'
// second entries -- the caller's top-k over it breaks ties by position, so
// the layout is part of the semantics, as is the 512-row tile. No bf16
// cast: the Pallas cast only worked around Mosaic's int8 lowering.
//
// Bound on an H100: the int8 operations, 2 * B * N * D at 1,979 dense int8
// TOP/s: 0.833 ms for the dense leg (D = 384) and 2.222 ms for the BM25
// sketch leg (S = 1024) at B = 2048, N = 2^20. The bytes are far below it:
// the codes read once (0.4 / 1.1 GB) and a 67 MB output.
//
// Design.
//   - The product is int8_scores' own: the tensor-core tile
//     (int8_mma_tile.cuh, scan_tiles<128, Int8Rows<128>>) at 128 queries x
//     128 rows per CTA, m64n128k32 s8 wgmma from shared memory, int8 rows by
//     cp.async through the 3-stage ring in the 64-byte swizzle, the tile's
//     mask bytes riding with its first slice. With 128 queries per CTA the
//     code rows cross from L2 once per 128 queries.
//   - The epilogue keeps a per-query top-2 in registers, with no shared
//     memory and no barrier. In the QB = 128 fragment a thread holds 2
//     queries x 32 rows of a 128-row tile, and the 4 lanes of a quad hold
//     all 128 rows of the same 2 queries. Each thread walks its 32
//     accumulators in ascending row order, keeping a top-2 of (score, row)
//     with strict compares (so the lower row wins a tie); masked rows and
//     rows past the range never enter. Two xor-shuffles (1, 2) merge the
//     quad as 64-bit order keys, and the result folds into a running top-2
//     that lives across the 4 tiles of a 512-row block; lane 0 of the quad
//     writes both entries at the block's last tile or the range's end.
//     Every step is a select on the scores or keys: no data-dependent
//     branch reads the accumulators (a divergent read makes ptxas
//     serialize the wgmma, its note C7520).
//   - Grid (query blocks of 128) x (splits), one wave at the occupancy
//     API's CTAs per SM (the wrapper's blockmax2_plan). Each split is a
//     whole number of 512-row blocks, so no block spans two CTAs, and no
//     grid dimension grows with N. The entry refuses another layout.
// Flat offsets are 64-bit.

#include <climits>

#include "int8_mma_tile.cuh"

namespace {

using namespace rr::tc;

constexpr int QB = 128;               // queries per CTA
constexpr int BLOCKMAX_TILE = 512;    // rows per top-2 block (the semantics' tile)
constexpr int SMEM = Tile<QB>::RING_BYTES;
constexpr float NEG = -3.0e38f;       // score of an empty slot
constexpr int LAYOUT_MISMATCH = -1;   // the wrappers' _LAYOUT_MISMATCH
using Key = unsigned long long;       // (score, row) order key; 0 = empty

static_assert(BLOCKMAX_TILE % BN == 0, "a block is whole 128-row tiles");

// Larger for a better entry: score, then the lower row.
__device__ __forceinline__ Key order_key(int score, int64_t row) {
  return (Key(static_cast<unsigned>(score) ^ 0x80000000u) << 32) |
         Key(0xFFFFFFFFu - static_cast<unsigned>(row));
}

__device__ __forceinline__ Key kmax(Key a, Key b) { return a > b ? a : b; }

// (a1, a2) <- the top-2 of two sorted pairs (a1 >= a2, b1 >= b2).
__device__ __forceinline__ void top2_merge(Key& a1, Key& a2, Key b1, Key b2) {
  const Key other = a1 > b1 ? a2 : b2;
  const Key lo = a1 > b1 ? b1 : a1;
  a1 = kmax(a1, b1);
  a2 = kmax(lo, other);
}

__global__ void __launch_bounds__(THREADS, 2)
blockmax2_kernel(const int8_t* __restrict__ codes, const int8_t* __restrict__ qi,
                 const uint8_t* __restrict__ mask, int64_t n, int d, int b,
                 int64_t rows_per_split, float* __restrict__ out_s, int* __restrict__ out_r) {
  using T = Tile<QB>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int q0 = blockIdx.x * QB;
  const int64_t r_begin = int64_t(blockIdx.y) * rows_per_split;
  const int64_t r_end = r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int64_t nt = (n + BLOCKMAX_TILE - 1) / BLOCKMAX_TILE;
  Key run1[2] = {0ull, 0ull}, run2[2] = {0ull, 0ull};  // the block's top-2 per query
  Int8Rows<QB> prod{codes, qi, d, b};

  scan_tiles<QB>(prod, mask, q0, r_begin, r_end, smem,
                 [&](typename T::Acc& acc, int64_t r0, const uint8_t* tmask) {
    const int live = r_end - r0 < BN ? static_cast<int>(r_end - r0) : BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int s1 = INT_MIN, s2 = INT_MIN, c1 = 0, c2 = 0;  // no valid score is INT_MIN
#pragma unroll
      for (int i = 0; i < T::NT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int rl = T::r(i, j);  // ascending in (i, j)
          const bool ok = rl < live && (tmask == nullptr || tmask[rl] != 0);
          const int x = ok ? acc[i][2 * h + j] : INT_MIN;
          const bool g1 = x > s1, g2 = x > s2;
          s2 = g1 ? s1 : (g2 ? x : s2);
          c2 = g1 ? c1 : (g2 ? rl : c2);
          s1 = g1 ? x : s1;
          c1 = g1 ? rl : c1;
        }
      Key k1 = s1 == INT_MIN ? 0ull : order_key(s1, r0 + c1);
      Key k2 = s2 == INT_MIN ? 0ull : order_key(s2, r0 + c2);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const Key o1 = __shfl_xor_sync(0xffffffffu, k1, off);
        const Key o2 = __shfl_xor_sync(0xffffffffu, k2, off);
        top2_merge(k1, k2, o1, o2);
      }
      top2_merge(run1[h], run2[h], k1, k2);
    }
    const int64_t next = r0 + BN;
    if (next % BLOCKMAX_TILE == 0 || next >= r_end) {  // the block ends here (CTA-uniform)
      if (threadIdx.x % 4 == 0) {
        const int64_t tile = r0 / BLOCKMAX_TILE;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + T::q(h);
          if (q < b) {
            const int64_t o = int64_t(q) * 2 * nt + tile;
            const Key k1 = run1[h], k2 = run2[h];
            out_s[o] = k1 ? static_cast<float>(static_cast<int>(unsigned(k1 >> 32) ^ 0x80000000u))
                          : NEG;
            out_r[o] = k1 ? static_cast<int>(0xFFFFFFFFu - unsigned(k1)) : -1;
            out_s[o + nt] =
                k2 ? static_cast<float>(static_cast<int>(unsigned(k2 >> 32) ^ 0x80000000u)) : NEG;
            out_r[o + nt] = k2 ? static_cast<int>(0xFFFFFFFFu - unsigned(k2)) : -1;
          }
        }
      }
      run1[0] = run1[1] = run2[0] = run2[1] = 0ull;
    }
  });
}

}  // namespace

extern "C" int rr_blockmax2_ctas_per_sm(int* ctas) {
  cudaError_t err =
      cudaFuncSetAttribute(blockmax2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, blockmax2_kernel, THREADS, SMEM);
}

// The launch on the wrapper's plan: splits x rows_per_split must cover the
// rows in whole 512-row blocks, with this layout's shared memory.
extern "C" int rr_blockmax2(const void* codes, const void* qi, const void* mask, int64_t n, int d,
                            int b, int splits, int64_t rows_per_split, int64_t smem_expected,
                            void* out_s, void* out_r, void* stream) {
  if (smem_expected != SMEM || d % 16 != 0 || rows_per_split <= 0 ||
      rows_per_split % BLOCKMAX_TILE != 0 || int64_t(splits) * rows_per_split < n)
    return LAYOUT_MISMATCH;
  cudaError_t err =
      cudaFuncSetAttribute(blockmax2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, splits);
  blockmax2_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int8_t*>(qi),
      static_cast<const uint8_t*>(mask), n, d, b, rows_per_split, static_cast<float*>(out_s),
      static_cast<int*>(out_r));
  return cudaGetLastError();
}
