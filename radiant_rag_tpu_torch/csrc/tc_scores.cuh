// The staged-store epilogue of the tensor-core score kernels (int8_scores.cu,
// hamming.cu): (B, N) int32 out = f(acc) for every query and row, with no
// selection.
//
// The tile runs at 128 queries x 128 rows per CTA, each warpgroup an
// m64n128k32 product over its 64 queries, so the code operand crosses from
// L2 once per 128 queries. The epilogue stages the accumulator fragments
// in shared memory (64 KB, XOR-swizzled 16-byte chunks instead of padding,
// so two CTAs fit on an SM) and each warp then writes whole 512-byte output
// rows in 16-byte streaming stores (one int per store where N % 4 != 0
// leaves rows unaligned). The grid is (query blocks) x (row ranges), sized
// by the occupancy API to one wave; a CTA's ring runs on across the tiles
// of its range, so the stores of one tile overlap the loads of the next.
// Flat offsets are 64-bit.
#pragma once

#include "int8_mma_tile.cuh"

namespace rr {
namespace tc {

constexpr int SCORES_QB = 128;  // queries per score CTA
using ScoresTile = Tile<SCORES_QB>;
constexpr int SCORES_SMEM = ScoresTile::RING_BYTES + SCORES_QB * BN * 4;

// Staging block: 128 x 128 int32, 512-byte rows; 16-byte chunk c of row q
// sits at chunk c ^ (q & 7), so a warp's fragment writes (8 rows x 32
// bytes) spread over the banks and a row still reads as 32 whole chunks.
__device__ __forceinline__ int* stage_at(int* s_out, int q, int c) {
  return s_out + q * BN + 4 * (c ^ (q & 7));
}

// The score CTA: query block blockIdx.x, rows [blockIdx.y * rows_per_cta,
// + rows_per_cta); out[q][r] = f(product).
template <class Producer, class Fn>
__device__ __forceinline__ void scores_body(Producer& prod, int64_t n, int b,
                                            int64_t rows_per_cta, int* __restrict__ out, Fn f) {
  constexpr int QB = SCORES_QB;
  using T = ScoresTile;
  extern __shared__ __align__(1024) unsigned char smem[];
  int* s_out = reinterpret_cast<int*>(smem + T::RING_BYTES);
  const int q0 = blockIdx.x * QB;
  const int64_t r_begin = int64_t(blockIdx.y) * rows_per_cta;
  const int64_t r_end = r_begin + rows_per_cta < n ? r_begin + rows_per_cta : n;
  const bool vec = n % 4 == 0;  // output rows start on 16-byte boundaries

  scan_tiles<QB>(prod, nullptr, q0, r_begin, r_end, smem,
                 [&](typename T::Acc& acc, int64_t r0, const uint8_t*) {
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = T::q(h), r = T::r(nt, 0);
        *reinterpret_cast<int2*>(stage_at(s_out, q, r / 4) + r % 4) =
            make_int2(f(acc[nt][2 * h]), f(acc[nt][2 * h + 1]));
      }
    __syncthreads();
    // the next tile's fragment writes come after the ring's barrier
    if (vec) {
      for (int i = threadIdx.x; i < QB * BN / 4; i += THREADS) {
        const int q = i / (BN / 4), c = i % (BN / 4);
        const int64_t row = r0 + 4 * c;
        if (q0 + q < b && row < r_end) {
          __stcs(reinterpret_cast<int4*>(out + int64_t(q0 + q) * n + row),
                 *reinterpret_cast<const int4*>(stage_at(s_out, q, c)));
        }
      }
    } else {
      for (int i = threadIdx.x; i < QB * BN; i += THREADS) {
        const int q = i / BN, c = i % BN;
        const int64_t row = r0 + c;
        if (q0 + q < b && row < r_end)
          __stcs(out + int64_t(q0 + q) * n + row, stage_at(s_out, q, c / 4)[c % 4]);
      }
    }
  });
}

// A score kernel: (codes, queries, n, D or W, b, rows per CTA, out).
using ScoresKernel = void (*)(const void*, const void*, int64_t, int, int, int64_t, int*);

// One wave: (query blocks) x (row ranges) <= the CTAs the card holds at once.
inline int scores_launch(ScoresKernel fn, const void* codes, const void* q, int64_t n, int width,
                         int b, void* out, void* stream) {
  const void* f = reinterpret_cast<const void*>(fn);
  cudaError_t err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SCORES_SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, THREADS, SCORES_SMEM);
  if (err != cudaSuccess) return err;
  const int qblocks = (b + SCORES_QB - 1) / SCORES_QB;
  const int64_t ntiles = (n + BN - 1) / BN;
  int64_t ranges = int64_t(sms) * (per_sm > 0 ? per_sm : 1) / qblocks;
  ranges = ranges < 1 ? 1 : (ranges > ntiles ? ntiles : ranges);
  const int64_t tiles_per_cta = (ntiles + ranges - 1) / ranges;
  ranges = (ntiles + tiles_per_cta - 1) / tiles_per_cta;
  dim3 grid(qblocks, static_cast<unsigned>(ranges));
  fn<<<grid, THREADS, SCORES_SMEM, static_cast<cudaStream_t>(stream)>>>(
      codes, q, n, width, b, tiles_per_cta * BN, static_cast<int*>(out));
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace rr
