// Int8 tensor-core tile of the int8 scans (int8_scores.cu, int8_scan_topk.cu).
//
// A CTA of 8 warps (two warpgroups) computes a QB-query x 128-row block of
// int32 dot products qi . codes^T (QB = 128, 64, or 32 where a caller's
// shared memory needs it) and walks its rows in 128-row tiles, handing each
// finished block to an epilogue. The K loop takes D in 64-byte slices, two
// 32-byte product steps each.
//
// Bound on an H100: the int8 operations, 2 * QB * 128 * D per tile, at
// 1,979 dense int8 TOP/s -- far above what the __dp4a tile (int8_tile.cuh)
// reaches on CUDA cores. Once the product is on the tensor cores, what sets
// the pace is feeding it: every tile reads QB + 128 rows of D bytes from L2
// (the code rows once per query block), so the loads, not the product,
// take most of a slice.
//
// What the design does about it:
//   - The product runs on the tensor cores as wgmma.mma_async m64nNk32
//     s32.s8.s8, both operands read from shared memory by the warpgroup
//     (no ldmatrix, no fragment registers), int32 accumulators in
//     registers.
//   - Both operands stream through a 3-stage ring filled by cp.async.cg
//     16-byte copies, two slices ahead of the product and straight through
//     tile boundaries, so an epilogue overlaps the next tile's loads. Rows
//     are 64 bytes; 16-byte chunk c of row r sits at chunk c ^ ((r >> 1) & 3),
//     which is the 64-byte swizzle the wgmma descriptor names, so the
//     copies write the layout the tensor cores read. Rows past the range,
//     queries past B and the tail of D (D % 64 != 0) are zero-filled by the
//     copy's source size; any D % 16 == 0 works.
//   - QB = 128 (int8_scores) halves the code bytes per operation against
//     QB = 64; the scan keeps 64 because its lists share the shared memory.
//   - The mask bytes of a tile ride in the ring with its first slice.
// Flat offsets are 64-bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rr {
namespace tc {

constexpr int BN = 128;          // corpus rows per tile
constexpr int BK = 64;           // bytes of D per ring slice
constexpr int STAGES = 3;        // ring depth
constexpr int THREADS = 256;     // 8 warps
constexpr int CHUNKS = BK / 16;  // 16-byte chunks per row per slice

// The CTA's 8 warps form two warpgroups, each issuing m64nNk32 products.
// QB = 128: warpgroup w takes queries [64 w, 64 w + 64) against all 128
// rows (N = 128). QB = 64 or 32: each warpgroup takes all queries (the
// descriptor always spans 64 query rows; with QB = 32 the last 32 are other
// bytes of the stage, whose accumulators the callers ignore) against rows
// [64 w, 64 w + 64) (N = 64).
template <int QB>
struct Tile {
  static_assert(QB == 32 || QB == 64 || QB == 128, "32, 64 or 128 queries per CTA");
  static constexpr int N = QB == 128 ? 128 : 64;  // rows per warpgroup product
  static constexpr int NT = N / 8;                // n8 blocks per thread
  static constexpr int STAGE_BYTES = (QB + BN) * BK;
  // operand ring, then one 128-byte mask slot per stage
  static constexpr int RING_BYTES = STAGES * (STAGE_BYTES + BN);

  // A thread's accumulators: acc[nt][i] is query q(i >> 1) and row
  // r(nt, i & 1) of the CTA tile (the m64nN fragment of its warpgroup).
  using Acc = int[NT][4];

  __device__ static __forceinline__ int q(int h) {
    const int wg = threadIdx.x / 128;
    return (QB == 128 ? 64 * wg : 0) + 16 * ((threadIdx.x / 32) % 4) + 8 * h +
           (threadIdx.x % 32) / 4;
  }
  __device__ static __forceinline__ int r(int nt, int j) {
    const int wg = threadIdx.x / 128;
    return (QB == 128 ? 0 : 64 * wg) + 8 * nt + 2 * (threadIdx.x % 4) + j;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a slice (64-byte rows).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * BK + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// fence.proxy.async: the cp.async writes become visible to the tensor
// cores' reads (the async proxy) once the CTA has synchronised.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 64-byte
// swizzle: 8-row x 64-byte atoms (swz above), atoms 512 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(512 >> 4) << 32) |
         (uint64_t(2) << 62);
}

// acc (64 x N, int32) = A (64 x 32 bytes) . B (N x 32 bytes)^T (+ acc where
// acc_in != 0), both operands read from shared memory by the warpgroup's
// tensor cores.
__device__ __forceinline__ void wgmma_n64(int (&d)[8][4], uint64_t da, uint64_t db, int acc_in) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]),
        "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]),
        "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]),
        "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(da), "l"(db), "r"(acc_in)
      : "memory");
}

__device__ __forceinline__ void wgmma_n128(int (&d)[16][4], uint64_t da, uint64_t db,
                                           int acc_in) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]),
        "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]),
        "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]),
        "+r"(d[7][2]), "+r"(d[7][3]), "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]), "+r"(d[10][0]),
        "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]), "+r"(d[11][0]), "+r"(d[11][1]),
        "+r"(d[11][2]), "+r"(d[11][3]), "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]),
        "+r"(d[12][3]), "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]), "+r"(d[15][0]),
        "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(acc_in)
      : "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Queue one slice: bytes [kb0, kb0 + 64) of queries [q0, q0 + QB) (slice
// rows [0, QB)) and of code rows [r0, r0 + 128) (slice rows [QB, QB + 128));
// and, when tile_mask is set, the tile's 128 mask bytes. Out-of-range chunks
// are zero-filled (a masked-off or missing row reads as mask byte 0).
template <int QB>
__device__ __forceinline__ void load_slice(const int8_t* __restrict__ codes,
                                           const int8_t* __restrict__ qi,
                                           const uint8_t* __restrict__ mask, int d, int b,
                                           int q0, int64_t r0, int64_t r_end, int kb0,
                                           unsigned char* stage, uint8_t* tile_mask) {
  const uint32_t base = smem_u32(stage);
  for (int i = threadIdx.x; i < (QB + BN) * CHUNKS; i += THREADS) {
    const int row = i / CHUNKS, c = i % CHUNKS;
    const int kb = kb0 + 16 * c;
    const int8_t* src;
    bool ok;
    if (row < QB) {
      ok = q0 + row < b && kb < d;
      src = qi + int64_t(q0 + row) * d + kb;
    } else {
      const int64_t r = r0 + (row - QB);
      ok = r < r_end && kb < d;
      src = codes + r * d + kb;
    }
    cp_async16(base + swz(row, c), ok ? src : codes, ok ? 16 : 0);
  }
  if (tile_mask != nullptr && threadIdx.x < BN / 16) {
    const int64_t r = r0 + 16 * threadIdx.x;
    const int64_t left = r_end - r;
    const int bytes = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
    cp_async16(smem_u32(tile_mask + 16 * threadIdx.x), bytes ? mask + r : mask, bytes);
  }
}

// acc += the slice's product for this thread's warpgroup (acc = it for the
// first slice of a tile, so the accumulators need no zeroing between
// products); `left` = bytes of D from the slice's start (a 32-byte step
// wholly past D is skipped). With QB = 32 the descriptor's 64 query rows
// run into the code rows; the fragment's queries 32-63 are ignored by the
// callers.
template <int QB>
__device__ __forceinline__ void mma_slice(const unsigned char* stage, int left, bool first,
                                          typename Tile<QB>::Acc& acc) {
  const int wg = threadIdx.x / 128;
  const uint32_t a = smem_u32(stage) + (QB == 128 ? wg * 64 * BK : 0);
  const uint32_t b = smem_u32(stage) + QB * BK + (QB == 128 ? 0 : wg * 64 * BK);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  if constexpr (QB == 128) {
    wgmma_n128(acc, smem_desc(a), smem_desc(b), !first);
    if (left > 32) wgmma_n128(acc, smem_desc(a + 32), smem_desc(b + 32), 1);
  } else {
    wgmma_n64(acc, smem_desc(a), smem_desc(b), !first);
    if (left > 32) wgmma_n64(acc, smem_desc(a + 32), smem_desc(b + 32), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wgmma_wait0();
}

// Stream rows [r_begin, r_end) against queries [q0, q0 + QB) in 128-row
// tiles; after each tile, epi(acc, first row of the tile, its mask bytes or
// nullptr) with every thread of the CTA. The epilogue may synchronise the
// CTA. Uses Tile<QB>::RING_BYTES of shared memory at `ring`.
template <int QB, class Epilogue>
__device__ __forceinline__ void scan_tiles(const int8_t* __restrict__ codes,
                                           const int8_t* __restrict__ qi,
                                           const uint8_t* __restrict__ mask, int d, int b,
                                           int q0, int64_t r_begin, int64_t r_end,
                                           unsigned char* ring, Epilogue&& epi) {
  using T = Tile<QB>;
  const int ks = (d + BK - 1) / BK;  // slices per tile
  const int ntiles = r_end > r_begin ? static_cast<int>((r_end - r_begin + BN - 1) / BN) : 0;
  const int64_t total = int64_t(ntiles) * ks;
  uint8_t* masks = ring + STAGES * T::STAGE_BYTES;

  // producer position: slice ld_s of tile ld_t into stage ld_stage
  int64_t issued = 0;
  int ld_t = 0, ld_s = 0, ld_stage = 0;
  auto issue = [&]() {
    if (issued < total) {
      uint8_t* tm = (ld_s == 0 && mask != nullptr) ? masks + (ld_t % STAGES) * BN : nullptr;
      load_slice<QB>(codes, qi, mask, d, b, q0, r_begin + int64_t(ld_t) * BN, r_end, ld_s * BK,
                     ring + ld_stage * T::STAGE_BYTES, tm);
      if (++ld_s == ks) {
        ld_s = 0;
        ++ld_t;
      }
    }
    cp_async_commit();  // empty groups keep the count aligned
    ++issued;
    ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
  };

  for (int s = 0; s < STAGES - 1; ++s) issue();

  typename T::Acc acc;
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;  // defined; each tile's first product overwrites

  int t = 0, s = 0, stage = 0;
  for (int64_t it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();  // slice `it` has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();              // ... everyone's; the stage refilled next is consumed
    issue();
    mma_slice<QB>(ring + stage * T::STAGE_BYTES, d - s * BK, s == 0, acc);
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    if (++s == ks) {
      epi(acc, r_begin + int64_t(t) * BN, mask != nullptr ? masks + (t % STAGES) * BN : nullptr);
      s = 0;
      ++t;
    }
  }
  cp_async_wait<0>();
}

}  // namespace tc
}  // namespace rr
