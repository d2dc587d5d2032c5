// Int8 tensor-core tile of the int8 scans (int8_scores.cu, int8_scan_topk.cu)
// and of the Hamming scans (hamming.cu).
//
// A CTA of 8 warps (two warpgroups) computes a QB-query x 128-row block of
// int32 dot products qi . codes^T (QB = 128, 64, or 32 where a caller's
// shared memory needs it) and walks its rows in 128-row tiles, handing each
// finished block to an epilogue. The K loop takes K in 64-byte slices, two
// 32-byte product steps each. A producer fills the ring: Int8Rows copies
// int8 rows (K = D bytes); SignWords unpacks packed sign words into +-1
// bytes (K = 32 W: one byte per bit), so that the same product gives
// <s_q, s_c> = 32 W - 2 hamming(q, c).
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
//   - Sign words (SignWords): a slice is 2 words of a row, 8x fewer bytes
//     read than int8 rows of the same K. There is no shared memory left for
//     a staging ring of packed words (the scan's lists take it), so each
//     thread holds the packed words of the next slice in registers (at most
//     2: 2 words x (QB + 128) rows over 256 threads), loaded one slice
//     ahead. While the current slice's wgmma runs, the threads unpack them
//     (bit j of word x -> K byte 32 x + j, +1 where set, -1 where clear)
//     with st.shared into the free stage, in the same swizzle; the next
//     barrier's fence.proxy.async makes them visible to the tensor cores.
//     (ptxas keeps that overlap in the score kernels. In the scans, whose
//     epilogue reads the accumulators on divergent paths, it serializes
//     the wgmma instead: its C7520 note in the build log.)
//     Words that do not exist (queries past B, rows past the range, words
//     past W) are zero bytes. A 32-byte product step is exactly one word,
//     so an odd W leaves the last slice's second step out, as a D tail does.
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
constexpr int SLICE_WORDS = 2;   // sign words per row per slice (one K byte per bit)
static_assert(SLICE_WORDS * 32 == BK, "a slice holds whole sign words");

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

// fence.proxy.async: the cp.async and st.shared writes become visible to
// the tensor cores' reads (the async proxy) once the CTA has synchronised.
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

// A tile's 128 mask bytes into tile_mask (cp.async); bytes past r_end are
// zero-filled, so a missing row reads as masked off.
__device__ __forceinline__ void load_mask(const uint8_t* __restrict__ mask, int64_t r0,
                                          int64_t r_end, uint8_t* tile_mask) {
  if (threadIdx.x < BN / 16) {
    const int64_t r = r0 + 16 * threadIdx.x;
    const int64_t left = r_end - r;
    const int bytes = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
    cp_async16(smem_u32(tile_mask + 16 * threadIdx.x), bytes ? mask + r : mask, bytes);
  }
}

// Producers. A producer fills one ring stage with slice s (K bytes
// [64 s, 64 s + 64)) of queries [q0, q0 + QB) (stage rows [0, QB)) and of
// code rows [r0, r0 + 128) (stage rows [QB, QB + 128)):
//   k_bytes()                       K of one row
//   fetch(q0, r0, r_end, s)         start reading slice s (before its store)
//   store(stage, q0, r0, r_end, s)  fill the stage with the fetched slice
//   kOverlap                        store runs while the product runs

// int8 rows (N, D) and (B, D): cp.async straight into the stage, zero-
// filled by source size past B, past r_end and past D.
template <int QB>
struct Int8Rows {
  const int8_t* __restrict__ codes;
  const int8_t* __restrict__ qi;
  int d, b;
  static constexpr bool kOverlap = false;  // the copies run ahead by themselves

  __device__ __forceinline__ int k_bytes() const { return d; }
  __device__ __forceinline__ void fetch(int, int64_t, int64_t, int) {}
  __device__ __forceinline__ void store(unsigned char* stage, int q0, int64_t r0,
                                        int64_t r_end, int s) const {
    const uint32_t base = smem_u32(stage);
    const int kb0 = s * BK;
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
  }
};

// Bits 0-3 of v as 4 bytes of +-1 (byte j: +1 where bit j is set, else -1):
// the multiply moves bit j to bit 8 j (no carries: the four copies of the
// nibble do not overlap), 0xFE per byte and the complement give 0x01 / 0xFF.
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t v) {
  return ~((((v & 0xFu) * 0x00204081u) & 0x01010101u) * 0xFEu);
}

// Packed sign words: (N, W) codes, or (W, N) when TRANSPOSED, and (B, W)
// queries, as 32-bit words (the JAX package's uint32 sign bits). Item i of
// a slice is one word of one stage row; a thread holds ITEMS of them.
template <int QB, bool TRANSPOSED>
struct SignWords {
  const uint32_t* __restrict__ codes;
  const uint32_t* __restrict__ q;
  int64_t n;
  int w, b;
  static constexpr int ROWS = QB + BN;
  static constexpr int ITEMS = (SLICE_WORDS * ROWS + THREADS - 1) / THREADS;
  static constexpr bool kOverlap = true;
  uint32_t held[ITEMS];  // the fetched words
  unsigned live = 0;     // bit j: held[j] is a word that exists

  __device__ __forceinline__ int k_bytes() const { return 32 * w; }

  // Item i -> (stage row, word of the slice). Row-major codes: a row's two
  // words on neighbouring threads; transposed: neighbouring rows.
  __device__ static __forceinline__ void item(int i, int& row, int& h) {
    if (TRANSPOSED) {
      h = i / ROWS;
      row = i % ROWS;
    } else {
      row = i / SLICE_WORDS;
      h = i % SLICE_WORDS;
    }
  }

  __device__ __forceinline__ void fetch(int q0, int64_t r0, int64_t r_end, int s) {
    live = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      held[j] = 0u;
      if (i < SLICE_WORDS * ROWS) {
        int row, h;
        item(i, row, h);
        const int x = s * SLICE_WORDS + h;
        if (x < w) {
          if (row < QB) {
            if (q0 + row < b) {
              held[j] = q[int64_t(q0 + row) * w + x];
              live |= 1u << j;
            }
          } else {
            const int64_t r = r0 + (row - QB);
            if (r < r_end) {
              held[j] = TRANSPOSED ? codes[int64_t(x) * n + r] : codes[r * w + x];
              live |= 1u << j;
            }
          }
        }
      }
    }
  }

  // Word h of the slice is K bytes [32 h, 32 h + 32): chunks 2 h (bits 0-15)
  // and 2 h + 1 (bits 16-31).
  __device__ __forceinline__ void store(unsigned char* stage, int, int64_t, int64_t, int) const {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i < SLICE_WORDS * ROWS) {
        int row, h;
        item(i, row, h);
        const uint32_t v = held[j];
        const bool ok = (live >> j) & 1u;
        const uint4 lo = ok ? make_uint4(pm1_bytes(v), pm1_bytes(v >> 4), pm1_bytes(v >> 8),
                                         pm1_bytes(v >> 12))
                            : make_uint4(0u, 0u, 0u, 0u);
        const uint4 hi = ok ? make_uint4(pm1_bytes(v >> 16), pm1_bytes(v >> 20),
                                         pm1_bytes(v >> 24), pm1_bytes(v >> 28))
                            : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(stage + swz(row, 2 * h)) = lo;
        *reinterpret_cast<uint4*>(stage + swz(row, 2 * h + 1)) = hi;
      }
    }
  }
};

// Issue the slice's product for this thread's warpgroup, acc += it (acc =
// it for the first slice of a tile, so the accumulators need no zeroing
// between products); `left` = bytes of K from the slice's start (a 32-byte
// step wholly past K is skipped). With QB = 32 the descriptor's 64 query
// rows run into the code rows; the fragment's queries 32-63 are ignored by
// the callers. The accumulators are not to be touched until wgmma_wait0.
template <int QB>
__device__ __forceinline__ void mma_issue(const unsigned char* stage, int left, bool first,
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
}

// Stream rows [r_begin, r_end) against queries [q0, q0 + QB) in 128-row
// tiles; after each tile, epi(acc, first row of the tile, its mask bytes or
// nullptr) with every thread of the CTA. The epilogue may synchronise the
// CTA. Uses Tile<QB>::RING_BYTES of shared memory at `ring`.
template <int QB, class Producer, class Epilogue>
__device__ __forceinline__ void scan_tiles(Producer& prod, const uint8_t* __restrict__ mask,
                                           int q0, int64_t r_begin, int64_t r_end,
                                           unsigned char* ring, Epilogue&& epi) {
  using T = Tile<QB>;
  const int kbytes = prod.k_bytes();
  const int ks = (kbytes + BK - 1) / BK;  // slices per tile
  const int ntiles = r_end > r_begin ? static_cast<int>((r_end - r_begin + BN - 1) / BN) : 0;
  const int64_t total = int64_t(ntiles) * ks;
  uint8_t* masks = ring + STAGES * T::STAGE_BYTES;

  // producer position: slice ld_s of tile ld_t into stage ld_stage
  int64_t issued = 0;
  int ld_t = 0, ld_s = 0, ld_stage = 0;
  if (total > 0) prod.fetch(q0, r_begin, r_end, 0);
  auto issue = [&]() {
    if (issued < total) {
      const int64_t r0 = r_begin + int64_t(ld_t) * BN;
      prod.store(ring + ld_stage * T::STAGE_BYTES, q0, r0, r_end, ld_s);
      if (ld_s == 0 && mask != nullptr) load_mask(mask, r0, r_end, masks + (ld_t % STAGES) * BN);
      if (++ld_s == ks) {
        ld_s = 0;
        ++ld_t;
      }
      if (issued + 1 < total) prod.fetch(q0, r_begin + int64_t(ld_t) * BN, r_end, ld_s);
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
    fence_proxy_async();          // (and this thread's st.shared of it)
    __syncthreads();              // ... everyone's; the stage refilled next is consumed
    const unsigned char* cur = ring + stage * T::STAGE_BYTES;
    if constexpr (Producer::kOverlap) {  // fill the free stage under the product
      mma_issue<QB>(cur, kbytes - s * BK, s == 0, acc);
      issue();
    } else {
      issue();
      mma_issue<QB>(cur, kbytes - s * BK, s == 0, acc);
    }
    wgmma_wait0();
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
