// The __dp4a tile of the block-max kernel (blockmax2.cu): a CTA holds QB
// queries and streams TILE corpus rows at a time through shared memory,
// computing the QB x TILE int32 dot products with __dp4a. Each thread owns
// a 4-query x 2-row register micro-tile, so one 16-byte shared-memory read
// feeds eight dp4a. (The int8 scan and score kernels use the tensor-core
// tile, int8_mma_tile.cuh.)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "topk_list.cuh"

namespace rr {

constexpr int QB = 32;        // queries per CTA
constexpr int TILE = 64;      // corpus rows per shared-memory tile
constexpr int THREADS = 256;  // 8 warps: warp = query group, lane = row
constexpr int PAD = 16;       // bytes added to each shared row: with a row
                              // stride of D + 16 the lanes' 16-byte reads
                              // fall on distinct banks
constexpr int SCORE_NONE = LIST_NONE;  // masked row / empty slot
constexpr float NEG = LIST_NEG;        // score of an empty output slot

__host__ __device__ constexpr size_t tile_smem_bytes(int d) {
  return size_t(QB) * d + size_t(TILE) * (d + PAD) + size_t(QB) * TILE * 4 + TILE;
}

// Queries [q0, q0 + QB) into s_q (row stride d); rows past b are zero.
__device__ inline void load_queries(const int8_t* qi, int b, int d, int q0, int8_t* s_q) {
  const int words = d / 16;
  for (int i = threadIdx.x; i < QB * words; i += blockDim.x) {
    const int q = i / words, w = i % words;
    int4 v = make_int4(0, 0, 0, 0);
    if (q0 + q < b) v = reinterpret_cast<const int4*>(qi + int64_t(q0 + q) * d)[w];
    reinterpret_cast<int4*>(s_q + q * d)[w] = v;
  }
}

// Corpus rows [r0, r0 + TILE) into s_c (row stride d + PAD). Rows at or past
// r_end are zero and flagged invalid, as are rows whose mask byte is 0.
__device__ inline void load_tile(const int8_t* codes, const uint8_t* mask, int64_t r0,
                                 int64_t r_end, int d, int8_t* s_c, uint8_t* s_valid) {
  const int words = d / 16;
  const int stride = d + PAD;
  for (int i = threadIdx.x; i < TILE * words; i += blockDim.x) {
    const int r = i / words, w = i % words;
    const int64_t row = r0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (row < r_end) v = reinterpret_cast<const int4*>(codes + row * d)[w];
    reinterpret_cast<int4*>(s_c + r * stride)[w] = v;
  }
  for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
    const int64_t row = r0 + r;
    s_valid[r] = (row < r_end) && (mask == nullptr || mask[row] != 0);
  }
}

__device__ inline int dp4a16(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// s_score[q * TILE + r] = <query q, row r> as int32, SCORE_NONE where the
// row is invalid. Warp w computes queries w, w+8, w+16, w+24; lane l rows
// l and l+32. Needs blockDim.x == THREADS.
__device__ inline void score_tile(const int8_t* s_q, const int8_t* s_c,
                                  const uint8_t* s_valid, int d, int* s_score) {
  const int tq = threadIdx.x / 32;
  const int tr = threadIdx.x % 32;
  const int stride = d + PAD;
  int acc[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
  const int4* c0 = reinterpret_cast<const int4*>(s_c + tr * stride);
  const int4* c1 = reinterpret_cast<const int4*>(s_c + (tr + 32) * stride);
  for (int w = 0; w < d / 16; ++w) {
    const int4 a = c0[w];
    const int4 b = c1[w];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int4 q = reinterpret_cast<const int4*>(s_q + (tq + 8 * j) * d)[w];
      acc[j][0] = dp4a16(q, a, acc[j][0]);
      acc[j][1] = dp4a16(q, b, acc[j][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = tq + 8 * j;
    s_score[q * TILE + tr] = s_valid[tr] ? acc[j][0] : SCORE_NONE;
    s_score[q * TILE + tr + 32] = s_valid[tr + 32] ? acc[j][1] : SCORE_NONE;
  }
}

}  // namespace rr
