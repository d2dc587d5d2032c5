// Exact top-k machinery of the scan kernels: the (score, row) order key and
// the merge launch that combines the corpus splits' lists into the final
// (B, k) answer (tc_scan_topk.cuh; the lists themselves are kept there).
// The BM25 rescore (bm25_rescore_topk.cu) keys its float scores the same
// way, mapped to ordered integers by f32_order, and sorts them with the same
// bitonic sort.
//
// Order: score descending, then row ascending (the Pallas kernels' first-
// index rule and lax.top_k's).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace rr {

constexpr int LIST_NONE = INT_MIN;  // masked row / empty slot
constexpr float LIST_NEG = -3.0e38f;  // score of an empty output slot
// Returned by a scan entry, before any launch, when the shared memory its
// caller computed for the partial CTA is not what the kernel's layout takes.
constexpr int LAYOUT_MISMATCH = -1;

// lax.top_k's total order of float32 as an int32 (-0.0 below +0.0), for
// keys of float scores: ops/similarity.py _f32_order. Its own inverse.
__device__ inline int f32_order(int bits) { return bits ^ ((bits >> 31) & 0x7FFFFFFF); }

// Total order of the selection as a 64-bit key, larger for a better entry;
// 0 is an empty slot.
__device__ inline unsigned long long order_key(int score, unsigned row) {
  if (score == LIST_NONE) return 0ull;
  return (static_cast<unsigned long long>(static_cast<unsigned>(score) ^ 0x80000000u) << 32) |
         static_cast<unsigned long long>(0xFFFFFFFFu - row);
}

__device__ inline int key_score(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key >> 32) ^ 0x80000000u);
}

__device__ inline int key_row(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull));
}

// Bitonic sort of p keys in shared memory, largest first, by the whole CTA
// (p: a power of two). Call after the keys are written and synchronised;
// returns synchronised.
__device__ inline void bitonic_sort_desc(unsigned long long* keys, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool desc = (i & size) == 0;
          const unsigned long long a = keys[i], c = keys[j];
          if ((a < c) == desc) { keys[i] = c; keys[j] = a; }
        }
      }
      __syncthreads();
    }
  }
}

// One CTA per query merges its splits * k partial entries with a bitonic
// sort of 64-bit (score, row) keys and writes the first k.
// p: power of two >= splits * k.
static __global__ void topk_merge(const int* __restrict__ part_s, const int* __restrict__ part_r,
                           int splits, int k, int p, float* __restrict__ out_s,
                           int* __restrict__ out_r) {
  extern __shared__ unsigned long long keys[];
  const int64_t q = blockIdx.x;
  const int m = splits * k;
  const int64_t base = q * m;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    unsigned long long key = 0ull;
    if (i < m) {
      const int r = part_r[base + i];
      if (r >= 0) key = order_key(part_s[base + i], static_cast<unsigned>(r));
    }
    keys[i] = key;
  }
  __syncthreads();
  bitonic_sort_desc(keys, p);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const unsigned long long key = keys[j];
    const int64_t o = q * k + j;
    out_s[o] = key ? static_cast<float>(key_score(key)) : LIST_NEG;
    out_r[o] = key ? key_row(key) : -1;
  }
}

static inline cudaError_t launch_topk_merge(const int* part_s, const int* part_r, int b,
                                            int splits, int k, int p, float* out_s,
                                            int* out_r, cudaStream_t st) {
  const size_t msmem = size_t(p) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(msmem));
  if (err != cudaSuccess) return err;
  topk_merge<<<b, 256, msmem, st>>>(part_s, part_r, splits, k, p, out_s, out_r);
  return cudaGetLastError();
}

}  // namespace rr
