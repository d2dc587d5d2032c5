// Exact top-k machinery of the scan kernels: the (score, row) order key and
// the merge launch that combines the corpus splits' lists into the final
// (B, k) answer (int8_scan_topk.cu, hamming.cu), and the Hamming scan's
// per-query sorted list in shared memory that one warp updates from a
// scored 64-row tile (hamming.cu; the int8 scan keeps its lists itself).
//
// Order: score descending, then row ascending (the Pallas kernels' first-
// index rule and lax.top_k's). A tile's rows arrive in ascending order, so
// a row enters a list only when its score is strictly above the k-th: among
// equal scores the lower rows, which came first, keep their places.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace rr {

constexpr int LIST_QB = 32;         // queries per CTA (one list each)
constexpr int LIST_TILE = 64;       // rows per scored tile
constexpr int LIST_NONE = INT_MIN;  // masked row / empty slot
constexpr float LIST_NEG = -3.0e38f;  // score of an empty output slot
// Returned by a scan entry, before any launch, when the shared memory its
// caller computed for the partial CTA is not what the kernel's layout takes.
constexpr int LAYOUT_MISMATCH = -1;

__host__ __device__ constexpr size_t list_smem_bytes(int k) {
  return size_t(2) * LIST_QB * k * 4;  // scores + rows
}

// List entries each lane shifts per insert: 8 up to k = 256, 16 up to 512.
// A kernel is built for each; the 16-slot insert holds 32 more registers
// per thread, which costs the smaller k a CTA per SM.
__host__ __device__ constexpr bool list_wide(int k) { return k > 256; }

// Insert the accepted rows of one scored tile (sc[r] for rows row0 + r,
// LIST_NONE where invalid) into one query's list (ls scores, lr rows, both
// of length k <= 32 * SLOTS, sorted). Called by one whole warp.
template <int SLOTS>
__device__ inline void insert_tile(const int* sc, int* ls, int* lr, int k, int64_t row0,
                                   int lane) {
  int thresh = ls[k - 1];
  for (int base = 0; base < LIST_TILE; base += 32) {
    const int s = sc[base + lane];
    unsigned bal = __ballot_sync(0xffffffffu, s > thresh);
    while (bal) {
      const int src = __ffs(bal) - 1;
      bal &= bal - 1;
      const int ns = __shfl_sync(0xffffffffu, s, src);
      if (ns <= thresh) continue;  // the list moved on (warp-uniform)
      const int nrow = static_cast<int>(row0 + base + src);
      int cnt = 0;
      for (int j = lane; j < k; j += 32) cnt += (ls[j] >= ns);
      const int pos = __reduce_add_sync(0xffffffffu, cnt);  // < k: ns > ls[k-1]
      int ts[SLOTS], tr[SLOTS];
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const int j = lane + 32 * t;
        if (j < k && j > pos) { ts[t] = ls[j - 1]; tr[t] = lr[j - 1]; }
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) {
        const int j = lane + 32 * t;
        if (j < k && j > pos) { ls[j] = ts[t]; lr[j] = tr[t]; }
      }
      if (lane == 0) { ls[pos] = ns; lr[pos] = nrow; }
      __syncwarp();
      thresh = ls[k - 1];
    }
  }
}

// Empty lists: every slot (LIST_NONE, -1).
__device__ inline void init_lists(int* s_ls, int* s_lr, int k) {
  for (int i = threadIdx.x; i < LIST_QB * k; i += blockDim.x) {
    s_ls[i] = LIST_NONE;
    s_lr[i] = -1;
  }
}

// Write the CTA's lists to the partial buffers (b, splits, k).
__device__ inline void store_lists(const int* s_ls, const int* s_lr, int q0, int b, int k,
                                   int split, int splits, int* part_s, int* part_r) {
  for (int i = threadIdx.x; i < LIST_QB * k; i += blockDim.x) {
    const int q = i / k, j = i % k;
    if (q0 + q >= b) continue;
    const int64_t off = (int64_t(q0 + q) * splits + split) * k + j;
    part_s[off] = s_ls[i];
    part_r[off] = s_lr[i];
  }
}

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
