// The filtered top-k epilogue of the tensor-core scans (int8_scan_topk.cu,
// hamming.cu): per-query sorted lists in shared memory behind a register
// filter and 16-entry queues, the partial kernel's body over any producer
// of int8_mma_tile.cuh, and the launch of partial + merge.
//
// A CTA streams its corpus split in 128-row tiles through the tensor-core
// tile (64 queries) and keeps each query's top-k as a sorted list in shared
// memory. The epilogue is filtered: each query's k-th (score, row) sits in
// shared memory and is read once per tile; accumulators are compared with
// it in registers, and only the keys above it (masked rows and rows past N
// never) go to a 16-entry queue per query. The queues are drained only when
// one of them is full (and at the end of the split): a drain is a CTA-wide
// stop, and a tile adds a candidate to some query's queue almost every
// time. A stale k-th key only lets more candidates through. One warp
// drains a query's queue into its list with a warp-parallel shifted insert
// that compares full (score, row) keys: the queue is not in row order, and
// the lowest-row rule at ties must hold. Candidates that found a queue full
// stay in registers, are compared again with the raised k-th key after the
// drain, and go in then. The lists take 64 * k * 8 bytes; where that does
// not fit (k > 363) the CTA holds 32 queries (scan_qb). A second launch,
// one CTA per query, merges the splits' lists (topk_list.cuh).
#pragma once

#include "int8_mma_tile.cuh"
#include "topk_list.cuh"

namespace rr {
namespace tc {

constexpr int QCAP = 16;                 // queue entries per query
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory of one CTA
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr size_t scan_smem_bytes(int qb, int k) {
  // ring (+ masks), then k-th score, k-th row and queue count per query,
  // the queues and the lists, (score, row) int32 pairs each
  return size_t(STAGES) * ((qb + BN) * BK + BN) + size_t(qb) * 4 * 3 +
         size_t(qb) * QCAP * 8 + size_t(qb) * k * 8;
}

// Queries per CTA at list length k: 64 where the lists fit, else 32.
__host__ __device__ constexpr int scan_qb(int k) {
  return scan_smem_bytes(64, k) <= size_t(SMEM_LIMIT) ? 64 : 32;
}

// (s1, r1) comes before (s2, r2): higher score, then lower row.
__device__ __forceinline__ bool key_gt(int s1, int r1, int s2, int r2) {
  return s1 > s2 || (s1 == s2 && r1 < r2);
}

struct Lists {
  int* ts;   // [qb] score of the k-th entry
  int* tr;   // [qb] row of the k-th entry
  int* cnt;  // [qb] queue fill (may overshoot QCAP)
  int* qs;   // [qb][QCAP] queued scores
  int* qr;   // [qb][QCAP] queued rows
  int* ls;   // [qb][k] sorted scores (LIST_NONE = empty)
  int* lr;   // [qb][k] their rows (-1 = empty)
  int k;
  int qb;
};

// One warp merges query q's queue into its list in one pass: the queued
// keys that beat the k-th are sorted in the warp (bitonic, 64-bit order
// keys), each finds its place in the list by binary search, and each list
// entry moves up by the number of queued keys above it, the top 32-entry
// chunk first, so that a chunk is read before anything lands on it. Lane 0
// then publishes the new k-th key and empties the queue.
__device__ __forceinline__ void drain_queue(const Lists& L, int q, int lane) {
  const int m = min(L.cnt[q], QCAP);
  if (m == 0) return;
  const int k = L.k;
  int* ls = L.ls + q * k;
  int* lr = L.lr + q * k;
  const unsigned long long kth = order_key(ls[k - 1], static_cast<unsigned>(lr[k - 1]));
  unsigned long long key = 0;  // 0: no candidate
  if (lane < m) {
    key = order_key(L.qs[q * QCAP + lane], static_cast<unsigned>(L.qr[q * QCAP + lane]));
    if (key <= kth) key = 0;
  }
  const int mc = __popc(__ballot_sync(FULL, key != 0));
  if (mc > 0) {
    // descending across the warp: lane i holds the i-th best candidate
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const unsigned long long other = __shfl_xor_sync(FULL, key, stride);
        const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
        key = keep_max ? (key > other ? key : other) : (key < other ? key : other);
      }
    // candidate i lands at i + (list entries above it)
    int pos = k;
    if (lane < mc) {
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (order_key(ls[mid], static_cast<unsigned>(lr[mid])) > key) lo = mid + 1;
        else hi = mid;
      }
      pos = lane + lo;
    }
    const int first = __shfl_sync(FULL, pos, 0);  // entries above it stay
    for (int base = ((k - 1) / 32) * 32; base + 31 >= first; base -= 32) {
      const int j = base + lane;
      const bool mv = j >= first && j < k;
      int vs = LIST_NONE, vr = -1;
      if (mv) {
        vs = ls[j];
        vr = lr[j];
      }
      const unsigned long long kj = order_key(vs, static_cast<unsigned>(vr));
      int c = 0;  // queued keys above entry j (branch-free search of the sorted lanes)
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const unsigned long long ck = __shfl_sync(FULL, key, c + step - 1);
        if (c + step <= mc && ck > kj) c += step;
      }
      const int to = mv ? j + c : k;
      __syncwarp();
      if (to < k) {
        ls[to] = vs;
        lr[to] = vr;
      }
      __syncwarp();
    }
    if (pos < k) {
      ls[pos] = key_score(key);
      lr[pos] = key_row(key);
    }
    __syncwarp();
  }
  if (lane == 0) {
    L.ts[q] = ls[k - 1];
    L.tr[q] = lr[k - 1];
    L.cnt[q] = 0;
  }
}

// Every queue into its list, one warp per query at a time.
__device__ __forceinline__ void drain_all(const Lists& L) {
  for (int q = threadIdx.x / 32; q < L.qb; q += THREADS / 32) drain_queue(L, q, threadIdx.x % 32);
}

// The filtered top-k epilogue of one tile (all threads of the CTA).
// q_live: queries of the block that exist (<= QB).
template <int QB>
__device__ __forceinline__ void filter_tile(typename Tile<QB>::Acc& acc, const Lists& L,
                                            int64_t r0, int64_t r_end, const uint8_t* tmask,
                                            int q_live) {
  using T = Tile<QB>;
  constexpr int NT = T::NT;
  static_assert(NT * 4 <= 32, "one bit per accumulator");
  // this thread's rows are row0 + 8 nt + j
  const int row0 = static_cast<int>(r0) + T::r(0, 0);
  uint32_t rv = 0;  // bit 2 nt + j: row valid
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int rl = T::r(nt, j);
      if (r0 + rl < r_end && (tmask == nullptr || tmask[rl] != 0)) rv |= 1u << (2 * nt + j);
    }
  int ql[2], ts[2], tr[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ql[h] = T::q(h);
    live[h] = ql[h] < q_live;
    ts[h] = live[h] ? L.ts[ql[h]] : LIST_NONE;
    tr[h] = live[h] ? L.tr[ql[h]] : -1;
  }
  // bit nt * 4 + i: accumulator (nt, i) still to be queued
  uint32_t pend = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1, j = i & 1;
      if (live[h] && ((rv >> (2 * nt + j)) & 1) &&
          key_gt(acc[nt][i], row0 + 8 * nt + j, ts[h], tr[h]))
        pend |= 1u << (nt * 4 + i);
    }

  // queue what passes; drain only when some queue is full (deferred
  // drains see a stale k-th key, which only lets more candidates through)
  for (;;) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t bit = 1u << (nt * 4 + i);
        if (pend & bit) {
          const int q = ql[i >> 1];
          const int pos = atomicAdd(L.cnt + q, 1);
          if (pos < QCAP) {
            L.qs[q * QCAP + pos] = acc[nt][i];
            L.qr[q * QCAP + pos] = row0 + 8 * nt + (i & 1);
            pend &= ~bit;
          }
        }
      }
    if (!__syncthreads_or(pend != 0)) break;
    drain_all(L);
    __syncthreads();
    // what is still pending competes with the raised k-th keys
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (live[h]) {
        ts[h] = L.ts[ql[h]];
        tr[h] = L.tr[ql[h]];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t bit = 1u << (nt * 4 + i);
        if ((pend & bit) &&
            !key_gt(acc[nt][i], row0 + 8 * nt + (i & 1), ts[i >> 1], tr[i >> 1]))
          pend &= ~bit;
      }
  }
}

// The partial launch's CTA: query block blockIdx.x, corpus split blockIdx.y;
// its lists go to part_s / part_r (b, splits, k).
template <int QB, class Producer>
__device__ __forceinline__ void scan_topk_body(Producer& prod, const uint8_t* __restrict__ mask,
                                               int64_t n, int b, int k, int64_t rows_per_split,
                                               int* __restrict__ part_s,
                                               int* __restrict__ part_r) {
  extern __shared__ __align__(1024) unsigned char smem[];
  Lists L;
  L.ts = reinterpret_cast<int*>(smem + Tile<QB>::RING_BYTES);
  L.tr = L.ts + QB;
  L.cnt = L.tr + QB;
  L.qs = L.cnt + QB;
  L.qr = L.qs + QB * QCAP;
  L.ls = L.qr + QB * QCAP;
  L.lr = L.ls + QB * k;
  L.k = k;
  L.qb = QB;

  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int64_t r_begin = int64_t(split) * rows_per_split;
  const int64_t r_end = r_begin + rows_per_split < n ? r_begin + rows_per_split : n;

  for (int i = threadIdx.x; i < QB * k; i += THREADS) {
    L.ls[i] = LIST_NONE;
    L.lr[i] = -1;
  }
  for (int i = threadIdx.x; i < QB; i += THREADS) {
    L.ts[i] = LIST_NONE;
    L.tr[i] = -1;
    L.cnt[i] = 0;
  }
  __syncthreads();
  scan_tiles<QB>(prod, mask, q0, r_begin, r_end, smem,
                 [&](typename Tile<QB>::Acc& acc, int64_t r0, const uint8_t* tmask) {
                   filter_tile<QB>(acc, L, r0, r_end, tmask, min(QB, b - q0));
                 });
  __syncthreads();
  drain_all(L);
  __syncthreads();
  for (int i = threadIdx.x; i < QB * k; i += THREADS) {
    const int q = i / k, j = i % k;
    if (q0 + q >= b) continue;
    const int64_t off = (int64_t(q0 + q) * splits + split) * k + j;
    part_s[off] = L.ls[i];
    part_r[off] = L.lr[i];
  }
}

// A partial kernel: (codes, queries, mask, n, D or W, b, k, rows per split,
// part_s, part_r), built for 64 and for 32 queries per CTA.
using PartialKernel = void (*)(const void*, const void*, const uint8_t*, int64_t, int, int, int,
                               int64_t, int*, int*);

// CTAs of the partial launch one SM holds at list length k (registers and
// shared memory, as the occupancy API computes them from the built kernel).
inline int scan_ctas_per_sm(PartialKernel k64, PartialKernel k32, int k, int* ctas) {
  const int qb = scan_qb(k);
  const int smem = static_cast<int>(scan_smem_bytes(qb, k));
  const void* fn = reinterpret_cast<const void*>(qb == 64 ? k64 : k32);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, THREADS, smem);
}

// The partial launch on the wrapper's plan (refused with LAYOUT_MISMATCH
// when its shared memory or row tile is not this layout's), then the merge.
inline int scan_topk_launch(PartialKernel k64, PartialKernel k32, const void* codes,
                            const void* q, const void* mask, int64_t n, int width, int b, int k,
                            int splits, int64_t rows_per_split, int merge_p,
                            int64_t smem_expected, void* part_s, void* part_r, void* out_s,
                            void* out_r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qb = scan_qb(k);
  const size_t smem = scan_smem_bytes(qb, k);
  if (static_cast<int64_t>(smem) != smem_expected || rows_per_split % BN != 0)
    return LAYOUT_MISMATCH;
  const PartialKernel fn = qb == 64 ? k64 : k32;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((b + qb - 1) / qb, splits);
  fn<<<grid, THREADS, smem, st>>>(codes, q, static_cast<const uint8_t*>(mask), n, width, b, k,
                                  rows_per_split, static_cast<int*>(part_s),
                                  static_cast<int*>(part_r));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_topk_merge(static_cast<const int*>(part_s), static_cast<const int*>(part_r), b,
                           splits, k, merge_p, static_cast<float*>(out_s),
                           static_cast<int*>(out_r), st);
}

}  // namespace tc
}  // namespace rr
