// Exact BM25 of each query's sketch candidates and their top-k, in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this stage as XLA ops
// (radiant_rag_tpu/ops/bm25.py bm25_candidate_rescore, an equality join of
// the candidates' doc-major term rows with the query's terms over (B, KC,
// L, T), then lax.top_k), and the port ran the same join eagerly in
// PyTorch, the (B, KC, L, T) compare in device memory. Its plain version is
// ops/cuda_kernels.py bm25_rescore_topk_reference.
//
// Function. For query q and candidate row r = cand[q, c] (r < 0: a pad):
//   tf_t     = sum of dm_tfs[r, l] over the slots l with dm_tids[r, l] ==
//              q_tids[q, t] >= 0 (a term slot holding -1 matches nothing; a
//              term id twice in the query counts once per slot)
//   score    = sum over t of impact(idf_t, tf_t, doc_lens[r]), term slots
//              with id -1 adding 0; a pad scores -1e30
//   impact   = idf tf (k1 + 1) / max(tf + k1 ((1 - b) + b dl / max(avgdl,
//              1e-6)), 1e-6) in float32, in that operation order, every
//              product, quotient and sum rounded on its own (no FMA), so a
//              score does not depend on the instructions chosen
// then the k best by the 64-bit key (score descending as lax.top_k orders
// float32, then the tie value ascending): the tie value is the row (the
// row-sorted candidates' rule, so no sort of the candidates is needed), or
// the candidate's position where the caller keeps the scan's order. Out:
// (B, k) float32 scores and int32 rows, rows -1 where the score is not > 0.
// The sum over t is taken in a fixed order: each lane's own term slots in
// ascending order, then a butterfly over the warp's lanes.
//
// Bound on an H100: the candidates' doc-major rows are read once, B KC L 8
// bytes (0.50 GB at B = 2048, KC = 240, L = 128; 0.75 GB at KC = 360), at
// 3.35 TB/s: 0.15 / 0.23 ms. The compares (B KC L T: 2.0e9 / 3.0e9) are
// int32 equality tests at one per lane and cycle, under the bytes.
//
// Design. One CTA of 8 warps per query. Lane j holds term slots j, j + 32,
// ... (id, idf) in registers. Each warp walks its share of the candidates
// (c = warp, warp + 8, ...): a 3-stage ring of cp.async copies per warp
// brings a candidate's tid row, tf row and length into shared memory
// (16-byte copies: L % 4 == 0 and 16-byte aligned tables, which the caller
// checks) while the warp scores the one before it. Every lane reads
// the tid row by broadcast 16-byte loads and compares each id with its own
// terms; a match reads that slot's tf. The lanes' contributions are summed
// by a butterfly and lane 0 writes the candidate's key into shared memory.
// The CTA then sorts its keys (KC padded to a power of two, at most 4096)
// with topk_list.cuh's bitonic sort and writes the first k. Flat offsets
// are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "topk_list.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;           // copies in flight per warp
constexpr int MAX_KC = 4096;        // candidates per query (keys in shared memory)
constexpr int MAX_T = 128;          // term slots per query: 4 per lane
constexpr int MIN_KEYS = 32;        // the key array's least length (a power of two)
constexpr float NEG_INF = -1e30f;   // a pad candidate's score (ops/similarity.py NEG_INF)

struct Bm25 {
  float k1, b, one_minus_b, k1_plus_1;  // each rounded from the caller's double once
};

// Bytes of one ring stage: L tids, L tfs, the doc length, to 16 bytes.
__host__ __device__ constexpr int stage_bytes(int l) { return (8 * l + 4 + 15) / 16 * 16; }

__host__ __device__ constexpr int key_slots(int kc) {
  int p = MIN_KEYS;
  while (p < kc) p <<= 1;
  return p;
}

// Shared memory of one CTA: the keys, the warps' rings, the candidate rows.
constexpr size_t smem_bytes(int l, int kc) {
  return size_t(key_slots(kc)) * 8 + size_t(WARPS) * STAGES * stage_bytes(l) +
         (size_t(kc) * 4 + 15) / 16 * 16;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// torch.clamp_min: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }

// TPL: term slots per lane (T <= 32 TPL).
template <int TPL>
__global__ void __launch_bounds__(THREADS, 4)
bm25_rescore_topk_kernel(const int* __restrict__ dm_tids, const int* __restrict__ dm_tfs,
                         const float* __restrict__ doc_lens, const float* __restrict__ avgdl,
                         const int* __restrict__ cand, const int* __restrict__ q_tids,
                         const float* __restrict__ q_idfs, int kc, int l, int t, int k,
                         Bm25 c, int row_ties, float* __restrict__ out_s,
                         int* __restrict__ out_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = key_slots(kc);
  const int sb = stage_bytes(l);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* rings = smem + size_t(p) * 8;
  int* rows = reinterpret_cast<int*>(rings + size_t(WARPS) * STAGES * sb);
  const int64_t q = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kc; i += THREADS) rows[i] = cand[q * kc + i];
  for (int i = kc + threadIdx.x; i < p; i += THREADS) keys[i] = 0ull;
  int qt[TPL];
  float idf[TPL];
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < TPL; ++j) {
    const int s = lane + 32 * j;
    qt[j] = s < t ? q_tids[q * t + s] : -1;
    idf[j] = s < t ? q_idfs[q * t + s] : 0.f;
    if (qt[j] >= 0) live |= 1u << j;
  }
  const float avg = clamp_min(*avgdl, 1e-6f);
  __syncthreads();

  unsigned char* ring = rings + size_t(warp) * STAGES * sb;
  const int mine = warp < kc ? (kc - warp + WARPS - 1) / WARPS : 0;
  auto prefetch = [&](int i) {  // the warp's candidate i into stage i % STAGES
    const int r = rows[warp + i * WARPS];
    if (r < 0) return;
    unsigned char* st = ring + (i % STAGES) * sb;
    const int* src_t = dm_tids + int64_t(r) * l;
    const int* src_f = dm_tfs + int64_t(r) * l;
    for (int e = lane * 4; e < l; e += 32 * 4) {
      cp_async<16>(st + 4 * e, src_t + e);
      cp_async<16>(st + 4 * (l + e), src_f + e);
    }
    if (lane == 0) cp_async<4>(st + 8 * l, doc_lens + r);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < mine) prefetch(s);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    if (i + STAGES - 1 < mine) prefetch(i + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int ci = warp + i * WARPS;
    const int r = rows[ci];
    float score = NEG_INF;
    if (r >= 0) {
      const unsigned char* st = ring + (i % STAGES) * sb;
      const int* tids = reinterpret_cast<const int*>(st);
      const int* tfs = reinterpret_cast<const int*>(st + 4 * l);
      const float dl = *reinterpret_cast<const float*>(st + 8 * l);
      float tf[TPL];
#pragma unroll
      for (int j = 0; j < TPL; ++j) tf[j] = 0.f;
      auto take = [&](int d, int e) {
#pragma unroll
        for (int j = 0; j < TPL; ++j)
          if (((live >> j) & 1u) && d == qt[j]) tf[j] = __fadd_rn(tf[j], __int2float_rn(tfs[e]));
      };
#pragma unroll 4
      for (int e = 0; e < l; e += 4) {
        const int4 d = *reinterpret_cast<const int4*>(tids + e);
        take(d.x, e);
        take(d.y, e + 1);
        take(d.z, e + 2);
        take(d.w, e + 3);
      }
      // k1 ((1 - b) + (b dl) / avg), per candidate
      const float knorm = __fmul_rn(c.k1, __fadd_rn(c.one_minus_b,
                                                    __fdiv_rn(__fmul_rn(c.b, dl), avg)));
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < TPL; ++j) {
        if ((live >> j) & 1u) {
          const float denom = clamp_min(__fadd_rn(tf[j], knorm), 1e-6f);
          part = __fadd_rn(part, __fdiv_rn(__fmul_rn(__fmul_rn(idf[j], tf[j]), c.k1_plus_1),
                                           denom));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xFFFFFFFFu, part, o));
      score = part;
    }
    if (lane == 0)
      keys[ci] = rr::order_key(rr::f32_order(__float_as_int(score)),
                               row_ties ? static_cast<unsigned>(r) : static_cast<unsigned>(ci));
    __syncwarp();
  }
  __syncthreads();
  rr::bitonic_sort_desc(keys, p);
  for (int j = threadIdx.x; j < k; j += THREADS) {
    const unsigned long long key = keys[j];
    const float s = __int_as_float(rr::f32_order(rr::key_score(key)));
    const int tie = rr::key_row(key);
    const int r = row_ties ? tie : rows[tie];
    out_s[q * k + j] = s;
    out_r[q * k + j] = s > 0.f ? r : -1;
  }
}

using Kernel = void (*)(const int*, const int*, const float*, const float*, const int*,
                        const int*, const float*, int, int, int, int, Bm25, int, float*, int*);

Kernel pick_tpl(int t) {
  if (t <= 32) return bm25_rescore_topk_kernel<1>;
  if (t <= 64) return bm25_rescore_topk_kernel<2>;
  return bm25_rescore_topk_kernel<4>;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Shapes: tables (N, L) int32, doc_lens (>= N,) f32, avgdl one f32, cand
// (b, kc) int32, q_tids (b, t) int32, q_idfs (b, t) f32; out (b, k).
// Returns LAYOUT_MISMATCH before any launch when smem_expected is not the
// layout's, cudaErrorInvalidValue for a shape outside the kernel's range
// (L % 4 != 0, or term tables off a 16-byte boundary, among them), else the
// launch's error.
extern "C" int rr_bm25_rescore_topk(const void* dm_tids, const void* dm_tfs,
                                    const void* doc_lens, const void* avgdl, const void* cand,
                                    const void* q_tids, const void* q_idfs, int b, int kc, int l,
                                    int t, int k, float k1, float bm25_b, float one_minus_b,
                                    float k1_plus_1, int row_ties, int64_t smem_expected,
                                    void* out_s, void* out_r, void* stream) {
  if (b < 1 || kc < 1 || kc > MAX_KC || k < 1 || k > kc || t < 0 || t > MAX_T || l < 0 ||
      l % 4 != 0 || !aligned16(dm_tids) || !aligned16(dm_tfs))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(l, kc);
  if (static_cast<int64_t>(smem) != smem_expected) return rr::LAYOUT_MISMATCH;
  const Kernel fn = pick_tpl(t);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fn<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dm_tids), static_cast<const int*>(dm_tfs),
      static_cast<const float*>(doc_lens), static_cast<const float*>(avgdl),
      static_cast<const int*>(cand), static_cast<const int*>(q_tids),
      static_cast<const float*>(q_idfs), kc, l, t, k, Bm25{k1, bm25_b, one_minus_b, k1_plus_1},
      row_ties, static_cast<float*>(out_s), static_cast<int*>(out_r));
  return cudaGetLastError();
}
