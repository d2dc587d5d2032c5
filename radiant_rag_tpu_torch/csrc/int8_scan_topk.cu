// Fused int8 scan -> exact per-query top-k, without a (B, N) score matrix.
//
// Replaces radiant_rag_tpu/ops/pallas_kernels.py: int8_scan_topk_pallas
// (_scan_topk_kernel). Same function: scores = qi . codes^T accumulated in
// int32, rows whose mask byte is 0 excluded, the k best per query in the
// order (score descending, row ascending) -- the Pallas kernel's first-index
// rule and lax.top_k's. Empty slots return score -3e38 and row -1.
//
// Bound on an H100: the int8 operations, 2*B*N*D (1.65 TOP for the dense leg
// and 4.40 TOP for the BM25 sketch leg at B = 2048, N = 2^20), against
// 1,979 dense int8 TOP/s; the codes are read once (0.4 / 1.1 GB). This
// first version runs on __dp4a (CUDA cores, not tensor cores), so it sits
// far from that bound; wgmma + TMA are later work.
//
// Design. The TPU kernel carried a running top-k across a sequential grid.
// Here CTAs run in parallel, so the work is split in two launches:
//   1. grid (query blocks of 32) x (corpus splits). A CTA streams its split
//      in 64-row tiles (int8_tile.cuh) and keeps each query's top-k as a
//      sorted list in shared memory. Rows arrive in ascending order, so a
//      row enters the list only when its score is strictly above the k-th
//      and ties keep the lower row. One warp updates one list: ballot over
//      the tile, then a warp-parallel shifted insert per accepted row.
//   2. one CTA per query merges its splits * k partial entries with a
//      bitonic sort of 64-bit (score, row) keys and writes the first k.
// Flat offsets are 64-bit: at B = 2048 and N = 2^20, B * N = 2^31.

#include "int8_tile.cuh"

namespace {

using namespace rr;

// Insert the accepted rows of one scored tile into one query's list.
__device__ void insert_tile(const int* sc, int* ls, int* lr, int k, int64_t row0, int lane) {
  int thresh = ls[k - 1];
  for (int base = 0; base < TILE; base += 32) {
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
      int ts[8], tr[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j = lane + 32 * t;
        if (j < k && j > pos) { ts[t] = ls[j - 1]; tr[t] = lr[j - 1]; }
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j = lane + 32 * t;
        if (j < k && j > pos) { ls[j] = ts[t]; lr[j] = tr[t]; }
      }
      if (lane == 0) { ls[pos] = ns; lr[pos] = nrow; }
      __syncwarp();
      thresh = ls[k - 1];
    }
  }
}

size_t partial_smem_bytes(int d, int k) {
  return tile_smem_bytes(d) + size_t(2) * QB * k * 4;
}

__global__ void __launch_bounds__(THREADS)
scan_topk_partial(const int8_t* __restrict__ codes, const int8_t* __restrict__ qi,
                  const uint8_t* __restrict__ mask, int64_t n, int d, int b, int k,
                  int64_t rows_per_split, int* __restrict__ part_s, int* __restrict__ part_r) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_q = reinterpret_cast<int8_t*>(smem);
  int8_t* s_c = s_q + QB * d;
  int* s_score = reinterpret_cast<int*>(s_c + TILE * (d + PAD));
  int* s_ls = s_score + QB * TILE;
  int* s_lr = s_ls + QB * k;
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_lr + QB * k);

  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int64_t r_begin = int64_t(split) * rows_per_split;
  const int64_t r_end = r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_queries(qi, b, d, q0, s_q);
  for (int i = threadIdx.x; i < QB * k; i += blockDim.x) {
    s_ls[i] = SCORE_NONE;
    s_lr[i] = -1;
  }
  for (int64_t t0 = r_begin; t0 < r_end; t0 += TILE) {
    __syncthreads();  // previous tile fully consumed
    load_tile(codes, mask, t0, r_end, d, s_c, s_valid);
    __syncthreads();
    score_tile(s_q, s_c, s_valid, d, s_score);
    __syncthreads();
    for (int j = 0; j < QB / 8; ++j) {
      const int q = warp + 8 * j;
      if (q0 + q < b) insert_tile(s_score + q * TILE, s_ls + q * k, s_lr + q * k, k, t0, lane);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < QB * k; i += blockDim.x) {
    const int q = i / k, j = i % k;
    if (q0 + q >= b) continue;
    const int64_t off = (int64_t(q0 + q) * splits + split) * k + j;
    part_s[off] = s_ls[i];
    part_r[off] = s_lr[i];
  }
}

// p: power of two >= splits * k (the wrapper keeps it <= 4096).
__global__ void scan_topk_merge(const int* __restrict__ part_s, const int* __restrict__ part_r,
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
    out_s[o] = key ? static_cast<float>(key_score(key)) : NEG;
    out_r[o] = key ? key_row(key) : -1;
  }
}

}  // namespace

extern "C" int rr_int8_scan_topk(const void* codes, const void* qi, const void* mask,
                                 int64_t n, int d, int b, int k, int splits,
                                 int64_t rows_per_split, int merge_p, void* part_s,
                                 void* part_r, void* out_s, void* out_r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem_bytes(d, k);
  cudaError_t err = cudaFuncSetAttribute(
      scan_topk_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((b + QB - 1) / QB, splits);
  scan_topk_partial<<<grid, THREADS, smem, st>>>(
      static_cast<const int8_t*>(codes), static_cast<const int8_t*>(qi),
      static_cast<const uint8_t*>(mask), n, d, b, k, rows_per_split,
      static_cast<int*>(part_s), static_cast<int*>(part_r));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t msmem = size_t(merge_p) * sizeof(unsigned long long);
  err = cudaFuncSetAttribute(scan_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(msmem));
  if (err != cudaSuccess) return err;
  scan_topk_merge<<<b, 256, msmem, st>>>(
      static_cast<const int*>(part_s), static_cast<const int*>(part_r), splits, k, merge_p,
      static_cast<float*>(out_s), static_cast<int*>(out_r));
  return cudaGetLastError();
}
