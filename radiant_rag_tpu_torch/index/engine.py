"""DeviceVectorIndex: the device-resident dense index engine.

Counterpart of `radiant_rag_tpu/index/engine.py`. The corpus lives on the
device as

  vecs    (cap, D)  f32   L2-normalized embeddings (rescore + exact path)
  codes   (cap, W)  i32   packed sign bits (binary Hamming stage 1), the JAX
                          package's uint32 words bit for bit
  i8      (cap, D)  int8  calibrated affine codes (int8 stage 1)
  valid   (cap,)    bool  live-row mask (deletes are a mask)
  level   (cap,)    int8  doc_level code
  lang    (cap,)    i32   language code
  doc_len (cap,)    f32   BM25 token counts (row space shared with BM25Index)

Rows are append-only with capacity growth. Where the JAX package wrote row
slabs with a donated `dynamic_update_slice`, the port writes the slab in
place into the preallocated tensors.

Modes: "exact" (fp32 scan), "binary" (two-stage, stage 1 in the fused
Hamming scan -> top-k kernel; the JAX package's default) and "int8"
(two-stage, stage 1 in the fused int8 scan -> top-k kernel). Both two-stage
modes rescore in fp32, or from dequantized int8 in fp32-free mode. "graph"
searches the KNN graph that `build_graph` built (`index/graph.py`), and
falls back to "int8" without fp32 vectors or before a build, as in the JAX
package.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from radiant_rag_tpu_torch import resolve_device, to_device
from radiant_rag_tpu_torch.ops import quantize as qz
from radiant_rag_tpu_torch.ops import similarity as sim

logger = logging.getLogger(__name__)

# Capacity rounding: pow2 while small, then multiples of this quantum (pow2
# all the way would pad a 10M-row reserve to 16.8M rows).
CAPACITY_QUANTUM = 1 << 16

# Device-memory gate. The JAX package sized these for a 16 GB v5e whose XLA
# programs materialized a (B, N) stage-1 score buffer per leg; it capped one
# such transient at 9 GiB (SCORE_BYTES_CAP) and auto-selected a bf16 or
# chunked selection as capacity grew. On the H100 (80 GB):
#  - the int8 stage 1 of both legs and the binary stage 1 are fused scan ->
#    top-k kernels, which hold no (B, N) buffer, so no select policy trades
#    memory for speed and the default policy is the fused kernel at every
#    capacity;
#  - the only (B, N) transients left are the exact path, the BM25 pages
#    route and a stage 1 deeper than the scan kernel's lists (the exact-
#    product route of `similarity.scan_select`): an f32 or int32 score
#    matrix, its masked copy and the int64 order keys of the top-k, 24
#    bytes per cell at the peak (`similarity.SCORE_BYTES_PER_CELL`);
#  - usable memory is the card's total (torch.cuda.mem_get_info) less 8 GiB
#    for the CUDA context, the allocator's slack and the outputs, and the
#    transient budget is what the resident corpus leaves of it. There is no
#    separate cap: eager PyTorch frees each transient as it goes.
# At 1M rows this admits a 2048-query bucket (2048 x 2^20 x 24 B = 51.5 GB).
# The exact-product route is not gated: it steps through the batch a block
# of queries at a time within the card's measured free memory
# (`similarity.route_budget`).
SCORE_BYTES_PER_CELL = sim.SCORE_BYTES_PER_CELL
HEADROOM_BYTES = 8 << 30
CPU_USABLE_BYTES = 16 << 30  # test-size runs on the CPU


def _next_pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _round_capacity(n: int) -> int:
    if n <= CAPACITY_QUANTUM:
        return _next_pow2(max(n, 256))
    return -(-n // CAPACITY_QUANTUM) * CAPACITY_QUANTUM


def row_mask(valid: torch.Tensor, level: torch.Tensor, lang: torch.Tensor,
             level_code: int, lang_code: int) -> torch.Tensor:
    """Live rows that pass the doc_level / language filters (-1 = none)."""
    mask = valid
    if level_code >= 0:
        mask = mask & (level.to(torch.int32) == level_code)
    if lang_code >= 0:
        mask = mask & (lang == lang_code)
    return mask


class DeviceVectorIndex:
    """Append-only device-resident dense index over one row space."""

    # Query-batch padding buckets: every batch runs at a fixed set of shapes.
    QUERY_BUCKETS = (1, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

    def __init__(self, dim: int, initial_capacity: int = 4096,
                 calibration_sample: int = 4096, device=None,
                 store_fp32: bool = True, vec_dtype: str = "float32",
                 stage1_select: str = "") -> None:
        """store_fp32=False keeps no fp32 vectors on the device: the rescore
        dequantizes int8 candidates, and calibration comes from the first
        >= 64-row append or set_int8_ranges. stage1_select "blockmax" picks
        the block-max candidate kernel; every other policy is the fused
        scan -> top-k kernel (see the memory-gate note above)."""
        self.device = resolve_device(device)
        self.dim = dim
        self.words = qz.packed_words(dim)
        self.count = 0
        self.capacity = _round_capacity(max(initial_capacity, 256))
        self.store_fp32 = store_fp32
        self.vec_dtype = torch.bfloat16 if vec_dtype == "bfloat16" else torch.float32
        self.stage1_select = stage1_select or "f32"
        self._calibrated = False
        self.calibration_sample = calibration_sample
        self.graph = None  # the KNN-graph engine, built on demand (build_graph)
        self._alloc(self.capacity)
        # identity dequant until calibration
        self.i8_lo = torch.full((dim,), -1.0, dtype=torch.float32, device=self.device)
        self.i8_hi = torch.full((dim,), 1.0, dtype=torch.float32, device=self.device)
        if self.device.type == "cuda":
            self.usable_bytes = torch.cuda.mem_get_info(self.device)[1] - HEADROOM_BYTES
        else:
            self.usable_bytes = CPU_USABLE_BYTES

    # -- allocation --------------------------------------------------------
    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _alloc(self, cap: int) -> None:
        self.vecs = self._zeros((cap if self.store_fp32 else 0, self.dim), self.vec_dtype)
        self.codes = self._zeros((cap, self.words), torch.int32)
        self.i8 = self._zeros((cap, self.dim), torch.int8)
        self.valid = self._zeros((cap,), torch.bool)
        self.level = self._zeros((cap,), torch.int8)
        self.lang = self._zeros((cap,), torch.int32)
        self.doc_len = self._zeros((cap,), torch.float32)

    def reserve(self, total_rows: int) -> None:
        """Grow capacity for `total_rows` rows in one step."""
        if total_rows > self.capacity:
            self._grow(total_rows, tight=True)

    def _grow(self, need: int, tight: bool = False) -> None:
        # tight (a known final size) is exact only when it at least doubles
        # capacity; otherwise growth is amortized: 2x while small, 1.25x
        # once capacity is memory-relevant
        if tight and need >= 2 * self.capacity:
            new_cap = _round_capacity(need)
        else:
            amort = (self.capacity * 2 if self.capacity < (1 << 21)
                     else self.capacity + self.capacity // 4)
            new_cap = _round_capacity(max(need, amort))
        logger.info("growing device index %d -> %d rows", self.capacity, new_cap)
        pad = new_cap - self.capacity

        def grow(arr: torch.Tensor) -> torch.Tensor:
            return torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])

        if self.store_fp32:
            self.vecs = grow(self.vecs)
        self.codes = grow(self.codes)
        self.i8 = grow(self.i8)
        self.valid = grow(self.valid)
        self.level = grow(self.level)
        self.lang = grow(self.lang)
        self.doc_len = grow(self.doc_len)
        self.capacity = new_cap

    # -- writes ------------------------------------------------------------
    def append(self, vecs: np.ndarray, levels: np.ndarray, langs: np.ndarray,
               doc_lens: np.ndarray) -> np.ndarray:
        """Append a batch (vectors should be L2-normalized); returns the
        assigned rows (host int64)."""
        p = int(vecs.shape[0])
        if p == 0:
            return np.zeros((0,), np.int64)
        pad_p = _next_pow2(p, floor=64)
        if self.count + pad_p > self.capacity:
            self._grow(self.count + pad_p)

        def padded(a: np.ndarray, dtype) -> torch.Tensor:
            out = np.zeros((pad_p,) + a.shape[1:], dtype)
            out[:p] = a
            return torch.from_numpy(out).to(self.device)

        vdev = padded(np.asarray(vecs, np.float32), np.float32)
        if not self._calibrated and not self.store_fp32 and p >= 64:
            # fp32-free mode calibrates from its first batch: nothing to
            # recalibrate from later
            self.i8_lo, self.i8_hi = qz.calibrate_int8_ranges(vdev[:p])
            self._calibrated = True
        sl = slice(self.count, self.count + pad_p)  # in-place slab writes
        if self.store_fp32:
            self.vecs[sl] = vdev.to(self.vec_dtype)
        self.codes[sl] = qz.pack_binary(vdev)
        self.i8[sl] = qz.quantize_int8(vdev, self.i8_lo, self.i8_hi)
        vmask = np.zeros((pad_p,), bool)
        vmask[:p] = True
        self.valid[sl] = torch.from_numpy(vmask).to(self.device)
        self.level[sl] = padded(levels, np.int8)
        self.lang[sl] = padded(langs, np.int32)
        self.doc_len[sl] = padded(doc_lens, np.float32)
        rows = np.arange(self.count, self.count + p, dtype=np.int64)
        self.count += p
        if not self._calibrated and self.store_fp32 and self.count >= 64:
            self.recalibrate()
        return rows

    def invalidate(self, rows: np.ndarray) -> None:
        if len(rows) == 0:
            return
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        self.valid[idx] = False

    def recalibrate(self) -> None:
        """int8 ranges from the first calibration_sample stored vectors; the
        whole table is requantized."""
        if self.count == 0 or not self.store_fp32:
            return
        n = min(self.count, self.calibration_sample)
        self.i8_lo, self.i8_hi = qz.calibrate_int8_ranges(self.vecs[:n].to(torch.float32))
        self.i8 = qz.quantize_int8(self.vecs.to(torch.float32), self.i8_lo, self.i8_hi)
        self._calibrated = True

    def set_int8_ranges(self, lo: np.ndarray, hi: np.ndarray) -> None:
        """Load an external calibration."""
        self.i8_lo = torch.as_tensor(np.asarray(lo, np.float32), device=self.device)
        self.i8_hi = torch.as_tensor(np.asarray(hi, np.float32), device=self.device)
        if self.store_fp32:
            self.i8 = qz.quantize_int8(self.vecs.to(torch.float32), self.i8_lo, self.i8_hi)
        self._calibrated = True

    # -- queries -----------------------------------------------------------
    def resident_bytes(self) -> int:
        """Device bytes held by the corpus arrays at current capacity."""
        aux = self.capacity * 10  # valid(1) + level(1) + lang(4) + doc_len(4)
        return sum(self.memory_bytes().values()) + aux

    def max_query_bucket(self, extra_resident: int = 0, score_gated: bool = False) -> int:
        """Largest usable query bucket. Only a path that builds a (B, N)
        score matrix (score_gated: the exact mode, the BM25 pages route) is
        gated, at SCORE_BYTES_PER_CELL per cell against what residency
        (plus the caller's extra_resident bytes) leaves free; the fused
        kernel paths hold no (B, N) buffer."""
        cap = self.QUERY_BUCKETS[-1]
        if not score_gated:
            return cap
        budget = max(0, self.usable_bytes - self.resident_bytes() - extra_resident)
        while cap > 1 and cap * self.capacity * SCORE_BYTES_PER_CELL > budget:
            cap //= 2
        return cap

    def _bucket_of(self, b: int, max_b: Optional[int] = None) -> int:
        """Smallest query-padding bucket holding b queries."""
        max_b = self.max_query_bucket() if max_b is None else max_b
        if b > max_b:
            raise ValueError(f"query batch {b} exceeds max bucket {max_b}; split the batch")
        return next(c for c in self.QUERY_BUCKETS if b <= c)

    def _bucket_queries(self, queries: np.ndarray, max_b: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        b = queries.shape[0]
        bucket = self._bucket_of(b, max_b)
        qpad = np.zeros((bucket, self.dim), np.float32)
        qpad[:b] = queries
        qvalid = np.zeros((bucket,), bool)
        qvalid[:b] = True
        return to_device(qpad, self.device), to_device(qvalid, self.device), b

    def search(self, queries: np.ndarray, k: int, mode: str = "binary",
               rescore_multiplier: float = 4.0, ef_runtime: Optional[int] = None,
               level_code: int = -1, lang_code: int = -1
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores (B, k) f32, rows (B, k) int64; -1 = no result)."""
        if self.count == 0:
            b = queries.shape[0]
            return np.full((b, k), -1e30, np.float32), np.full((b, k), -1, np.int64)
        if mode in ("graph", "exact") and not self.store_fp32:
            mode = "int8"  # fp32-free mode has no exact vectors
        if mode == "graph" and (self.graph is None or self.graph.built_rows == 0):
            mode = "int8"  # graph not built -> flat fallback
        # graph search holds no (B, N) buffer: its batch limit is the
        # largest bucket
        max_b = (self.QUERY_BUCKETS[-1] if mode == "graph"
                 else self.max_query_bucket(score_gated=mode == "exact"))
        if queries.shape[0] > max_b:  # chunk oversized batches
            parts = [self.search(queries[s:s + max_b], k, mode, rescore_multiplier,
                                 ef_runtime, level_code, lang_code)
                     for s in range(0, queries.shape[0], max_b)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        if mode == "graph":
            return self._graph_mode_search(np.asarray(queries, np.float32), k, ef_runtime,
                                           level_code, lang_code)
        k_eff = min(k, self.capacity)
        kc = int(max(k_eff, round(k_eff * rescore_multiplier)))
        if ef_runtime:
            kc = max(kc, int(ef_runtime))
        kc = min(max(kc, 1), self.capacity)
        qdev, qvalid, b = self._bucket_queries(np.asarray(queries, np.float32), max_b)
        mask = row_mask(self.valid, self.level, self.lang, level_code, lang_code)
        if mode == "exact":
            top_s, top_i = sim.exact_topk(self.vecs, qdev, mask, k_eff)
        elif mode in ("binary", "int8"):
            top_s, top_i = self.two_stage(qdev, mask, k_eff, kc, mode, self.stage1_select)
        else:
            raise ValueError(f"unknown search mode: {mode}")
        top_i = torch.where(top_s > sim.NEG_INF / 2, top_i, -1)
        top_i = torch.where(qvalid[:, None], top_i, -1)
        scores = top_s[:b].cpu().numpy()
        rows = top_i[:b].cpu().numpy().astype(np.int64)
        if k_eff < k:
            scores = np.pad(scores, ((0, 0), (0, k - k_eff)), constant_values=-1e30)
            rows = np.pad(rows, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return scores, rows

    # -- graph (HNSW-equivalent) -------------------------------------------
    def build_graph(self, degree: int = 16, n_long_edges: int = 4,
                    n_entry_points: int = 16, steps: int = 6) -> None:
        """Build the KNN-graph engine over the current rows (`index/graph.py`)
        from the resident vectors, without a host copy of the corpus. An
        offline step: rows appended later are inserted by extend_graph."""
        from radiant_rag_tpu_torch.index.graph import GraphIndex

        if self.count == 0:
            return
        self.graph = GraphIndex(degree=degree, n_long_edges=n_long_edges,
                                n_entry_points=n_entry_points, steps=steps,
                                device=self.device)
        self.graph.build(self.vecs[:self.count],
                         valid=self.valid[:self.count].cpu().numpy())

    def extend_graph(self, max_stale_fraction: float = 0.5,
                     allow_rebuild: bool = True) -> None:
        """Make rows appended since the last build visible to graph search.

        Incremental insert (`GraphIndex.add`: exact out-edges + weakest-edge
        back-edges). A full rebuild replaces it once incrementally inserted
        rows exceed `max_stale_fraction` of the graph (old nodes' edges are
        only patched, never re-derived); allow_rebuild=False skips that (the
        query path, which must never absorb an unbounded rebuild: the insert
        is O(new x N), a rebuild O(N x C x iters))."""
        if not self.store_fp32:
            return  # fp32-free mode has no vectors to build edges from
        if self.graph is None or self.graph.built_rows == 0:
            if allow_rebuild:
                self.build_graph()
            return
        built = self.graph.built_rows
        if built >= self.count:
            return
        projected = (self.count - self.graph._full_built_rows) / self.count
        if projected > max_stale_fraction:
            if not allow_rebuild:
                logger.warning(
                    "graph %.0f%% stale (> %.0f%%); serving the stale graph — "
                    "call build_graph()/extend_graph() to refresh",
                    projected * 100, max_stale_fraction * 100)
                return
            self.build_graph(degree=self.graph.degree,
                             n_long_edges=self.graph.n_long_edges,
                             n_entry_points=self.graph.n_entry_points,
                             steps=self.graph.steps)
            return
        self.graph.add(self.vecs, built, self.count - built,
                       valid=self.valid.cpu().numpy())

    def _graph_search(self, queries: np.ndarray, k: int, ef: int,
                      level_code: int, lang_code: int) -> Tuple[np.ndarray, np.ndarray]:
        mask = row_mask(self.valid, self.level, self.lang, level_code, lang_code)
        # the graph covers rows [0, built_rows); newer rows are masked out
        built = self.graph.built_rows
        return self.graph.search(self.vecs[:built], queries, k, ef=ef, mask=mask[:built])

    def _graph_mode_search(self, queries: np.ndarray, k: int, ef_runtime: Optional[int],
                           level_code: int, lang_code: int) -> Tuple[np.ndarray, np.ndarray]:
        """search(mode="graph") over a built graph, rows appended since the
        build inserted first when they are few."""
        delta = self.count - self.graph.built_rows
        if 0 < delta <= max(20_000, self.count // 10):
            # bounded: never a full rebuild in the query path, and only
            # modest growth (the insert is O(new x N))
            self.extend_graph(max_stale_fraction=1.0, allow_rebuild=False)
        elif delta > 0:
            logger.warning(
                "graph is %d rows behind the corpus — too many for query-path "
                "insertion; serving the stale graph (new rows need flat search "
                "or an explicit build_graph())", delta)
        kg = min(k, self.graph.built_rows)
        s, i = self._graph_search(queries, kg, ef=int(ef_runtime or max(64, 4 * k)),
                                  level_code=level_code, lang_code=lang_code)
        if kg < k:
            s = np.pad(s, ((0, 0), (0, k - kg)), constant_values=-1e30)
            i = np.pad(i, ((0, 0), (0, k - kg)), constant_values=-1)
        return s, i

    def two_stage(self, queries: torch.Tensor, mask: torch.Tensor, k: int, kc: int,
                  mode: str, select: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two-stage program over this corpus: stage 1 "binary" (the
        queries' sign words against the stored ones) or "int8"."""
        scale, offset = qz.int8_scale_offset(self.i8_lo, self.i8_hi)
        if mode == "binary":
            return sim.two_stage_topk(
                self.vecs, queries, mask, k, kc, "hamming", binary_codes=self.codes,
                qbinary=qz.pack_binary(queries), int8_codes=self.i8, int8_scale=scale,
                int8_offset=offset, select=select)
        return sim.two_stage_topk(
            self.vecs, queries, mask, k, kc, "int8", int8_codes=self.i8, int8_scale=scale,
            int8_offset=offset, select=select)

    # -- stats / persistence ----------------------------------------------
    def memory_bytes(self) -> Dict[str, int]:
        itemsize = 2 if self.vec_dtype == torch.bfloat16 else 4
        return {
            "fp32": (self.capacity * self.dim * itemsize) if self.store_fp32 else 0,
            "binary": self.capacity * self.words * 4,
            "int8": self.capacity * self.dim,
        }

    def to_host(self) -> Dict[str, np.ndarray]:
        """Host copy of the live rows. Vectors are materialized in 512k-row
        chunks, so the device never holds a full-corpus f32 transient
        (fp32-free mode reconstructs them from the int8 codes)."""
        n = self.count
        step = 1 << 19
        vecs_out = np.empty((n, self.dim), np.float32)
        for s in range(0, n, step):
            e = min(n, s + step)
            if self.store_fp32:
                chunk = self.vecs[s:e].to(torch.float32)
            else:
                chunk = qz.dequantize_int8(self.i8[s:e], self.i8_lo, self.i8_hi)
            vecs_out[s:e] = chunk.cpu().numpy()
        return {
            "vecs": vecs_out,
            "valid": self.valid[:n].cpu().numpy(),
            "level": self.level[:n].cpu().numpy(),
            "lang": self.lang[:n].cpu().numpy(),
            "doc_len": self.doc_len[:n].cpu().numpy(),
            "i8_lo": self.i8_lo.cpu().numpy(),
            "i8_hi": self.i8_hi.cpu().numpy(),
        }

    @classmethod
    def from_host(cls, state: Dict[str, np.ndarray], initial_capacity: int = 4096,
                  **engine_kwargs) -> "DeviceVectorIndex":
        vecs = state["vecs"]
        n, dim = vecs.shape
        idx = cls(dim, initial_capacity=max(initial_capacity, n), **engine_kwargs)
        if n:
            idx.append(vecs, state["level"].astype(np.int8), state["lang"].astype(np.int32),
                       state["doc_len"].astype(np.float32))
            if "i8_lo" in state:
                idx.set_int8_ranges(state["i8_lo"], state["i8_hi"])
            dead = np.nonzero(~state["valid"])[0]
            if len(dead):
                idx.invalidate(dead)
        return idx
