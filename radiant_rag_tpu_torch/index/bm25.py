"""BM25 sparse index: host CSR postings (native bulk build) + device tables.

Counterpart of the `BM25Index` core in `radiant_rag_tpu/index/bm25.py`: the
same tokenizer (lowercase alnum runs, length > 1), BM25 variant (k1 = 1.5,
b = 0.75), incremental adds with a delta log merged at finalize, the native
single-pass bulk build, the HBM plan, the signed impact sketch, the
doc-major rescore tables, the batch router and the page table. The device
arrays are torch tensors on the index's `device`; the host build is numpy
and runs the same code as the JAX package, so both build identical tables
from the same texts.

Also here: the standalone `search_rows(_batch)` (auto-routed sketch or
pages), the v3 `to_dict`/`from_dict` and `PersistentBM25Index`, which keeps
the index in the JAX package's gzip-JSON file (keyed by doc id, so either
package loads the other's file) and builds it from a vector store.
"""

from __future__ import annotations

import array
import gzip
import json
import logging
import math
import os
import re
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radiant_rag_tpu_torch import resolve_device
from radiant_rag_tpu_torch.ops.bm25 import (
    PAGE_SIZE, bm25_pages_score_topk, bm25_sketch_rescore_topk,
)
from radiant_rag_tpu_torch.utils.hashing import stable_hash32

logger = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> List[str]:
    """Lowercase, alnum runs only, length > 1."""
    return [t for t in _TOKEN_RE.findall(text.lower()) if len(t) > 1]


def _round_up(n: int, quantum: int) -> int:
    """Smallest multiple of `quantum` >= n (postings padding)."""
    return -(-n // quantum) * quantum


def _next_pow2(n: int, floor: int = 64) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class _DeltaLog:
    """Flat append-only (tid, row, tf) posting log for incremental adds,
    merged into the CSR in one vectorized pass at finalize. A document update
    records a position watermark; that row's earlier entries are dropped at
    the merge."""

    __slots__ = ("tids", "rows", "tfs", "dead_before")

    def __init__(self) -> None:
        self.tids = array.array("i")
        self.rows = array.array("i")
        self.tfs = array.array("f")
        self.dead_before: Dict[int, int] = {}  # row -> log watermark

    def append_doc(self, row: int, tid_tf_pairs: Sequence[Tuple[int, int]]) -> None:
        self.tids.extend(tid for tid, _ in tid_tf_pairs)
        self.rows.extend(row for _ in tid_tf_pairs)
        self.tfs.extend(float(tf) for _, tf in tid_tf_pairs)

    def purge_row(self, row: int) -> None:
        self.dead_before[row] = len(self.tids)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.frombuffer(self.tids, np.int32),
                np.frombuffer(self.rows, np.int32),
                np.frombuffer(self.tfs, np.float32))

    def live_mask(self, removed: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """Bool mask over log entries that survive removals and updates;
        None = all live."""
        if not self.dead_before and removed is None:
            return None
        rows = np.frombuffer(self.rows, np.int32)
        keep = np.ones(len(rows), bool)
        if removed is not None:
            keep &= ~np.isin(rows, removed)
        if self.dead_before:
            size = int(rows.max()) + 1 if len(rows) else 1
            wm = np.zeros(size, np.int64)
            for row, pos in self.dead_before.items():
                if row < size:
                    wm[row] = pos
            keep &= np.arange(len(rows)) >= wm[rows]
        return keep

    def __len__(self) -> int:
        return len(self.tids)


_EMPTY_I32 = np.zeros(0, np.int32)
_EMPTY_F32 = np.zeros(0, np.float32)


class BM25Index:
    """Inverted index over engine rows: CSR base + incremental delta."""

    def __init__(self, k1: float = 1.5, b: float = 0.75,
                 max_query_terms: int = 32, max_postings: int = 1 << 18,
                 sketch_dim: int = 1024, pages_route_threshold: int = 1 << 15,
                 sketch_hbm_budget_gb: float = 3.0,
                 disc_route_df_frac: float = 0.01,
                 pages_route_max_pages: int = 4096,
                 pages_route_max_cells: int = 1 << 30,
                 device=None) -> None:
        """Routing and budget parameters as in the JAX package: a batch goes
        to the exact pages path when every query is rare-term (posting
        volume <= pages_route_threshold) or holds a discriminative term
        (df <= disc_route_df_frac of the docs), within the pages cost gate
        (pages_route_max_pages, and B x N <= pages_route_max_cells for the
        (B, N) f32 scatter buffer). sketch_hbm_budget_gb caps the sketch +
        doc-major tables (plan_hbm)."""
        self.device = resolve_device(device)
        self.k1 = k1
        self.b = b
        self.max_query_terms = max_query_terms
        self.max_postings = max_postings
        self.sketch_dim = sketch_dim  # live value; plan_hbm may reduce it
        self._sketch_dim_cfg = sketch_dim
        self.sketch_hbm_budget_gb = float(sketch_hbm_budget_gb)
        self.doc_major_width = 128  # terms kept per doc for the exact rescore
        self.pages_route_threshold = pages_route_threshold
        self.disc_route_df_frac = float(disc_route_df_frac)
        self.pages_route_max_pages = int(pages_route_max_pages)
        self.pages_route_max_cells = int(pages_route_max_cells)
        self.terms: List[str] = []  # tid -> term
        self.vocab: Dict[str, int] = {}
        self.df: List[int] = []
        self._base_start: np.ndarray = np.zeros(1, np.int64)
        self._base_rows: np.ndarray = _EMPTY_I32
        self._base_tfs: np.ndarray = _EMPTY_F32
        self.delta = _DeltaLog()
        self.doc_terms: Dict[int, List[Tuple[int, int]]] = {}  # row -> [(tid, tf)]
        self.doc_lens: Dict[int, int] = {}
        self.total_len = 0
        self.removed: set = set()
        # rows re-added since the last finalize: their old base postings are
        # dropped at finalize (the new ones live in the delta)
        self._stale_base: set = set()
        # device tables
        self._dl_dev: Optional[torch.Tensor] = None
        self._dl_size = 0
        self._dl_dirty = True
        self._csr_dirty = True
        self._dev_post_rows: Optional[torch.Tensor] = None
        self._dev_post_tf: Optional[torch.Tensor] = None
        self._term_start: Optional[np.ndarray] = None  # finalized (T+1,)
        self._term_idf: Optional[np.ndarray] = None
        self._host_post_rows: Optional[np.ndarray] = None
        self._host_post_tf: Optional[np.ndarray] = None
        self._sketch: Optional[torch.Tensor] = None
        self._sketch_scale: Optional[torch.Tensor] = None
        self._sketch_rows = 0
        self._sketch_dirty = True
        self._term_bin: Dict[int, int] = {}
        self._bins_per_term: Optional[np.ndarray] = None  # tid -> bin (ensure_sketch)
        self._signs_per_term: Optional[np.ndarray] = None  # tid -> ±1
        self._dm_tids: Optional[torch.Tensor] = None
        self._dm_tfs: Optional[torch.Tensor] = None
        self._dm_rows = 0
        self._dm_width = 0
        self._dm_dirty = True
        self._dt_csr = None  # doc-term CSR of the last native bulk build
        self._qtok = None  # native query tokenizer (vocab snapshot)
        self._qtok_nterms = -1

    # -- build -------------------------------------------------------------
    @property
    def num_docs(self) -> int:
        return len(self.doc_lens)

    @property
    def avgdl(self) -> float:
        return self.total_len / self.num_docs if self.num_docs else 0.0

    def _mark_dirty(self) -> None:
        self._dl_dirty = True
        self._csr_dirty = True
        self._sketch_dirty = True
        self._dm_dirty = True
        self._dt_csr = None

    def _term_id(self, term: str) -> int:
        tid = self.vocab.get(term)
        if tid is None:
            tid = len(self.terms)
            self.vocab[term] = tid
            self.terms.append(term)
            self.df.append(0)
        return tid

    def add_document(self, row: int, text_or_tokens) -> None:
        tokens = text_or_tokens if isinstance(text_or_tokens, list) else tokenize(text_or_tokens)
        counts: Dict[str, int] = {}
        for t in tokens:
            counts[t] = counts.get(t, 0) + 1
        self.add_document_counts(row, list(counts.items()), len(tokens))

    def add_document_counts(self, row: int, term_counts: Sequence[Tuple[str, int]],
                            length: int) -> None:
        """Add from (term, tf) pairs + token count."""
        if row in self.doc_lens:  # document update
            self.delta.purge_row(row)
            self._stale_base.add(row)
            self.remove_document(row)
        pairs: List[Tuple[int, int]] = []
        for term, tf in term_counts:
            tid = self._term_id(term)
            self.df[tid] += 1
            pairs.append((tid, int(tf)))
        self.delta.append_doc(row, pairs)
        self.doc_terms[row] = pairs
        self.doc_lens[row] = int(length)
        self.total_len += int(length)
        if row in self.removed:  # row reuse: old base postings stay dead
            self._stale_base.add(row)
            self.removed.discard(row)
        self._mark_dirty()

    def bulk_build(self, rows: Sequence[int], texts: Sequence[str]) -> bool:
        """Bulk (re)index: native C++ single pass when available, python loop
        otherwise. Returns True when the native path ran."""
        from radiant_rag_tpu_torch.index.native import bulk_build as native_build

        self._reset()
        built = native_build(texts, list(rows))
        if built is None:
            for row, text in zip(rows, texts):
                self.add_document(row, text)
            return False
        self.terms = built.terms
        self.vocab = {t: i for i, t in enumerate(built.terms)}
        self.df = built.df.astype(np.int64).tolist()
        self._base_start = built.term_start
        self._base_rows = built.post_rows
        self._base_tfs = built.post_tfs
        self.doc_lens = {int(r): int(l) for r, l in zip(rows, built.doc_lens)}
        self.total_len = int(built.doc_lens.sum())
        dts = built.doc_term_start
        self.doc_terms = {
            int(r): list(zip(built.doc_term_ids[dts[i]: dts[i + 1]].tolist(),
                             built.doc_term_tfs[dts[i]: dts[i + 1]].tolist()))
            for i, r in enumerate(rows)
        }
        self._mark_dirty()
        # kept for ensure_doc_major's vectorized fill until the next mutation
        self._dt_csr = (np.asarray(list(rows), np.int64), dts,
                        built.doc_term_ids, built.doc_term_tfs)
        return True

    def _reset(self) -> None:
        self.terms = []
        self.vocab = {}
        self.df = []
        self._base_start = np.zeros(1, np.int64)
        self._base_rows = _EMPTY_I32
        self._base_tfs = _EMPTY_F32
        self.delta = _DeltaLog()
        self.doc_terms = {}
        self.doc_lens = {}
        self.total_len = 0
        self.removed = set()
        self._stale_base = set()
        # term ids are remapped by a rebuild: tid-keyed bin caches are wrong
        self._term_bin = {}
        self._bins_per_term = None
        self._signs_per_term = None
        self._mark_dirty()

    def remove_document(self, row: int) -> bool:
        """Lazy removal: postings are purged at the next finalize; compaction
        runs once more than 25% of the rows are dead."""
        if row not in self.doc_lens:
            return False
        self.total_len -= self.doc_lens.pop(row)
        for tid, _tf in self.doc_terms.pop(row, []):
            self.df[tid] = max(0, self.df[tid] - 1)
        self.removed.add(row)
        self._mark_dirty()
        if self.num_docs and len(self.removed) > 0.25 * (self.num_docs + len(self.removed)):
            self.rebuild()
        return True

    def rebuild(self) -> None:
        """Compact: drop dead postings and unused terms."""
        old_terms = self.terms
        docs = [(row, [(old_terms[tid], tf) for tid, tf in pairs], self.doc_lens[row])
                for row, pairs in self.doc_terms.items()]
        self._reset()
        for row, term_counts, length in docs:
            self.add_document_counts(row, term_counts, length)

    # -- stats -------------------------------------------------------------
    def _idf(self, tid: int) -> float:
        n = self.num_docs
        df = self.df[tid]
        return math.log((n - df + 0.5) / (df + 0.5) + 1.0)

    def _device_doc_lens(self, num_rows: int) -> torch.Tensor:
        """(max(num_rows, 256),) f32 doc lengths on the device; callers pass
        the engine capacity so the row spaces match exactly."""
        if self._dl_dirty or self._dl_size < num_rows:
            size = max(num_rows, 256)
            dl = np.zeros((size,), np.float32)
            for row, ln in self.doc_lens.items():
                if row < size:
                    dl[row] = ln
            self._dl_dev = torch.from_numpy(dl).to(self.device)
            self._dl_size = size
            self._dl_dirty = False
        return self._dl_dev

    def _finalize_csr(self) -> None:
        """Merge base + delta into a fresh CSR, drop removed rows, upload."""
        if not self._csr_dirty and self._dev_post_rows is not None:
            return
        t = len(self.terms)
        n_base_terms = len(self._base_start) - 1
        removed_arr = (np.fromiter(self.removed, np.int32, len(self.removed))
                       if self.removed else None)
        base_dead = self.removed | self._stale_base
        base_rows, base_tfs = self._base_rows, self._base_tfs
        base_tids = np.repeat(np.arange(n_base_terms, dtype=np.int32),
                              np.diff(self._base_start))
        if base_dead and len(base_rows):
            base_dead_arr = np.fromiter(base_dead, np.int32, len(base_dead))
            keep = ~np.isin(base_rows, base_dead_arr)
            base_tids, base_rows, base_tfs = base_tids[keep], base_rows[keep], base_tfs[keep]
        d_tids, d_rows, d_tfs = self.delta.arrays()
        d_keep = self.delta.live_mask(removed_arr)
        if d_keep is not None:
            d_tids, d_rows, d_tfs = d_tids[d_keep], d_rows[d_keep], d_tfs[d_keep]
        all_tids = np.concatenate([base_tids, d_tids])
        all_rows = np.concatenate([base_rows, d_rows])
        all_tfs = np.concatenate([base_tfs, d_tfs])
        # stable sort by tid: base entries first, then the delta's, in order
        order = np.argsort(all_tids, kind="stable")
        total = len(order)
        counts = np.bincount(all_tids, minlength=t) if total else np.zeros(t, np.int64)
        starts = np.zeros((t + 1,), np.int64)
        np.cumsum(counts, out=starts[1:])
        size = _round_up(max(total, 1), PAGE_SIZE)
        rows = np.zeros((size,), np.int32)
        tfs = np.zeros((size,), np.float32)
        rows[:total] = all_rows[order]
        tfs[:total] = all_tfs[order]
        self._base_start = starts.copy()
        self._base_rows = rows[:total].copy()
        self._base_tfs = tfs[:total].copy()
        self.delta = _DeltaLog()
        self._stale_base = set()
        self._term_start = starts
        if t:
            n = self.num_docs
            df_arr = np.asarray(self.df, np.float64)
            self._term_idf = np.log((n - df_arr + 0.5) / (df_arr + 0.5) + 1.0).astype(np.float32)
        else:
            self._term_idf = np.zeros(0, np.float32)
        self._host_post_rows = rows
        self._host_post_tf = tfs
        self._dev_post_rows = torch.from_numpy(rows).to(self.device)
        self._dev_post_tf = torch.from_numpy(tfs).to(self.device)
        self._csr_dirty = False

    # -- impact sketch -----------------------------------------------------
    def _bin_of(self, tid: int) -> int:
        b = self._term_bin.get(tid)
        if b is None:
            b = stable_hash32(self.terms[tid]) % self.sketch_dim
            self._term_bin[tid] = b
        return b

    def _sign_of(self, tid: int) -> int:
        """±1 hashing sign of a term, from a salted second hash so it stays
        independent of the bin at every sketch width: colliding terms'
        impacts cancel in expectation."""
        return 1 if stable_hash32("s!" + self.terms[tid]) & 1 else -1

    def _free_sketch_arrays(self) -> None:
        self._sketch = None
        self._sketch_rows = 0
        self._sketch_dirty = True
        self._dm_tids = self._dm_tfs = None
        self._dm_dirty = True

    def plan_hbm(self, num_docs: int) -> None:
        """Fit the sketch path's per-doc tables (the (N, S) int8 sketch and
        the (N, L) doc-major tables, 8 bytes per term) to
        sketch_hbm_budget_gb. Degrade order: L 128 -> 64, S halves down to
        128, then L = 32, then no sketch tier (pages only). Recomputed from
        the configured ceiling on every call."""
        if self._sketch_dim_cfg <= 0:
            self.sketch_dim = 0
            return
        budget = int(self.sketch_hbm_budget_gb * (1 << 30))
        cands = [(self._sketch_dim_cfg, 128), (self._sketch_dim_cfg, 64)]
        s = self._sketch_dim_cfg // 2
        while s >= 128:
            cands.append((s, 64))
            s //= 2
        cands.append((min(128, self._sketch_dim_cfg), 32))
        plan = next(((ps, pl) for ps, pl in cands
                     if num_docs * (ps + pl * 8) <= budget), None)
        if plan is None:
            if self.sketch_dim != 0:
                logger.warning("bm25 plan: %d docs cannot fit the sketch tier in "
                               "%.1f GB; serving pages only", num_docs,
                               self.sketch_hbm_budget_gb)
            self.sketch_dim = 0
            self._free_sketch_arrays()
            return
        ps, pl = plan
        if ps != self.sketch_dim:
            if self.sketch_dim and ps < self.sketch_dim:
                logger.warning("bm25 plan: %d docs reduce sketch S %d -> %d",
                               num_docs, self.sketch_dim, ps)
            self.sketch_dim = ps
            self._term_bin.clear()  # bins depend on S
            self._bins_per_term = None
            self._sketch_dirty = True
            self._sketch = None
        if pl != self.doc_major_width:
            self.doc_major_width = pl
            self._dm_dirty = True
            self._dm_tids = self._dm_tfs = None

    def device_bytes_projected(self, num_docs: int) -> int:
        """Projected device bytes of this index at num_docs rows under the
        current plan (call plan_hbm first)."""
        if self._dev_post_rows is not None:
            post = int(self._dev_post_rows.numel()) * 8
        elif self._term_start is not None:
            post = _round_up(max(int(self._term_start[-1]), 1), PAGE_SIZE) * 8
        else:
            post = 0
        b = post + num_docs * 4  # doc_lens
        if self.sketch_dim > 0:
            b += num_docs * (self.sketch_dim + self.doc_major_width * 8)
        return b

    def ensure_sketch(self, num_docs: int) -> None:
        """Build the (num_docs, S) int8 signed impact sketch on the device.
        Each posting's exact BM25 contribution, times its term's sign, is
        summed per (doc, bin) on the host in the sparse domain and quantized
        with one global scale."""
        self.plan_hbm(num_docs)
        if self.sketch_dim <= 0:
            return
        if not self._sketch_dirty and self._sketch_rows >= num_docs:
            return
        self._finalize_csr()
        avgdl = max(self.avgdl, 1e-6)
        dl_arr = np.zeros((num_docs,), np.float32)
        for row, ln in self.doc_lens.items():
            if row < num_docs:
                dl_arr[row] = ln
        total = int(self._term_start[-1])
        rows = self._host_post_rows[:total]
        tfs = self._host_post_tf[:total]
        t = len(self.terms)
        lengths = np.diff(self._term_start)
        idf_per_post = np.repeat(self._term_idf, lengths)
        bins_per_term = np.asarray([self._bin_of(tid) for tid in range(t)], np.int32)
        self._bins_per_term = bins_per_term
        signs_per_term = np.asarray([self._sign_of(tid) for tid in range(t)], np.int8)
        self._signs_per_term = signs_per_term
        bin_per_post = np.repeat(bins_per_term, lengths)
        dl = dl_arr[np.minimum(rows, num_docs - 1)]
        denom = tfs + self.k1 * (1.0 - self.b + self.b * dl / avgdl)
        w = (idf_per_post * tfs * (self.k1 + 1.0) / np.maximum(denom, 1e-6)
             ) * np.repeat(signs_per_term, lengths)
        flat = rows.astype(np.int64) * self.sketch_dim + bin_per_post
        sketch_host = np.zeros(num_docs * self.sketch_dim, np.int8)
        if flat.size:
            occupied, inv = np.unique(flat, return_inverse=True)
            sums = np.bincount(inv, weights=w.astype(np.float64), minlength=len(occupied))
            scale = max(float(np.abs(sums).max()) / 127.0, 1e-6)
            sketch_host[occupied] = np.clip(np.round(sums / scale), -127, 127).astype(np.int8)
        else:
            scale = 1e-6
        self._sketch = torch.from_numpy(sketch_host.reshape(num_docs, self.sketch_dim)
                                        ).to(self.device)
        self._sketch_scale = torch.tensor(scale, dtype=torch.float32, device=self.device)
        self._sketch_rows = num_docs
        self._sketch_dirty = False

    # -- doc-major table (exact candidate rescore) --------------------------
    def ensure_doc_major(self, num_docs: int, max_terms: int = 0) -> None:
        """Build the (num_docs, L) device term-id / tf tables for the exact
        rescore after the sketch scan. Docs with more than L unique terms
        keep their L highest-tf terms."""
        max_terms = max_terms or self.doc_major_width
        if (not self._dm_dirty and self._dm_rows >= num_docs
                and self._dm_width == max_terms):
            return
        tids = np.full((num_docs, max_terms), -1, np.int32)
        tfs = np.zeros((num_docs, max_terms), np.int32)
        if self._dt_csr is not None:
            rows_arr, starts, ids_arr, tfs_arr = self._dt_csr
            lens = np.diff(starts)
            in_range = rows_arr < num_docs
            short = in_range & (lens <= max_terms)
            ent_keep = np.repeat(short, lens)
            ent_rows = np.repeat(rows_arr, lens)[ent_keep]
            ent_pos = (np.arange(ids_arr.size, dtype=np.int64)
                       - np.repeat(starts[:-1], lens))[ent_keep]
            tids[ent_rows, ent_pos] = ids_arr[ent_keep]
            tfs[ent_rows, ent_pos] = tfs_arr[ent_keep]
            overflow = [(int(r), self.doc_terms[int(r)])
                        for r in rows_arr[in_range & (lens > max_terms)]]
        else:
            overflow = [(row, pairs) for row, pairs in self.doc_terms.items()
                        if row < num_docs]
        for row, pairs in overflow:
            if len(pairs) > max_terms:
                pairs = sorted(pairs, key=lambda p: -p[1])[:max_terms]
            n = len(pairs)
            if n:
                tids[row, :n] = [t for t, _ in pairs]
                tfs[row, :n] = [tf for _, tf in pairs]
        self._dm_tids = torch.from_numpy(tids).to(self.device)
        self._dm_tfs = torch.from_numpy(tfs).to(self.device)
        self._dm_rows = num_docs
        self._dm_width = max_terms
        self._dm_dirty = False

    # -- queries -----------------------------------------------------------
    def query_tids(self, queries: Sequence[str]) -> np.ndarray:
        """(B, max_query_terms) int32 unique in-vocab term ids per query,
        -1 padded: tokenized once per batch, natively when possible."""
        t = self.max_query_terms
        qtok = self._query_tokenizer()
        if qtok is not None:
            return qtok.tids_batch(queries, t, t)
        vocab_get = self.vocab.get
        out = np.full((len(queries), t), -1, np.int32)
        for qi, q in enumerate(queries):
            n = 0
            seen = set()
            for w in tokenize(q)[:t]:
                tid = vocab_get(w)
                if tid is not None and tid not in seen:
                    seen.add(tid)
                    out[qi, n] = tid
                    n += 1
        return out

    def _query_tokenizer(self):
        """Native vocab-snapshot tokenizer, rebuilt when the vocab grows."""
        if self._qtok_nterms != len(self.terms):
            from radiant_rag_tpu_torch.index.native import make_query_tokenizer

            self._qtok = make_query_tokenizer(self.terms)
            self._qtok_nterms = len(self.terms)
        return self._qtok

    def make_query_terms(self, queries: Sequence[str], max_terms: Optional[int] = None,
                         tids: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(B, T) query term ids (-1 pad) + their idfs for the exact rescore."""
        t = max_terms or self.max_query_terms
        if tids is None:
            tids = self.query_tids(queries)
        self._finalize_csr()
        q_tids = np.full((tids.shape[0], t), -1, np.int32)
        width = min(t, tids.shape[1])
        q_tids[:, :width] = tids[:, :width]
        valid = q_tids >= 0
        q_idfs = np.where(valid, self._term_idf[np.maximum(q_tids, 0)], 0.0).astype(np.float32)
        return q_tids, q_idfs

    def routes_pages(self, queries: Sequence[str], tids: Optional[np.ndarray] = None,
                     num_docs: int = 0) -> bool:
        """The auto router: True sends the batch to the exact pages path.
        Every query must be rare-term or hold a discriminative term, and the
        batch must pass the cost gate (page count, B x N score cells)."""
        self._finalize_csr()
        if tids is None:
            tids = self.query_tids(queries)
        if tids.size == 0:
            return True
        lengths = np.diff(self._term_start)
        per_tid = np.where(tids >= 0, lengths[np.maximum(tids, 0)], 0)
        small = per_tid.sum(axis=1) <= self.pages_route_threshold
        df_cap = max(1.0, self.disc_route_df_frac * max(len(self.doc_lens), 1))
        has_disc = ((per_tid > 0) & (per_tid <= df_cap)).any(axis=1)
        if not bool(np.all(small | has_disc)):
            return False
        n_pages = int(np.ceil(per_tid / PAGE_SIZE).sum())
        if n_pages > self.pages_route_max_pages:
            return False
        n = int(num_docs) or len(self.doc_lens)
        return tids.shape[0] * n <= self.pages_route_max_cells

    def make_query_indicator(self, queries: Sequence[str],
                             tids: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, S) int8 signed indicator: each query term adds its hashing
        sign at its bin, so colliding terms add (the JAX package's device
        scatter-add of the signed bin codes gives the same array)."""
        if tids is None:
            tids = self.query_tids(queries)
        out = np.zeros((tids.shape[0], self.sketch_dim), np.int8)
        bins, signs = self._bins_per_term, self._signs_per_term
        qidx, pos = np.nonzero(tids >= 0)
        if len(qidx) == 0:
            return out
        flat_tids = tids[qidx, pos]
        if (bins is not None and signs is not None
                and len(bins) > int(flat_tids.max(initial=-1))):
            np.add.at(out, (qidx, bins[flat_tids]), signs[flat_tids])
        else:  # vocab grew since the sketch build
            for q, tid in zip(qidx, flat_tids):
                out[q, self._bin_of(int(tid))] += self._sign_of(int(tid))
        return out

    def make_pages(self, queries: Sequence[str],
                   tids_per_q: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Per-batch page table (host, KBs): each page covers PAGE_SIZE
        consecutive postings of one (query, term); the per-query posting
        budget goes to rare (high-idf) terms first."""
        if tids_per_q is None:
            tids_per_q = self.query_tids(queries)
        starts_l: List[int] = []
        lens_l: List[int] = []
        qidx_l: List[int] = []
        idf_l: List[float] = []
        for qi, uniq in enumerate(tids_per_q):
            tids = [int(t) for t in uniq if t >= 0]
            tids.sort(key=lambda tid: self._term_start[tid + 1] - self._term_start[tid])
            budget = self.max_postings
            for tid in tids:
                if budget <= 0:
                    break
                s = int(self._term_start[tid])
                ln = min(int(self._term_start[tid + 1]) - s, budget)
                budget -= ln
                idf = float(self._term_idf[tid])
                for off in range(0, ln, PAGE_SIZE):
                    starts_l.append(s + off)
                    lens_l.append(min(PAGE_SIZE, ln - off))
                    qidx_l.append(qi)
                    idf_l.append(idf)
        bucket = _next_pow2(max(len(starts_l), 1), floor=16)
        start = np.zeros((bucket,), np.int32)
        plen = np.zeros((bucket,), np.int32)  # zero-length pages are inert
        qidx = np.zeros((bucket,), np.int32)
        idf = np.zeros((bucket,), np.float32)
        if starts_l:
            start[: len(starts_l)] = starts_l
            plen[: len(lens_l)] = lens_l
            qidx[: len(qidx_l)] = qidx_l
            idf[: len(idf_l)] = idf_l
        return {"start": start, "len": plen, "qidx": qidx, "idf": idf}

    # -- search ------------------------------------------------------------
    def search_rows(self, query: str, top_k: int = 10,
                    valid_mask: Optional[torch.Tensor] = None,
                    num_rows: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores (k,), rows (k,) int64; -1 padding)."""
        s, r = self.search_rows_batch([query], top_k, valid_mask, num_rows)
        return s[0], r[0]

    def search_rows_batch(self, queries: Sequence[str], top_k: int = 10,
                          valid_mask: Optional[torch.Tensor] = None,
                          num_rows: Optional[int] = None, method: str = "auto",
                          rescore_multiplier: float = 4.0) -> Tuple[np.ndarray, np.ndarray]:
        """Batched BM25: method "pages" is exact within the per-query posting
        budget; "sketch" scans the signed impact sketch and rescores the
        top-(k x rescore_multiplier) candidates exactly; "auto" routes like
        `routes_pages`. Returns (scores (B, k), rows (B, k) int64, -1 pad)."""
        from radiant_rag_tpu_torch.index.engine import _round_capacity

        bq = len(queries)
        if self.num_docs == 0:
            return (np.full((bq, top_k), -1e30, np.float32),
                    np.full((bq, top_k), -1, np.int64))
        # standalone default: round like the engine rounds its capacity, so
        # the doc-length table never outgrows a hybrid searcher's row space
        n_rows = num_rows or _round_capacity(max(max(self.doc_lens) + 1, 1))
        if valid_mask is not None:
            n_rows = max(n_rows, int(valid_mask.shape[0]))
        self._device_doc_lens(n_rows)
        n_rows = self._dl_size
        dl = self._dl_dev
        self._finalize_csr()
        self.plan_hbm(n_rows)  # may disable the sketch tier at scale
        tids_list = self.query_tids(queries)
        mask = valid_mask
        if mask is not None and int(mask.shape[0]) < n_rows:
            mask = torch.cat([mask, mask.new_zeros((n_rows - int(mask.shape[0]),))])
        if method == "auto":
            method = ("pages" if self.sketch_dim <= 0
                      or self.routes_pages(queries, tids_list, num_docs=n_rows) else "sketch")
        if method == "sketch" and self.sketch_dim <= 0:
            method = "pages"  # the HBM plan serves pages only at this size
        dev = self.device
        avgdl = torch.tensor(self.avgdl, dtype=torch.float32, device=dev)
        k_eff = min(top_k, n_rows)
        if method == "sketch":
            self.ensure_sketch(n_rows)
            self.ensure_doc_major(n_rows)
            qind = self.make_query_indicator(queries, tids_list)
            q_tids, q_idfs = self.make_query_terms(queries, tids=tids_list)
            kc = min(max(k_eff, int(round(k_eff * rescore_multiplier))), n_rows)
            top_s, top_i = bm25_sketch_rescore_topk(
                self._sketch, self._sketch_scale, torch.from_numpy(qind).to(dev),
                self._dm_tids, self._dm_tfs, dl, avgdl, torch.from_numpy(q_tids).to(dev),
                torch.from_numpy(q_idfs).to(dev), mask, k_eff, kc, self.k1, self.b)
        else:
            pages = {key: torch.from_numpy(v).to(dev)
                     for key, v in self.make_pages(queries, tids_list).items()}
            top_s, top_i = bm25_pages_score_topk(
                self._dev_post_rows, self._dev_post_tf, pages["start"], pages["len"],
                pages["qidx"], pages["idf"], dl, avgdl, mask, bq, n_rows, k_eff,
                self.k1, self.b)
        scores = top_s.cpu().numpy()
        rows_out = top_i.cpu().numpy().astype(np.int64)
        if scores.shape[1] < top_k:
            pad = top_k - scores.shape[1]
            scores = np.pad(scores, ((0, 0), (0, pad)), constant_values=-1e30)
            rows_out = np.pad(rows_out, ((0, 0), (0, pad)), constant_values=-1)
        return scores, rows_out

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict:
        """v3 format: per-row (term, tf) pairs + length; stats rebuilt on load."""
        return {"version": 3, "k1": self.k1, "b": self.b,
                "docs": {str(row): self.doc_payload(row) for row in self.doc_terms}}

    @classmethod
    def from_dict(cls, data: Dict, **kwargs) -> "BM25Index":
        idx = cls(k1=float(data.get("k1", 1.5)), b=float(data.get("b", 0.75)), **kwargs)
        for row, payload in data.get("docs", {}).items():
            idx._add_payload(int(row), payload)
        return idx

    def _add_payload(self, row: int, payload) -> None:
        if isinstance(payload, dict):  # v3
            self.add_document_counts(row, [(t, int(tf)) for t, tf in payload["t"]],
                                     int(payload["l"]))
        else:  # v2 token lists
            self.add_document(row, list(payload))

    def doc_payload(self, row: int) -> Optional[Dict]:
        """Persistence payload of one row."""
        pairs = self.doc_terms.get(row)
        if pairs is None:
            return None
        return {"l": self.doc_lens[row], "t": [[self.terms[tid], tf] for tid, tf in pairs]}

    def settings(self) -> Dict:
        """Constructor arguments that carry over to a rebuilt index."""
        return {"max_query_terms": self.max_query_terms, "max_postings": self.max_postings,
                "sketch_dim": self._sketch_dim_cfg,
                "pages_route_threshold": self.pages_route_threshold,
                "sketch_hbm_budget_gb": self.sketch_hbm_budget_gb,
                "disc_route_df_frac": self.disc_route_df_frac,
                "pages_route_max_pages": self.pages_route_max_pages,
                "pages_route_max_cells": self.pages_route_max_cells, "device": self.device}

    def get_stats(self) -> Dict:
        return {"num_docs": self.num_docs, "num_terms": len(self.terms),
                "total_postings": int(self._base_start[-1]) + len(self.delta),
                "avgdl": self.avgdl, "removed_pending": len(self.removed)}


class PersistentBM25Index:
    """Thread-safe persistent wrapper: lazy load, atomic gzip-JSON save,
    auto-save threshold, store sync. The file is keyed by doc_id (rows are
    resolved through the store at load time), in the JAX package's v3
    format. Unlike the JAX package, a file that fails to load raises instead
    of leaving an empty index in its place."""

    def __init__(self, store, path: str = "./data/bm25_index.json.gz",
                 k1: float = 1.5, b: float = 0.75, auto_save_threshold: int = 100,
                 persist_max_docs: int = 200000, auto_build: bool = True, **kwargs) -> None:
        self.store = store
        self.path = path
        self.auto_save_threshold = auto_save_threshold
        self.persist_max_docs = persist_max_docs
        self.auto_build = auto_build
        self._lock = threading.RLock()
        self._index = BM25Index(k1=k1, b=b, **kwargs)
        self._loaded = False
        self._dirty_adds = 0

    @classmethod
    def from_config(cls, store, bm25_cfg, device=None, path: Optional[str] = None
                    ) -> "PersistentBM25Index":
        """The BM25 leg as the JAX package's app builds it from its `bm25`
        config section (path defaults to bm25_cfg.index_path)."""
        c = bm25_cfg
        return cls(store, path=path or c.index_path, k1=c.k1, b=c.b,
                   auto_save_threshold=c.auto_save_threshold,
                   max_query_terms=c.max_query_terms, max_postings=c.max_postings_per_query,
                   persist_max_docs=c.persist_max_docs, auto_build=c.auto_build,
                   sketch_dim=c.sketch_dim, sketch_hbm_budget_gb=c.sketch_hbm_budget_gb,
                   disc_route_df_frac=c.disc_route_df_frac,
                   pages_route_max_pages=c.pages_route_max_pages,
                   pages_route_max_cells=c.pages_route_max_cells, device=device)

    @property
    def index(self) -> BM25Index:
        """The live inner index (loads or builds on first access). Load and
        build replace the inner object: resolve through this property."""
        with self._lock:
            self._ensure_loaded()
            return self._index

    def _fresh(self, k1: float, b: float) -> BM25Index:
        return BM25Index(k1=k1, b=b, **self._index.settings())

    def _store_has_docs(self) -> bool:
        return bool(self.store.list_doc_ids_with_embeddings())

    # -- lifecycle ---------------------------------------------------------
    def _ensure_loaded(self, auto_build: bool = True) -> None:
        if self._loaded:
            return
        self._loaded = True
        p = Path(self.path)
        build = auto_build and self.auto_build
        if not p.is_file():
            # no file: the statistics derive from the store (also the load
            # path above persist_max_docs, whose file is never written)
            if build and self._store_has_docs():
                self._build_from_store_locked()
            return
        with gzip.open(p, "rt", encoding="utf-8") as fh:
            data = json.load(fh)
        docs = data.get("docs", {})
        if not docs and "doc_ids" in data:  # v1/v2: parallel id / token lists
            docs = dict(zip(data.get("doc_ids", []), data.get("doc_tokens", [])))
        idx = self._fresh(float(data.get("k1", self._index.k1)),
                          float(data.get("b", self._index.b)))
        resolved = 0
        for key, payload in docs.items():
            row = self.store.row_of(key) if hasattr(self.store, "row_of") else None
            if row is not None:
                idx._add_payload(row, payload)
                resolved += 1
        self._index = idx
        logger.info("loaded BM25 index from %s (%d/%d docs resolved)", p, resolved, len(docs))
        if resolved == 0 and build and self._store_has_docs():
            logger.info("BM25 file resolved 0 docs against a non-empty store; rebuilding")
            self._build_from_store_locked()

    def save(self) -> None:
        with self._lock:
            self._ensure_loaded()
            if self._index.num_docs > self.persist_max_docs:
                logger.info("BM25 persistence skipped (%d docs > persist_max_docs=%d); the "
                            "index rebuilds from the store on load", self._index.num_docs,
                            self.persist_max_docs)
                self._dirty_adds = 0
                return
            p = Path(self.path)
            p.parent.mkdir(parents=True, exist_ok=True)
            row_to_id = getattr(self.store, "id_for_row", None)
            docs = {}
            for row in self._index.doc_terms:
                key = row_to_id(row) if row_to_id else str(row)
                if key is not None:
                    docs[key] = self._index.doc_payload(row)
            payload = {"version": 3, "k1": self._index.k1, "b": self._index.b, "docs": docs}
            tmp = str(p) + ".tmp"
            with gzip.open(tmp, "wt", encoding="utf-8") as fh:
                json.dump(payload, fh)
            os.replace(tmp, str(p))
            self._dirty_adds = 0

    # -- mutation ----------------------------------------------------------
    def add_document(self, doc_id: str, text: str) -> bool:
        with self._lock:
            self._ensure_loaded()
            row = self.store.row_of(doc_id)
            if row is None:
                return False
            self._index.add_document(row, text)
            self._dirty_adds += 1
            if self._dirty_adds >= self.auto_save_threshold:
                self.save()
            return True

    def remove_document(self, doc_id: str) -> bool:
        with self._lock:
            self._ensure_loaded()
            row = self.store.row_of(doc_id)
            if row is None:
                return False
            return self._index.remove_document(row)

    def build_from_store(self) -> int:
        """Full rebuild from the vector store in one native bulk pass."""
        with self._lock:
            self._loaded = True  # building is the load
            return self._build_from_store_locked()

    def _build_from_store_locked(self) -> int:
        rows: List[int] = []
        texts: List[str] = []
        for doc_id in self.store.list_doc_ids_with_embeddings():
            doc = self.store.get_doc(doc_id)
            row = self.store.row_of(doc_id)
            if doc is not None and row is not None:
                rows.append(row)
                texts.append(doc.content)
        self._index = self._fresh(self._index.k1, self._index.b)
        self._index.bulk_build(rows, texts)
        self.save()
        return len(rows)

    def sync_with_store(self) -> Tuple[int, int]:
        """Diff against the store's ids: add new rows, remove stale ones.
        Returns (added, removed)."""
        with self._lock:
            self._ensure_loaded(auto_build=False)  # sync adds; a build would not count
            store_rows = {}
            for doc_id in self.store.list_doc_ids_with_embeddings():
                row = self.store.row_of(doc_id)
                if row is not None:
                    store_rows[row] = doc_id
            indexed = set(self._index.doc_lens.keys())
            removed = 0
            for row in indexed - set(store_rows):
                self._index.remove_document(row)
                removed += 1
            new_rows: List[int] = []
            new_texts: List[str] = []
            for row, doc_id in store_rows.items():
                if row not in indexed:
                    doc = self.store.get_doc(doc_id)
                    if doc is not None:
                        new_rows.append(row)
                        new_texts.append(doc.content)
            if new_rows:
                if not indexed and not removed:
                    self._index.bulk_build(new_rows, new_texts)  # fresh: native path
                else:
                    for row, text in zip(new_rows, new_texts):
                        self._index.add_document(row, text)
            added = len(new_rows)
            if added or removed:
                self.save()
            return added, removed

    # -- search ------------------------------------------------------------
    def search(self, query: str, top_k: int = 10):
        return self.search_batch([query], top_k)[0]

    def search_batch(self, queries: Sequence[str], top_k: int = 10):
        """[(StoredDoc, score)] per query, over the store's live rows."""
        with self._lock:
            self._ensure_loaded()
            valid = getattr(self.store, "valid_mask", None)
            num_rows = getattr(self.store, "row_capacity", None)
            scores, rows = self._index.search_rows_batch(
                queries, top_k, valid_mask=valid() if callable(valid) else valid,
                num_rows=num_rows() if callable(num_rows) else num_rows)
        out = []
        for qi in range(len(queries)):
            hits = []
            for s, r in zip(scores[qi], rows[qi]):
                if r < 0 or s <= 0:
                    continue
                doc_id = self.store.id_for_row(int(r))
                doc = None if doc_id is None else self.store.get_doc(doc_id)
                if doc is not None:
                    hits.append((doc, float(s)))
            out.append(hits)
        return out

    def get_stats(self) -> Dict:
        with self._lock:
            self._ensure_loaded()
            return self._index.get_stats()
