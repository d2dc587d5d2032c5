"""BM25 sparse index: host CSR postings (native bulk build) + device tables.

Counterpart of the `BM25Index` core in `radiant_rag_tpu/index/bm25.py`: the
same tokenizer (lowercase alnum runs, length > 1), BM25 variant (k1 = 1.5,
b = 0.75), incremental adds with a delta log merged at finalize, the native
single-pass bulk build, the HBM plan, the signed impact sketch, the
doc-major rescore tables, the batch router and the page table. The device
arrays are torch tensors on the index's `device`; the host build is numpy
and runs the same code as the JAX package, so both build identical tables
from the same texts.

Not here yet (ROADMAP): `PersistentBM25Index`, `to_dict`/`from_dict` and
the standalone `search_rows(_batch)`; the hybrid searcher is this slice's
query path.
"""

from __future__ import annotations

import array
import logging
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radiant_rag_tpu_torch import resolve_device
from radiant_rag_tpu_torch.ops.bm25 import PAGE_SIZE
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
