"""Corpus-sharded retrieval: a scan on each shard, then a top-k merge.

The port's counterpart of `radiant_rag_tpu/parallel/sharded_index.py`.
Corpus rows are split over the mesh's shards (each holds `rows_per_shard`
rows of vectors, packed sign codes and masks, and for hybrid serving the
BM25 impact sketch and doc-major tables, on its device); a query batch is
copied to every shard; each shard searches its block with the same
kernels as the single-device engine (the Hamming scan -> top-k for the
dense leg's stage 1, the int8 scan -> top-k for the BM25 sketch select),
and the per-shard (B, k) scores and global rows are gathered onto the
mesh's first device in shard order and merged by `topk_first`. That is the
JAX package's `lax.all_gather(tiled)` + `lax.top_k`: ties go to the lower
shard, which holds the lower rows.

Queries are padded to the engine's query buckets
(`DeviceVectorIndex.QUERY_BUCKETS`), so the kernels see the same fixed set
of batch shapes as on the single-device path; the padded rows are dropped.

The shard body's BM25 leg keeps the sketch candidates in the scan's order
(score descending, then row ascending), as the JAX shard body does with
`full_topk`, and does not row-sort them as the single-device
`bm25_sketch_rescore_topk` does: an exact-BM25 tie in the rescore goes to
the candidate the sketch ranked higher (`cuda_kernels.bm25_rescore_topk`
with `row_ties=False`). Its exact rescore takes the BM25 index's k1 and b
(the JAX body takes the defaults 1.5 / 0.75: equal under the default
config).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex, row_mask
from radiant_rag_tpu_torch.index.store import _normalize
from radiant_rag_tpu_torch.index.hybrid import _fuse_stage
from radiant_rag_tpu_torch.ops import cuda_kernels as ck
from radiant_rag_tpu_torch.ops import quantize as qz
from radiant_rag_tpu_torch.ops import similarity as sim
from radiant_rag_tpu_torch.ops.bm25 import bm25_sketch_select
from radiant_rag_tpu_torch.parallel.mesh import Mesh

QUERY_BUCKETS = DeviceVectorIndex.QUERY_BUCKETS
_PACK_ROWS = 1 << 17  # rows per sign-packing step (its int64 transient)

Legs = Dict[str, Tuple[np.ndarray, np.ndarray]]


def merge_topk(scores: Sequence[torch.Tensor], rows: Sequence[torch.Tensor], k: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard (B, k_s) scores and global rows into the top-k: the
    runs concatenated on `device` in shard order, then `topk_first` (ties
    to the earlier shard)."""
    all_s = torch.cat([s.to(device) for s in scores], dim=1)
    all_i = torch.cat([r.to(device) for r in rows], dim=1)
    top_s, sel = sim.topk_first(all_s, k)
    return top_s, all_i.gather(1, sel)


def _bucket(b: int) -> int:
    return next(c for c in QUERY_BUCKETS if b <= c)


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    return np.pad(a, ((0, rows - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))


class ShardedFlatIndex:
    """Static sharded dense index built from host arrays (the bulk / load
    path). Incremental writes go to the single-device delta segment of
    `ShardedVectorStore`, whose `refresh` rebuilds this index."""

    def __init__(self, mesh: Mesh, vecs: np.ndarray, valid: Optional[np.ndarray] = None,
                 level: Optional[np.ndarray] = None, lang: Optional[np.ndarray] = None) -> None:
        self.mesh = mesh
        self.shards = mesh.shards
        self._n_shards = len(self.shards)
        n, d = vecs.shape
        self.dim = d
        self.n_docs = n
        per = -(-n // self._n_shards)
        self.rows_per_shard = ((per + 127) // 128) * 128  # 128-row aligned blocks
        vmask = np.ones((n,), bool) if valid is None else np.asarray(valid, bool)
        lvl = np.zeros((n,), np.int8) if level is None else np.asarray(level, np.int8)
        lng = np.zeros((n,), np.int32) if lang is None else np.asarray(lang, np.int32)
        self.vecs, self.codes, self.valid, self.level, self.lang = [], [], [], [], []
        for s, dev in enumerate(self.shards):
            sl = slice(s * self.rows_per_shard, min(n, (s + 1) * self.rows_per_shard))
            block = torch.from_numpy(
                _pad_rows(np.asarray(vecs[sl], np.float32), self.rows_per_shard)).to(dev)
            self.vecs.append(block)
            self.codes.append(torch.cat([qz.pack_binary(block[r:r + _PACK_ROWS])
                                         for r in range(0, self.rows_per_shard, _PACK_ROWS)]))
            for out, arr in ((self.valid, vmask), (self.level, lvl), (self.lang, lng)):
                out.append(torch.from_numpy(_pad_rows(arr[sl], self.rows_per_shard)).to(dev))

    def _buckets(self, b: int):
        """(start, stop, bucket) chunks of a b-query batch (one empty chunk
        for b = 0, so every leg keeps its (0, k) shape)."""
        top = QUERY_BUCKETS[-1]
        return [(s, min(b, s + top), _bucket(max(1, min(b, s + top) - s)))
                for s in range(0, max(b, 1), top)]

    def _queries(self, q: np.ndarray, bucket: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The padded queries and their sign words on the first device."""
        qdev = torch.from_numpy(_pad_rows(q, bucket)).to(self.mesh.first)
        return qdev, qz.pack_binary(qdev)

    def _dense_shard(self, s: int, q: torch.Tensor, qcodes: torch.Tensor,
                     mask: torch.Tensor, k: int, kc: int, mode: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One shard's top-k: (scores, global rows; -1 below NEG_INF / 2)."""
        if mode == "exact":
            ds, di = sim.exact_topk(self.vecs[s], q, mask, k)
        else:
            ds, di = sim.two_stage_topk(self.vecs[s], q, mask, k, kc, "hamming",
                                        binary_codes=self.codes[s], qbinary=qcodes)
        gi = di + s * self.rows_per_shard
        return ds, torch.where(ds > sim.NEG_INF / 2, gi, -1)

    def search(self, queries: np.ndarray, k: int, mode: str = "binary",
               rescore_multiplier: float = 4.0, level_code: int = -1, lang_code: int = -1
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (B, k) f32, global rows (B, k) int64)."""
        queries = _normalize(queries)
        k_eff = min(k, self.rows_per_shard)
        kc = min(max(k_eff, int(round(k_eff * rescore_multiplier))), self.rows_per_shard)
        outs_s, outs_i = [], []
        for start, stop, bucket in self._buckets(queries.shape[0]):
            q0, qc0 = self._queries(queries[start:stop], bucket)
            parts = []
            for s, dev in enumerate(self.shards):
                mask = row_mask(self.valid[s], self.level[s], self.lang[s], level_code,
                                lang_code)
                parts.append(self._dense_shard(s, q0.to(dev), qc0.to(dev), mask, k_eff, kc,
                                               mode))
            top_s, top_i = merge_topk([p[0] for p in parts], [p[1] for p in parts], k_eff,
                                      self.mesh.first)
            outs_s.append(top_s[:stop - start].cpu().numpy())
            outs_i.append(top_i[:stop - start].cpu().numpy().astype(np.int64))
        return np.concatenate(outs_s), np.concatenate(outs_i)


class ShardedHybridIndex(ShardedFlatIndex):
    """Corpus-sharded hybrid retrieval: the dense leg, the BM25 sketch leg
    with its exact rescore, each merged across shards, then the fusion on
    the first device (the multi-device form of `index/hybrid.py`)."""

    def __init__(self, mesh: Mesh, vecs: np.ndarray, bm25,
                 valid: Optional[np.ndarray] = None, level: Optional[np.ndarray] = None,
                 lang: Optional[np.ndarray] = None, table_rows: int = 0) -> None:
        """bm25: a BM25Index whose rows align with `vecs` rows. Its device
        tables are built for max(rows, table_rows) rows: `ShardedVectorStore`
        passes its source engine's capacity, the row space the source's
        calibration searcher builds them for, so the two share one build
        (rows past the corpus hold no doc: the shards' blocks are the same)."""
        super().__init__(mesh, vecs, valid, level, lang)
        n = vecs.shape[0]
        rows = max(n, table_rows)
        bm25.ensure_sketch(rows)
        bm25.ensure_doc_major(rows)
        doc_lens = bm25._device_doc_lens(rows)
        if bm25.sketch_dim <= 0:
            raise ValueError(f"the pod's BM25 leg needs the sketch tier; {n} docs leave none "
                             f"within bm25.sketch_hbm_budget_gb={bm25.sketch_hbm_budget_gb}")
        self.bm25 = bm25
        self.sketch_dim = bm25.sketch_dim
        per = self.rows_per_shard

        def block(t: torch.Tensor, s: int, dev: torch.device) -> torch.Tensor:
            part = t[s * per:min(t.shape[0], n, (s + 1) * per)]
            pad = (0, 0) * (t.dim() - 1) + (0, per - part.shape[0])
            return torch.nn.functional.pad(part, pad).to(dev)

        self.sketch, self.dm_tids, self.dm_tfs, self.doc_lens = [], [], [], []
        for s, dev in enumerate(self.shards):
            self.sketch.append(block(bm25._sketch, s, dev))
            self.dm_tids.append(block(bm25._dm_tids, s, dev))
            self.dm_tfs.append(block(bm25._dm_tfs, s, dev))
            self.doc_lens.append(block(doc_lens, s, dev))
        self.sketch_scale = float(bm25._sketch_scale)
        self.avgdl = float(bm25.avgdl)
        self.k1, self.b = bm25.k1, bm25.b
        # calibration carried from the single-device searcher by set_fusion
        # (ShardedVectorStore installs it again on refresh)
        self.fusion_mode = "equal"
        self.leg_weights = np.asarray([0.5, 0.5], np.float32)

    def set_fusion(self, mode: str, weights) -> None:
        """Install the calibrated fusion (mode + per-leg weights) for the
        following hybrid_search calls."""
        self.fusion_mode = mode
        self.leg_weights = np.asarray(weights, np.float32)

    def _sparse_shard(self, s: int, qind: torch.Tensor, q_tids: torch.Tensor,
                      q_idfs: torch.Tensor, bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One shard's BM25 leg: sketch select of bm_kc candidates (raw > 0),
        in the scan's order (module doc), exact rescore, first-index top-k."""
        dev = self.shards[s]
        bm_kc = min(max(bk * 4, bk), self.rows_per_shard)
        scale = torch.tensor(self.sketch_scale, dtype=torch.float32, device=dev)
        _s1, cand = bm25_sketch_select(self.sketch[s], scale, qind, self.valid[s], bm_kc)
        avgdl = torch.tensor(self.avgdl, dtype=torch.float32, device=dev)
        bs, bi = ck.bm25_rescore_topk(self.dm_tids[s], self.dm_tfs[s], self.doc_lens[s], avgdl,
                                      cand, q_tids, q_idfs, bk, self.k1, self.b, row_ties=False)
        return bs, torch.where(bi >= 0, bi + s * self.rows_per_shard, -1)

    def hybrid_search(self, queries_dense: np.ndarray, queries_text: Sequence[str],
                      dense_k: int = 10, bm25_k: int = 10, fused_k: int = 15, rrf_k: int = 60,
                      mode: str = "binary", rescore_multiplier: float = 4.0,
                      fusion: str = "") -> Legs:
        """{'dense'|'bm25'|'fused': (scores (B, k), global rows (B, k) i64)};
        fusion "" = the set_fusion-installed config."""
        if self.bm25.sketch_dim != self.sketch_dim:
            raise RuntimeError(f"the BM25 sketch width changed ({self.sketch_dim} -> "
                               f"{self.bm25.sketch_dim}) since this base was built; refresh it")
        q_all = _normalize(queries_dense)
        texts_all = list(queries_text)
        fusion = fusion or self.fusion_mode
        per = self.rows_per_shard
        dk, bk = min(dense_k, per), min(bm25_k, per)
        fk = min(fused_k, dk + bk)
        kc = min(max(dk, int(round(dk * rescore_multiplier))), per)
        first = self.mesh.first
        leg_w = torch.from_numpy(np.asarray(self.leg_weights, np.float32)).to(first)
        chunks: List[Legs] = []
        for start, stop, bucket in self._buckets(q_all.shape[0]):
            texts = texts_all[start:stop]
            q0, qc0 = self._queries(q_all[start:stop], bucket)
            tids = self.bm25.query_tids(texts)
            qind = _pad_rows(self.bm25.make_query_indicator(texts, tids), bucket)
            q_tids, q_idfs = self.bm25.make_query_terms(texts, tids=tids)
            q_tids = np.pad(q_tids, ((0, bucket - len(texts)), (0, 0)), constant_values=-1)
            q_idfs = _pad_rows(q_idfs, bucket)
            dense, sparse = [], []
            for s, dev in enumerate(self.shards):
                dense.append(self._dense_shard(s, q0.to(dev), qc0.to(dev), self.valid[s], dk,
                                               kc, mode))
                sparse.append(self._sparse_shard(
                    s, torch.from_numpy(qind).to(dev), torch.from_numpy(q_tids).to(dev),
                    torch.from_numpy(q_idfs).to(dev), bk))
            d_s, d_i = merge_topk([p[0] for p in dense], [p[1] for p in dense], dk, first)
            b_s, b_i = merge_topk([p[0] for p in sparse], [p[1] for p in sparse], bk, first)
            f_s, f_i = _fuse_stage(d_i.to(torch.int32), b_i.to(torch.int32), leg_w, fk, rrf_k,
                                   fusion, d_s, b_s)
            b = stop - start
            chunks.append({name: (sc[:b].cpu().numpy(), rows[:b].cpu().numpy().astype(np.int64))
                           for name, (sc, rows) in (("dense", (d_s, d_i)), ("bm25", (b_s, b_i)),
                                                    ("fused", (f_s, f_i)))})
        return {name: (np.concatenate([c[name][0] for c in chunks]),
                       np.concatenate([c[name][1] for c in chunks]))
                for name in ("dense", "bm25", "fused")}
