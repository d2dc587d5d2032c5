"""ShardedVectorStore: the corpus-sharded serving store with steady ingest.

The port's counterpart of `radiant_rag_tpu/parallel/sharded_store.py`. A
`TpuVectorStore` (the durable source of truth) is frozen into a sharded
base (`ShardedHybridIndex`, or `ShardedFlatIndex` without a BM25 index):
vectors, sign codes, the BM25 sketch and doc-major tables split by row over
the mesh's shards; queries are copied to every shard; per-shard top-k
merge on the mesh's first device.

Steady ingest uses a base + delta design instead of re-sharding per write:
the base keeps serving while appends land in a small delta segment on the
mesh's first device (a `DeviceVectorIndex` + `BM25Index` pair); a query
runs both and merges each leg on the host (k is small). Deletes tombstone
base rows. When the delta or the tombstones pass `delta_rebase_fraction`
of the base, `refresh()` folds everything into a new base (the old one
serves until the new one is built). The delta scores BM25 with its own
(df, avgdl) until the rebase, as in the JAX package.

Two departures from the JAX package: `_merge_leg` orders by score with a
stable sort (ties keep base before delta, then rank order; numpy's default
argsort is not stable), and the delta's dense leg normalizes its queries
as the base does. A tombstoned base row keeps its slot in a merged leg
(its score -inf, its row -1) when the delta is empty, as there.

Implements the `BaseVectorStore` read / write surface, so the retrieval
agents and the orchestrator run on it unchanged.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radiant_rag_tpu_torch.index.base import BaseVectorStore
from radiant_rag_tpu_torch.index.doc import StoredDoc
from radiant_rag_tpu_torch.index.store import LEVEL_CODES, _normalize
from radiant_rag_tpu_torch.parallel.mesh import Mesh, mesh_info
from radiant_rag_tpu_torch.parallel.sharded_index import (
    Legs, ShardedFlatIndex, ShardedHybridIndex,
)

logger = logging.getLogger(__name__)

Run = Tuple[np.ndarray, np.ndarray]


def _host_fuse(d_leg: Run, b_leg: Run, fused_k: int, rrf_k: int, fusion: str = "equal",
               leg_w: Optional[np.ndarray] = None) -> Run:
    """Host fusion of two merged (scores, rows) runs, the base + delta path.
    As on the device: "equal" / "confidence" are (weighted) RRF with ranks
    from 1; "score" is the per-query z-normalized interpolation with the
    retrieved-floor shift (`ops/fusion.score_fuse`)."""
    (d_scores, d_rows), (b_scores, b_rows) = d_leg, b_leg
    w = np.asarray([1.0, 1.0] if (leg_w is None or fusion == "equal") else leg_w, np.float32)
    bq = d_rows.shape[0]
    out_s = np.full((bq, fused_k), -np.inf, np.float32)
    out_i = np.full((bq, fused_k), -1, np.int64)

    def z_shift(scores, rows):
        live = rows >= 0
        if not live.any():
            return np.zeros_like(scores)
        s = scores[live]
        z = (s - s.mean()) / np.sqrt(s.var() + 1e-12)
        out = np.zeros_like(scores)
        out[live] = z - z.min() + 0.05
        return out

    for qi in range(bq):
        agg: Dict[int, float] = {}
        if fusion == "score":
            for wi, (scores, rows) in enumerate(((d_scores, d_rows), (b_scores, b_rows))):
                contrib = z_shift(np.asarray(scores[qi], np.float64), rows[qi])
                for r, c in zip(rows[qi], contrib):
                    if r >= 0:
                        agg[int(r)] = agg.get(int(r), 0.0) + float(w[wi]) * c
        else:
            for wi, run in enumerate((d_rows[qi], b_rows[qi])):
                for rank, r in enumerate(run, start=1):
                    if r >= 0:
                        agg[int(r)] = agg.get(int(r), 0.0) + float(w[wi]) / (rrf_k + rank)
        for j, (r, s) in enumerate(sorted(agg.items(), key=lambda kv: -kv[1])[:fused_k]):
            out_s[qi, j] = s
            out_i[qi, j] = r
    return out_s, out_i


class ShardedVectorStore(BaseVectorStore):
    def __init__(self, mesh: Mesh, source_store, bm25_index=None,
                 delta_rebase_fraction: float = 0.05) -> None:
        """source_store: a TpuVectorStore; bm25_index: its BM25Index (the
        inner index) for hybrid serving (dense only without it)."""
        self.mesh = mesh
        self.source = source_store
        self._bm25 = bm25_index
        self._flat: Optional[ShardedFlatIndex] = None
        self._hybrid: Optional[ShardedHybridIndex] = None
        self.delta_rebase_fraction = delta_rebase_fraction
        self._delta_lock = threading.RLock()
        self._base_rows = 0
        self._delta_engine = None
        self._delta_bm25 = None
        self._delta_rows: List[int] = []  # delta local row -> source global row
        self._global_to_delta: Dict[int, int] = {}
        self._tombstones: set = set()
        # the calibrated fusion (survives refresh; see set_fusion)
        self._fusion_mode = "equal"
        self._fusion_weights = np.asarray([0.5, 0.5], np.float32)
        self.refresh()

    def attach_bm25(self, bm25_index) -> None:
        """Install (or resolve again after a reload) the source BM25Index
        and rebuild the base, so hybrid serving is live. The app calls this
        at start-up: the factory builds the store before the BM25 index."""
        self._bm25 = bm25_index
        self.refresh()

    @property
    def can_hybrid(self) -> bool:
        return self._bm25 is not None

    def save(self, directory: str) -> None:
        """Durability is the source store's (writes go through to it)."""
        self.source.save(directory)

    def reserve(self, additional_docs: int) -> None:
        self.source.reserve(additional_docs)

    def _default_mode(self) -> str:
        return self.source._default_mode()

    def set_fusion(self, mode: str, weights) -> None:
        """Install a calibrated fusion (mode + per-leg weights): the carrier
        of `HybridSearcher.calibrate_fusion`'s result to the pod, so a leg
        measured unreliable on the source corpus is demoted here too."""
        self._fusion_mode = mode
        self._fusion_weights = np.asarray(weights, np.float32)
        if self._hybrid is not None:
            self._hybrid.set_fusion(mode, self._fusion_weights)

    # -- build / refresh -----------------------------------------------------
    def refresh(self) -> None:
        """Rebuild the sharded base from the source store's current state."""
        state = self.source.engine.to_host()
        vecs = state["vecs"]
        flat, hybrid = None, None
        if vecs.shape[0] > 0:
            kw = dict(valid=state["valid"], level=state["level"], lang=state["lang"])
            if self._bm25 is not None:
                hybrid = flat = ShardedHybridIndex(self.mesh, vecs, self._bm25,
                                                   table_rows=self.source.engine.capacity, **kw)
                hybrid.set_fusion(self._fusion_mode, self._fusion_weights)
            else:
                flat = ShardedFlatIndex(self.mesh, vecs, **kw)
        self._flat, self._hybrid = flat, hybrid
        with self._delta_lock:
            # everything in the source is now in the base
            self._base_rows = vecs.shape[0]
            self._delta_engine = None
            self._delta_bm25 = None
            self._delta_rows = []
            self._global_to_delta = {}
            self._tombstones = set()
        logger.info("sharded store refreshed: %d rows over %s", vecs.shape[0],
                    mesh_info(self.mesh))

    # -- reads ---------------------------------------------------------------
    def ping(self) -> bool:
        return True

    def get_doc(self, doc_id: str) -> Optional[StoredDoc]:
        return self.source.get_doc(doc_id)

    def has_embedding(self, doc_id: str) -> bool:
        return self.source.has_embedding(doc_id)

    def row_of(self, doc_id: str) -> Optional[int]:
        return self.source.row_of(doc_id)

    def id_for_row(self, row: int) -> Optional[str]:
        return self.source.id_for_row(row)

    def _hydrate(self, scores: np.ndarray, rows: np.ndarray, min_similarity: float = -np.inf
                 ) -> List[List[Tuple[StoredDoc, float]]]:
        out = []
        for qi in range(rows.shape[0]):
            hits = []
            for s, r in zip(scores[qi], rows[qi]):
                if r < 0 or s < min_similarity:
                    continue
                doc_id = self.source.id_for_row(int(r))
                doc = self.source.get_doc(doc_id) if doc_id else None
                if doc is not None:
                    hits.append((doc, float(s)))
            out.append(hits)
        return out

    def retrieve_by_embedding_batch(
        self,
        embeddings: np.ndarray,
        top_k: int = 10,
        min_similarity: float = 0.0,
        ef_runtime: Optional[int] = None,
        language_filter: Optional[str] = None,
        doc_level_filter: Optional[str] = None,
        quantized: Optional[bool] = None,
    ) -> List[List[Tuple[StoredDoc, float]]]:
        embeddings = np.atleast_2d(np.asarray(embeddings, np.float32))
        b = embeddings.shape[0]
        if self._flat is None and self.delta_size == 0:
            return [[] for _ in range(b)]
        level_code = -1 if not doc_level_filter else LEVEL_CODES.get(
            doc_level_filter, LEVEL_CODES["other"])
        lang_code = -1
        if language_filter:
            lang_code = self.source.lang_codes.get(language_filter, -2)
            if lang_code == -2:
                return [[] for _ in range(b)]
        mode = "exact" if quantized is False else "binary"
        if self._flat is not None:
            base = self._flat.search(embeddings, top_k, mode=mode, level_code=level_code,
                                     lang_code=lang_code)
        else:
            base = (np.full((b, top_k), -np.inf, np.float32), np.full((b, top_k), -1, np.int64))
        delta = self._delta_dense(embeddings, top_k, level_code=level_code, lang_code=lang_code)
        return self._hydrate(*self._merge_leg(base, delta, top_k), min_similarity)

    def search_hybrid_rows(self, embeddings: np.ndarray, queries_text: Sequence[str],
                           top_k: int = 10, fused_k: int = 15, rrf_k: int = 60,
                           fused_depth: int = 0) -> Legs:
        """The pod's hybrid retrieval in row space: {'dense'|'bm25'|'fused':
        (scores, global rows)}, each leg the base merged with the delta at
        max(top_k, fused_depth), then fused (on the device for a pure base,
        else `_host_fuse`). search_hybrid hydrates it."""
        if self._hybrid is None and self._bm25 is None:
            raise RuntimeError("hybrid serving requires a BM25 index at build")
        embeddings = np.atleast_2d(np.asarray(embeddings, np.float32))
        b = embeddings.shape[0]
        leg_k = max(top_k, int(fused_depth or 0))
        res = None
        if self._hybrid is not None:
            res = self._hybrid.hybrid_search(embeddings, list(queries_text), dense_k=leg_k,
                                             bm25_k=leg_k, fused_k=fused_k, rrf_k=rrf_k)
            base_dense, base_bm25 = res["dense"], res["bm25"]
        else:
            base_dense = base_bm25 = (np.full((b, leg_k), -np.inf, np.float32),
                                      np.full((b, leg_k), -1, np.int64))
        d_delta = self._delta_dense(embeddings, leg_k)
        s_delta = self._delta_sparse(queries_text, leg_k)
        d_leg = self._merge_leg(base_dense, d_delta, leg_k)
        b_leg = self._merge_leg(base_bm25, s_delta, leg_k)
        if d_delta is None and s_delta is None and not self._tombstones and res is not None:
            fused = res["fused"]  # pure base: the device fusion stands
        else:
            fused = _host_fuse(d_leg, b_leg, fused_k, rrf_k, self._fusion_mode,
                               self._fusion_weights)
        return {"dense": d_leg, "bm25": b_leg, "fused": fused}

    def search_hybrid(self, embeddings: np.ndarray, queries_text: Sequence[str],
                      top_k: int = 10, fused_k: int = 15, rrf_k: int = 60,
                      return_legs: bool = False, fused_depth: int = 0):
        """Pod hybrid retrieval, hydrated to documents. return_legs=True also
        hydrates the per-leg runs, cut back to top_k (the orchestrator's pod
        path fills ctx.dense_docs / bm25_docs from them): {"fused": [...],
        "dense": [...], "bm25": [...]}. fused_depth > top_k retrieves and
        fuses both legs at that depth (`HybridSearcher.search_rows`)."""
        res = self.search_hybrid_rows(embeddings, queries_text, top_k=top_k, fused_k=fused_k,
                                      rrf_k=rrf_k, fused_depth=fused_depth)
        fused = self._hydrate(*res["fused"])
        if not return_legs:
            return fused
        return {"fused": fused,
                "dense": self._hydrate(res["dense"][0][:, :top_k], res["dense"][1][:, :top_k]),
                "bm25": self._hydrate(res["bm25"][0][:, :top_k], res["bm25"][1][:, :top_k])}

    # -- admin / listing ------------------------------------------------------
    def list_doc_ids(self) -> List[str]:
        return self.source.list_doc_ids()

    def list_doc_ids_with_embeddings(self) -> List[str]:
        return self.source.list_doc_ids_with_embeddings()

    def get_index_info(self) -> Dict[str, Any]:
        info = dict(self.source.get_index_info())
        info["backend"] = "tpu-sharded"
        info["mesh"] = mesh_info(self.mesh)
        if self._flat is not None:
            info["rows_per_shard"] = self._flat.rows_per_shard
        return info

    def count_documents(self) -> int:
        return self.source.count_documents()

    # -- writes: the delta segment ---------------------------------------------
    @property
    def delta_size(self) -> int:
        return len(self._delta_rows)

    def _ensure_delta(self) -> None:
        if self._delta_engine is None:
            from radiant_rag_tpu_torch.index.bm25 import BM25Index
            from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex

            self._delta_engine = DeviceVectorIndex(self.source.engine.dim,
                                                   initial_capacity=1024,
                                                   device=self.mesh.first)
            self._delta_bm25 = BM25Index(device=self.mesh.first)

    def upsert(self, content, meta=None, embedding=None) -> str:
        return self.upsert_batch([(content, meta, embedding)])[0]

    def upsert_batch(self, docs) -> List[str]:
        """Write through to the source store, then stage the NEW rows in the
        delta segment, so they are served at once without a re-shard."""
        from radiant_rag_tpu_torch.index.bm25 import tokenize

        ids = self.source.upsert_batch(docs)
        with self._delta_lock:
            stage: List[Tuple[int, str, np.ndarray]] = []
            for doc_id, (content, _meta, emb) in zip(ids, docs):
                row = self.source.row_of(doc_id)
                if row is None or emb is None:
                    continue  # a doc-only upsert has no row to serve
                if row < self._base_rows or row in self._global_to_delta:
                    continue  # served already (content-hash ids: same id, same content)
                stage.append((row, content, np.asarray(emb, np.float32)))
            if stage:
                self._ensure_delta()
                vecs = _normalize(np.stack([v for _, _, v in stage]))
                # the level / language codes the source assigned at its upsert
                src = self.source.engine
                rows_t = torch.as_tensor([r for r, _, _ in stage], device=src.device)
                levels = src.level[rows_t].cpu().numpy()
                langs = src.lang[rows_t].cpu().numpy()
                doc_lens = np.asarray([max(1, len(tokenize(c))) for _, c, _ in stage],
                                      np.float32)
                local = self._delta_engine.append(vecs, levels, langs, doc_lens)
                for (row, content, _v), lrow in zip(stage, local):
                    self._delta_rows.append(row)
                    self._global_to_delta[row] = int(lrow)
                    self._delta_bm25.add_document(int(lrow), content)
        self._maybe_rebase()
        return ids

    def delete_doc(self, doc_id: str) -> bool:
        with self._delta_lock:
            row = self.source.row_of(doc_id)
            ok = self.source.delete_doc(doc_id)
            if ok and row is not None:
                local = self._global_to_delta.pop(row, None)
                if local is not None:
                    self._delta_engine.invalidate(np.asarray([local]))
                    self._delta_bm25.remove_document(local)
                elif row < self._base_rows:
                    self._tombstones.add(int(row))
        self._maybe_rebase()
        return ok

    def _maybe_rebase(self) -> None:
        base = max(self._base_rows, 1)
        if (len(self._delta_rows) > self.delta_rebase_fraction * base
                or len(self._tombstones) > self.delta_rebase_fraction * base):
            logger.info("sharded store rebase: delta=%d tombstones=%d base=%d",
                        len(self._delta_rows), len(self._tombstones), base)
            self.refresh()

    def drop_index(self) -> None:
        self.source.drop_index()
        self.refresh()

    # -- base + delta merge ----------------------------------------------------
    def _delta_dense(self, embeddings: np.ndarray, k: int, level_code: int = -1,
                     lang_code: int = -1) -> Optional[Run]:
        """Exact scan of the delta segment (small by construction); (scores,
        global rows), or None when the delta is empty."""
        with self._delta_lock:
            eng = self._delta_engine
            if eng is None or eng.count == 0:
                return None
            s, local = eng.search(_normalize(embeddings), min(k, eng.count), mode="exact",
                                  level_code=level_code, lang_code=lang_code)
            mapping = np.asarray(self._delta_rows + [0], np.int64)
            rows = np.where(local >= 0, mapping[np.clip(local, 0, None)], -1)
        return s, rows

    def _delta_sparse(self, queries_text, k: int) -> Optional[Run]:
        with self._delta_lock:
            bm = self._delta_bm25
            eng = self._delta_engine
            if bm is None or bm.num_docs == 0:
                return None
            s, local = bm.search_rows_batch(list(queries_text),
                                            top_k=min(k, max(bm.num_docs, 1)),
                                            valid_mask=eng.valid, num_rows=eng.capacity)
            mapping = np.asarray(self._delta_rows + [0], np.int64)
            rows = np.where(local >= 0, mapping[np.clip(local, 0, None)], -1)
        return s, rows

    def _merge_leg(self, base: Run, delta: Optional[Run], k: int) -> Run:
        """Merge base and delta (scores, rows) per query by score (a stable
        order: module doc), dropping tombstoned base rows."""
        bs, bi = base
        if self._tombstones:
            tomb = np.isin(bi, np.fromiter(self._tombstones, np.int64, len(self._tombstones)))
            bs = np.where(tomb, -np.inf, bs)
            bi = np.where(tomb, -1, bi)
        if delta is None:
            return bs[:, :k], bi[:, :k]
        ds, di = delta
        s = np.concatenate([bs, ds], axis=1)
        i = np.concatenate([bi, di], axis=1)
        s = np.where(i >= 0, s, -np.inf)
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(s, order, axis=1), np.take_along_axis(i, order, axis=1)
