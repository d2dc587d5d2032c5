"""The system under test, built from a configuration the way the port's app
builds its serving path, without the document store the timed path never
reads:

  store engine   `DeviceVectorIndex` with the index section's settings,
                 rows appended in ingest batches of `ingest_batch`
  BM25           `BM25Index` with the bm25 section's settings, the native
                 bulk build over the corpus texts
  models         `LocalNLPModels` over an `Embedder` and a `CrossEncoder`
                 given the harness's weights
  searcher       `HybridSearcher(engine, bm25)` at the retrieval section's
                 fused depth, its fusion calibrated as the app calibrates it
                 before the first search (`calibrate_fusion` with the
                 section's probes, seeds and paraphrase share); the probes'
                 embeddings are kept (`probe_embeddings`, texts -> array)
  reranker       `DeviceReranker` over the cross-encoder with its token table
                 of the corpus texts (cells whose traffic reranks)

The corpus stays within reach of the driver and the stages: `texts` and
`words` are the corpus's own lists (no copy). A stage's `build` puts what
it builds in `stages[<stage>]`.

`search(texts, vectors, qdev, fetch)` passes what the app's
`_dispatch_fused` passes: top_k for every leg, rrf_k, the store's search
mode for the precision, the rescore multiplier and the fusion weighting.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

MODE_OF_PRECISION = {"binary": "binary", "int8": "int8", "both": "int8"}


def capacity_of(n: int, quantum: int = 1 << 16) -> int:
    """The engine's row capacity for n rows reserved at once (pow2 up to
    the 65,536-row quantum, then its multiples)."""
    if n <= quantum:
        p = 256
        while p < n:
            p *= 2
        return p
    return -(-n // quantum) * quantum


class System:
    def __init__(self, config: Dict, traffic: Dict, corpus, params: Dict, device) -> None:
        from radiant_rag_tpu_torch.config import config_from_dict
        from radiant_rag_tpu_torch.index.bm25 import BM25Index
        from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
        from radiant_rag_tpu_torch.index.hybrid import HybridSearcher, resolve_fused_depth
        from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
        from radiant_rag_tpu_torch.models.embedder import Embedder
        from radiant_rag_tpu_torch.models.registry import LocalNLPModels

        self.cfg = cfg = config_from_dict(config["program_config"])
        self.traffic = traffic
        self.texts, self.words = corpus.texts, corpus.words
        self.stages: Dict[str, object] = {}
        n = corpus.vecs.shape[0]
        ix = cfg.index
        eng = DeviceVectorIndex(ix.dim, initial_capacity=ix.initial_capacity,
                                store_fp32=ix.store_fp32, vec_dtype=ix.dtype,
                                stage1_select=ix.stage1_select, device=device)
        eng.reserve(n)
        step = int(config["ingest_batch"])
        zeros8, zeros32 = np.zeros(step, np.int8), np.zeros(step, np.int32)
        lens = np.full(step, float(config["words_per_doc"]), np.float32)
        host = corpus.vecs_host.numpy()
        for s in range(0, n, step):
            m = min(step, n - s)
            eng.append(host[s:s + m], zeros8[:m], zeros32[:m], lens[:m])
        self.engine = eng
        c = cfg.bm25
        bm = BM25Index(k1=c.k1, b=c.b, max_query_terms=c.max_query_terms,
                       max_postings=c.max_postings_per_query, sketch_dim=c.sketch_dim,
                       sketch_hbm_budget_gb=c.sketch_hbm_budget_gb,
                       disc_route_df_frac=c.disc_route_df_frac,
                       pages_route_max_pages=c.pages_route_max_pages,
                       pages_route_max_cells=c.pages_route_max_cells, device=device)
        if not bm.bulk_build(list(range(n)), corpus.texts):
            raise RuntimeError("the native BM25 bulk build did not run")
        self.bm25 = bm
        emb = Embedder(cfg.embedding, params=params["embedder"], device=device)
        ce = CrossEncoder(cfg.cross_encoder, params=params["cross_encoder"], device=device)
        self.models = LocalNLPModels(cfg, embedder=emb, cross_encoder=ce, device=device)
        self.searcher = HybridSearcher(eng, bm)
        self.searcher.default_fused_depth = resolve_fused_depth(cfg.retrieval)
        r = cfg.retrieval
        self.probe_embeddings: Dict[tuple, np.ndarray] = {}
        if r.fusion_weighting != "equal":
            texts = corpus.texts
            self.searcher.calibrate_fusion(self._recorded_embed, texts.__getitem__,
                                           n_probes=r.calibration_probes,
                                           paraphrase_fraction=r.calibration_paraphrase_fraction,
                                           seeds=r.calibration_seeds)
        self.mode = MODE_OF_PRECISION[cfg.quantization.precision] \
            if cfg.quantization.enabled else "exact"
        self.reranker = None
        rr = traffic.get("rerank")
        if rr:
            from radiant_rag_tpu_torch.models.device_rerank import DeviceReranker

            self.reranker = DeviceReranker(ce, q_len=int(rr["q_len"]), d_len=int(rr["d_len"]),
                                           pair_chunk=int(rr["pair_chunk"]))
            self.reranker.build_table(corpus.texts)

    def _recorded_embed(self, texts):
        """The app's embedder, its outputs kept by their texts: the reference
        follows the calibration from the port's probe embeddings."""
        out = self.models.embed(texts)
        self.probe_embeddings[tuple(texts)] = np.array(out, np.float32)
        return out

    def embed(self, texts):
        from radiant_rag_tpu_torch.index.hybrid import embed_queries_device

        qdev = embed_queries_device(self.models, self.engine, texts)
        if qdev is None:
            raise RuntimeError("embed_queries_device declined the batch")
        return qdev

    def search(self, texts, vectors: Optional[np.ndarray] = None,
               qdev: Optional[torch.Tensor] = None, fetch: bool = True):
        cfg, k = self.cfg, int(self.traffic["top_k"])
        return self.searcher.search_rows(
            vectors, list(texts), dense_k=k, bm25_k=k, fused_k=k, rrf_k=cfg.retrieval.rrf_k,
            mode=self.mode, rescore_multiplier=cfg.quantization.rescore_multiplier,
            fusion=cfg.retrieval.fusion_weighting, fetch=fetch, _qdev=qdev)

    def rerank(self, texts, fused):
        rr = self.traffic["rerank"]
        scores, rows = fused
        return self.reranker.rerank_rows(list(texts), rows, top_k=int(rr["top_k"]),
                                         prior_scores=scores,
                                         prior_weight=float(rr["prior_weight"]))
