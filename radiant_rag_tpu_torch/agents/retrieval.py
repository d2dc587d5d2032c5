"""Dense and BM25 retrieval agents.

Capability parity with reference `agents/dense.py:26` (embed -> store KNN with
search_scope -> doc_level_filter mapping) and `agents/bm25.py:25`. Both are
batched: given N effective queries they embed once and retrieve in one
device search (the reference loops per query, `orchestrator.py:933-991`).
`_on_error` returns [] (reference `dense.py:131-141`).

The port's copy of `radiant_rag_tpu/agents/retrieval.py`. The embed and
the store or BM25 search are device stages (`base_agent.DeviceStages`):
a failure raises out of the pipeline instead of returning [].
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import (
    AgentCategory, BaseAgent, DeviceStages, RetrievalAgent,
)

_SCOPE_TO_LEVEL = {"leaves": "leaf", "parents": "parent", "all": None}


def dedup_best_score(hits: Sequence[DocScore]) -> List[DocScore]:
    """Keep the best score per doc_id, order by score desc."""
    best: Dict[str, DocScore] = {}
    for doc, score in hits:
        cur = best.get(doc.doc_id)
        if cur is None or score > cur[1]:
            best[doc.doc_id] = (doc, score)
    return sorted(best.values(), key=lambda ds: -ds[1])


class DenseRetrievalAgent(RetrievalAgent):
    name = "dense_retrieval"
    category = AgentCategory.RETRIEVAL

    def __init__(self, store, local_models, top_k: int = 10,
                 min_similarity: float = 0.0, search_scope: str = "leaves",
                 enabled: bool = True, device_stages: Optional[DeviceStages] = None) -> None:
        super().__init__(store, local_models, enabled=enabled, device_stages=device_stages)
        self.top_k = top_k
        self.min_similarity = min_similarity
        self.search_scope = search_scope

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[DocScore]:
        queries = kwargs.get("queries") or ctx.effective_queries or [ctx.query]
        hits = self.retrieve_batch(queries, top_k=kwargs.get("top_k", self.top_k))
        ctx.dense_docs = hits
        return hits

    def retrieve_batch(self, queries: Sequence[str], top_k: Optional[int] = None) -> List[DocScore]:
        with self.device_stage("dense retrieval"):
            embeddings = self._embed_batch(list(queries))
            per_query = self.store.retrieve_by_embedding_batch(
                embeddings,
                top_k=top_k or self.top_k,
                min_similarity=self.min_similarity,
                doc_level_filter=_SCOPE_TO_LEVEL.get(self.search_scope),
            )
        return dedup_best_score([h for hits in per_query for h in hits])

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[DocScore]:
        ctx.dense_docs = []
        return []


class BM25RetrievalAgent(BaseAgent):
    name = "bm25_retrieval"
    category = AgentCategory.RETRIEVAL

    def __init__(self, bm25_index, top_k: int = 10, enabled: bool = True,
                 device_stages: Optional[DeviceStages] = None) -> None:
        super().__init__(enabled=enabled)
        if bm25_index is None:
            raise ValueError("bm25_retrieval requires a BM25 index")
        self.index = bm25_index
        self.top_k = top_k
        self.device_stage = device_stages or DeviceStages()

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[DocScore]:
        queries = kwargs.get("queries") or ctx.effective_queries or [ctx.query]
        with self.device_stage("bm25 retrieval"):
            per_query = self.index.search_batch(list(queries),
                                                top_k=kwargs.get("top_k", self.top_k))
        hits = dedup_best_score([h for hits in per_query for h in hits])
        ctx.bm25_docs = hits
        return hits

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[DocScore]:
        ctx.bm25_docs = []
        return []
