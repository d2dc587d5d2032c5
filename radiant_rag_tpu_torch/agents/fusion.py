"""RRFAgent: reciprocal-rank fusion over named runs of (doc, score) lists.

Capability parity with reference `agents/fusion.py:24-115` (score[doc] +=
1/(rrf_k + rank), rrf_k=60, top fused_top_k). The hybrid fast path fuses row
ids on device (`ops/fusion.py` inside `index/hybrid.py`); this agent is the
doc-object API used when runs come from heterogeneous sources (e.g. web
results), where k is tiny and host fusion is free.

The port's copy of `radiant_rag_tpu/agents/fusion.py`, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, BaseAgent


class RRFAgent(BaseAgent):
    name = "rrf_fusion"
    category = AgentCategory.POST_RETRIEVAL

    def __init__(self, rrf_k: int = 60, top_k: int = 15, enabled: bool = True) -> None:
        super().__init__(enabled=enabled)
        self.rrf_k = rrf_k
        self.top_k = top_k

    def fuse(self, runs: Sequence[Sequence[DocScore]], top_k: int = 0) -> List[DocScore]:
        scores: Dict[str, float] = {}
        docs: Dict[str, Any] = {}
        for run in runs:
            for rank, (doc, _score) in enumerate(run, start=1):
                scores[doc.doc_id] = scores.get(doc.doc_id, 0.0) + 1.0 / (self.rrf_k + rank)
                docs.setdefault(doc.doc_id, doc)
        fused = sorted(scores.items(), key=lambda kv: -kv[1])
        k = top_k or self.top_k
        return [(docs[doc_id], score) for doc_id, score in fused[:k]]

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[DocScore]:
        runs = kwargs.get("runs")
        if runs is None:
            runs = [r for r in (ctx.dense_docs, ctx.bm25_docs, ctx.web_docs) if r]
        fused = self.fuse(runs, top_k=kwargs.get("top_k", self.top_k))
        ctx.fused_docs = fused
        return fused

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[DocScore]:
        # passthrough: best single run
        runs = [r for r in (ctx.dense_docs, ctx.bm25_docs, ctx.web_docs) if r]
        fused = max(runs, key=len)[: self.top_k] if runs else []
        ctx.fused_docs = list(fused)
        return ctx.fused_docs
