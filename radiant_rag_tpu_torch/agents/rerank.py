"""Cross-encoder reranking agent.

Capability parity with reference `agents/rerank.py:25-131`: scores the top
k x candidate_multiplier (at least min_candidates) docs with the cross-encoder
over truncated text and remaps indices; `_on_error` returns input[:k].
The scoring itself runs on the card (`models/cross_encoder.py`).

The port's copy of `radiant_rag_tpu/agents/rerank.py`. The cross-encoder
call is a device stage (`base_agent.DeviceStages`): it runs under the
device lock, and its failure raises out of the pipeline instead of
serving the incoming order.
"""

from __future__ import annotations

from typing import Any, List, Optional

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, BaseAgent, DeviceStages


class CrossEncoderRerankingAgent(BaseAgent):
    name = "rerank"
    category = AgentCategory.POST_RETRIEVAL

    def __init__(self, local_models, top_k: int = 8, candidate_multiplier: int = 4,
                 min_candidates: int = 16, max_chars: int = 3000,
                 enabled: bool = True, prior_weight: float = 1.0,
                 device_stages: Optional[DeviceStages] = None) -> None:
        super().__init__(enabled=enabled)
        self.device_stage = device_stages or DeviceStages()
        self.local_models = local_models
        self.top_k = top_k
        self.candidate_multiplier = candidate_multiplier
        self.min_candidates = min_candidates
        self.max_chars = max_chars
        self.prior_weight = prior_weight

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[DocScore]:
        docs = kwargs.get("docs")
        if docs is None:
            docs = ctx.auto_merged_docs or ctx.fused_docs or ctx.dense_docs or ctx.bm25_docs
        top_k = kwargs.get("top_k", self.top_k)
        reranked = self.rerank(ctx.query, docs, top_k)
        ctx.reranked_docs = reranked
        return reranked

    def rerank(self, query: str, docs: List[DocScore], top_k: int) -> List[DocScore]:
        if not docs:
            return []
        n_cand = max(top_k * self.candidate_multiplier, self.min_candidates)
        candidates = docs[:n_cand]
        with self.device_stage("rerank"):
            ranked = self.local_models.rerank(
                query, [d.content for d, _ in candidates],
                top_k=None, max_chars=self.max_chars,
            )
        if self.prior_weight <= 0.0 or len(candidates) < 2:
            return [(candidates[i][0], float(score))
                    for i, score in ranked[:top_k]]
        # Retrieval-prior blend: order by z(CE) + w * z(incoming score) so a
        # weak/untrained CE cannot drop the fused ordering it consumes (the
        # device path does the same — `models/device_rerank.py`; measured:
        # pure CE order with a from-scratch CE = 0.54 MRR vs incoming 0.82,
        # BENCH_NOTES round 4). Returned scores stay raw CE logits, matching
        # DeviceReranker's output semantics.
        import numpy as np

        ce = np.zeros(len(candidates), np.float64)
        for i, score in ranked:
            ce[i] = score
        prior = np.asarray([s for _, s in candidates], np.float64)

        def z(x):
            sd = x.std()
            return (x - x.mean()) / (sd if sd > 1e-12 else 1.0)

        final = z(ce) + self.prior_weight * z(prior)
        order = np.argsort(-final)[:top_k]
        return [(candidates[int(i)][0], float(ce[int(i)])) for i in order]

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[DocScore]:
        docs = kwargs.get("docs") or ctx.auto_merged_docs or ctx.fused_docs or []
        top_k = kwargs.get("top_k", self.top_k)
        ctx.reranked_docs = list(docs[:top_k])
        return ctx.reranked_docs
