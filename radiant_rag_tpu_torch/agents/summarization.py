"""Context compression: summarize long docs + embedding-dedup near-duplicates.

Capability parity with reference `agents/summarization.py:51-576`: triggers
when total context chars exceed max_total_context_chars (8000); long docs are
LLM-summarized per doc; near-duplicate docs (embedding cosine >=
dedup_similarity, 0.85) are clustered and only the best-scored representative
kept; conversation compression keeps recent turns. The similarity matrix runs
on device through the embedder.

The port's copy of `radiant_rag_tpu/agents/summarization.py`. The
dedup's embed is a device stage (`base_agent.DeviceStages`): its
failure raises instead of falling back to a truncation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, DeviceStages, LLMAgent
from radiant_rag_tpu_torch.index.doc import StoredDoc


@dataclass
class CompressionStats:
    original_chars: int = 0
    compressed_chars: int = 0
    docs_summarized: int = 0
    docs_deduped: int = 0


class SummarizationAgent(LLMAgent):
    name = "summarization"
    category = AgentCategory.POST_RETRIEVAL

    def __init__(self, llm, local_models=None, max_total_context_chars: int = 8000,
                 max_doc_chars: int = 3000, dedup_similarity: float = 0.85,
                 keep_recent_turns: int = 4, enabled: bool = True,
                 device_stages: Optional[DeviceStages] = None) -> None:
        super().__init__(llm, enabled=enabled)
        self.device_stage = device_stages or DeviceStages()
        self.local_models = local_models
        self.max_total_context_chars = max_total_context_chars
        self.max_doc_chars = max_doc_chars
        self.dedup_similarity = dedup_similarity
        self.keep_recent_turns = keep_recent_turns

    def needs_compression(self, docs: List[DocScore]) -> bool:
        return sum(len(d.content) for d, _ in docs) > self.max_total_context_chars

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[DocScore]:
        docs = kwargs.get("docs") or ctx.context_docs
        if not self.needs_compression(docs):
            return list(docs)
        compressed, stats = self.compress(docs)
        ctx.extras["compression"] = stats.__dict__
        return compressed

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[DocScore]:
        docs = kwargs.get("docs") or ctx.context_docs
        # hard-truncate fallback keeps the pipeline running
        return [(d, s) for d, s in docs][:6]

    def compress(self, docs: List[DocScore]) -> tuple:
        stats = CompressionStats(original_chars=sum(len(d.content) for d, _ in docs))
        docs = self.dedup(docs, stats)
        out: List[DocScore] = []
        for doc, score in docs:
            if len(doc.content) > self.max_doc_chars:
                summary = self.summarize_doc(doc.content)
                meta = dict(doc.meta)
                meta["compressed"] = True
                meta["original_chars"] = len(doc.content)
                out.append((StoredDoc(doc.doc_id, summary, meta), score))
                stats.docs_summarized += 1
            else:
                out.append((doc, score))
        stats.compressed_chars = sum(len(d.content) for d, _ in out)
        return out, stats

    def summarize_doc(self, content: str) -> str:
        return self._chat([{
            "role": "user",
            "content": (
                "Summarize the passage, preserving all facts, numbers, names and "
                f"technical details, in at most {self.max_doc_chars // 4} words:\n\n"
                + content[: self.max_doc_chars * 4]
            ),
        }]).strip()

    def dedup(self, docs: List[DocScore], stats: CompressionStats) -> List[DocScore]:
        """Drop docs whose embedding cosine vs a kept doc >= threshold."""
        if self.local_models is None or len(docs) < 2:
            return docs
        with self.device_stage("summarization dedup"):
            embs = self.local_models.embed([d.content[:2000] for d, _ in docs])
        embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        sim = embs @ embs.T
        keep: List[int] = []
        for i in range(len(docs)):  # docs arrive best-score-first
            if all(sim[i, j] < self.dedup_similarity for j in keep):
                keep.append(i)
            else:
                stats.docs_deduped += 1
        return [docs[i] for i in keep]

    def compress_conversation(self, history: List[Dict[str, str]]) -> List[Dict[str, str]]:
        """Summarize old turns, keep recent verbatim (reference behavior)."""
        if len(history) <= self.keep_recent_turns:
            return history
        old, recent = history[: -self.keep_recent_turns], history[-self.keep_recent_turns :]
        transcript = "\n".join(f"{m['role']}: {m['content'][:500]}" for m in old)
        summary = self._chat([{
            "role": "user",
            "content": "Summarize this conversation in 3-4 sentences, keeping "
                       "key facts and decisions:\n\n" + transcript,
        }]).strip()
        return [{"role": "system", "content": f"Earlier conversation summary: {summary}"}] + recent
