"""AgentContext: the mutable state carrier threaded through a pipeline run
(reference `agents/base.py:18-126`).

The port's copy of `radiant_rag_tpu/agents/base.py`, over the port's `StoredDoc`.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from radiant_rag_tpu_torch.index.doc import StoredDoc

DocScore = Tuple[StoredDoc, float]


@dataclass
class AgentContext:
    run_id: str
    query: str
    plan: Dict[str, Any] = field(default_factory=dict)
    decomposed_queries: List[str] = field(default_factory=list)
    rewrites: Dict[str, str] = field(default_factory=dict)  # before -> after
    expansions: List[str] = field(default_factory=list)
    effective_queries: List[str] = field(default_factory=list)
    dense_docs: List[DocScore] = field(default_factory=list)
    bm25_docs: List[DocScore] = field(default_factory=list)
    web_docs: List[DocScore] = field(default_factory=list)
    fused_docs: List[DocScore] = field(default_factory=list)
    auto_merged_docs: List[DocScore] = field(default_factory=list)
    reranked_docs: List[DocScore] = field(default_factory=list)
    final_answer: str = ""
    critic_notes: List[str] = field(default_factory=list)
    conversation_history: List[Dict[str, str]] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    confidences: Dict[str, float] = field(default_factory=dict)
    retrieval_mode: str = "hybrid"
    retry_history: List[Dict[str, Any]] = field(default_factory=list)
    tool_results: List[Dict[str, Any]] = field(default_factory=list)
    multihop: Dict[str, Any] = field(default_factory=dict)
    fact_verification: Dict[str, Any] = field(default_factory=dict)
    citations: Dict[str, Any] = field(default_factory=dict)
    language: Dict[str, Any] = field(default_factory=dict)
    low_confidence: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)

    def add_warning(self, msg: str) -> None:
        self.warnings.append(msg)

    @property
    def context_docs(self) -> List[DocScore]:
        """The docs that will feed synthesis, best available stage first."""
        for docs in (self.reranked_docs, self.auto_merged_docs, self.fused_docs,
                     self.dense_docs, self.bm25_docs):
            if docs:
                return docs
        return []


def new_agent_context(query: str, **kwargs: Any) -> AgentContext:
    return AgentContext(run_id=uuid.uuid4().hex[:12], query=query, **kwargs)
