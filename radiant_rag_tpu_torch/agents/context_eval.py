"""Pre-generation context sufficiency gate.

Capability parity with reference `agents/context_eval.py:21-147`: heuristic
(score statistics) and/or LLM evaluation producing {sufficient, confidence,
relevance/coverage scores, missing_aspects, recommendation in
proceed/expand_retrieval/rewrite_query/abort}; the orchestrator acts on the
recommendation (`orchestrator.py:496-518`).

The port's copy of `radiant_rag_tpu/agents/context_eval.py`, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, BaseAgent


@dataclass
class ContextEvaluation:
    sufficient: bool = True
    confidence: float = 0.5
    relevance_score: float = 0.5
    coverage_score: float = 0.5
    missing_aspects: List[str] = field(default_factory=list)
    recommendation: str = "proceed"  # proceed | expand_retrieval | rewrite_query | abort

    def to_dict(self) -> Dict[str, Any]:
        return {
            "sufficient": self.sufficient,
            "confidence": self.confidence,
            "relevance_score": self.relevance_score,
            "coverage_score": self.coverage_score,
            "missing_aspects": list(self.missing_aspects),
            "recommendation": self.recommendation,
        }


class ContextEvaluationAgent(BaseAgent):
    name = "context_eval"
    category = AgentCategory.EVALUATION

    def __init__(self, llm=None, use_llm: bool = False, min_mean_score: float = 0.25,
                 min_docs: int = 1, enabled: bool = True) -> None:
        super().__init__(enabled=enabled)
        self.llm = llm
        self.use_llm = use_llm and llm is not None
        self.min_mean_score = min_mean_score
        self.min_docs = min_docs

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> ContextEvaluation:
        docs = kwargs.get("docs") or ctx.context_docs
        ev = self.heuristic_eval(docs)
        if self.use_llm and ev.sufficient:  # only spend an LLM call on the gray zone
            ev = self.llm_eval(ctx.query, docs, ev)
        ctx.confidences["context_eval"] = ev.confidence
        return ev

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> ContextEvaluation:
        return ContextEvaluation()  # permissive default: proceed

    def heuristic_eval(self, docs: List[DocScore]) -> ContextEvaluation:
        """Score-statistics gate (reference heuristic path)."""
        if len(docs) < self.min_docs:
            return ContextEvaluation(
                sufficient=False, confidence=0.9, relevance_score=0.0,
                coverage_score=0.0, recommendation="expand_retrieval",
                missing_aspects=["no documents retrieved"],
            )
        scores = [max(0.0, min(1.0, s)) for _, s in docs[:10]]
        mean = sum(scores) / len(scores)
        top = scores[0]
        if mean < self.min_mean_score and top < 2 * self.min_mean_score:
            return ContextEvaluation(
                sufficient=False, confidence=0.7, relevance_score=mean,
                coverage_score=mean, recommendation="rewrite_query",
                missing_aspects=["low retrieval scores"],
            )
        return ContextEvaluation(sufficient=True, confidence=min(1.0, 0.5 + mean),
                                 relevance_score=mean, coverage_score=mean)

    def llm_eval(self, query: str, docs: List[DocScore], base: ContextEvaluation) -> ContextEvaluation:
        context = "\n\n".join(f"[{i}] {d.content[:800]}" for i, (d, _s) in enumerate(docs[:6], 1))
        raw = self.llm.chat_json([{
            "role": "user",
            "content": (
                "Can the question be answered from this context? Reply ONLY JSON "
                '{"sufficient": bool, "confidence": float, "relevance": float 0-1, '
                '"coverage": float 0-1, "missing_aspects": [strings], '
                '"recommendation": "proceed"|"expand_retrieval"|"rewrite_query"|"abort"}'
                f"\n\nQuestion: {query}\n\nContext:\n{context}"
            ),
        }], expect=dict)
        if not raw:
            return base
        rec = raw.get("recommendation", "proceed")
        return ContextEvaluation(
            sufficient=bool(raw.get("sufficient", True)),
            confidence=float(raw.get("confidence", base.confidence) or base.confidence),
            relevance_score=float(raw.get("relevance", base.relevance_score) or 0.5),
            coverage_score=float(raw.get("coverage", base.coverage_score) or 0.5),
            missing_aspects=[str(a) for a in raw.get("missing_aspects", [])],
            recommendation=rec if rec in ("proceed", "expand_retrieval", "rewrite_query", "abort") else "proceed",
        )
