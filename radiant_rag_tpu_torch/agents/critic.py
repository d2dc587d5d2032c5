"""CriticAgent: LLM self-critique of the generated answer.

Capability parity with reference `agents/critic.py:53-332`: JSON critique
{ok, confidence, relevance/faithfulness/coverage 0-10, issues, should_retry,
retry_suggestions} with a scoring rubric, normalization deriving confidence
from the average score, `should_give_up` when retries are exhausted, and the
retrieval-quality heuristic (`critic.py:208-241`).

The port's copy of `radiant_rag_tpu/agents/critic.py`, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, LLMAgent

_CRITIQUE_PROMPT = """Evaluate this answer to the user's question against the retrieved context.

Score each dimension 0-10:
- relevance: does the answer address the question?
- faithfulness: is every claim grounded in the context (no fabrication)?
- coverage: does it use the relevant context fully?

Reply with ONLY a JSON object:
{{"ok": bool, "confidence": float 0-1, "relevance": int, "faithfulness": int,
  "coverage": int, "issues": [strings], "should_retry": bool,
  "retry_suggestions": [strings], "issue_type": "context"|"answer"|"none"}}

issue_type: "context" if retrieval failed to find the needed information,
"answer" if the context was fine but the answer is poor, "none" if ok.

Question: {query}

Context (truncated):
{context}

Answer:
{answer}"""

DEFAULT_CRITIQUE: Dict[str, Any] = {
    "ok": True, "confidence": 0.5, "relevance": 5, "faithfulness": 5,
    "coverage": 5, "issues": [], "should_retry": False,
    "retry_suggestions": [], "issue_type": "none",
}


class CriticAgent(LLMAgent):
    name = "critic"
    category = AgentCategory.EVALUATION

    def __init__(self, llm, max_chars_per_doc: int = 1200, max_docs: int = 6,
                 confidence_threshold: float = 0.5, give_up_confidence: float = 0.2,
                 enabled: bool = True) -> None:
        super().__init__(llm, enabled=enabled)
        self.max_chars_per_doc = max_chars_per_doc
        self.max_docs = max_docs
        self.confidence_threshold = confidence_threshold
        self.give_up_confidence = give_up_confidence

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> Dict[str, Any]:
        docs = kwargs.get("docs") or ctx.context_docs
        context = "\n\n".join(
            f"[DOC {i}] {d.content[: self.max_chars_per_doc]}"
            for i, (d, _s) in enumerate(docs[: self.max_docs], start=1)
        )
        raw = self._chat_json([{
            "role": "user",
            "content": _CRITIQUE_PROMPT.format(query=ctx.query, context=context,
                                               answer=ctx.final_answer),
        }], expect=dict)
        critique = self.normalize(raw or {})
        ctx.confidences["critic"] = critique["confidence"]
        if critique["issues"]:
            ctx.critic_notes.extend(str(i) for i in critique["issues"])
        return critique

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> Dict[str, Any]:
        """Default accept critique on failure (reference `critic.py:322-332`)."""
        return dict(DEFAULT_CRITIQUE)

    # -- helpers -----------------------------------------------------------
    def normalize(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """Coerce fields; derive confidence from avg dimension score when
        missing/invalid (reference `critic.py:257-291`)."""
        out = dict(DEFAULT_CRITIQUE)
        for dim in ("relevance", "faithfulness", "coverage"):
            try:
                out[dim] = max(0, min(10, int(raw.get(dim, 5))))
            except (TypeError, ValueError):
                out[dim] = 5
        avg = (out["relevance"] + out["faithfulness"] + out["coverage"]) / 30.0
        try:
            conf = float(raw.get("confidence"))
            out["confidence"] = conf if 0.0 <= conf <= 1.0 else avg
        except (TypeError, ValueError):
            out["confidence"] = avg
        out["ok"] = bool(raw.get("ok", out["confidence"] >= self.confidence_threshold))
        out["should_retry"] = bool(raw.get("should_retry", not out["ok"]))
        out["issues"] = [str(i) for i in raw.get("issues", []) if str(i).strip()]
        out["retry_suggestions"] = [str(s) for s in raw.get("retry_suggestions", [])]
        it = raw.get("issue_type", "none")
        out["issue_type"] = it if it in ("context", "answer", "none") else "none"
        return out

    def should_give_up(self, critique: Dict[str, Any], attempt: int, max_retries: int) -> bool:
        """Reference `critic.py:293-320`."""
        conf = critique.get("confidence", 0.0)
        if conf < self.give_up_confidence:
            return True
        return attempt >= max_retries and conf < self.confidence_threshold

    def evaluate_retrieval_quality(self, docs: List[DocScore]) -> float:
        """Heuristic: mean of top-10 scores (reference `critic.py:208-241`)."""
        if not docs:
            return 0.0
        top = [max(0.0, min(1.0, s)) for _, s in docs[:10]]
        return sum(top) / len(top)
