"""PlanningAgent: LLM query plan + retry mutation + strategy-memory injection.

Capability parity with reference `agents/planning.py:27-313`: produces a JSON
plan {use_decomposition/rewrite/expansion/rrf/automerge/rerank/critic/
web_search, retrieval_mode, tools_to_use}, validates/merges with defaults,
injects the strategy-memory recommendation when its confidence is high, and
`plan_retry()` mutates the plan after a critique (mode cycling
hybrid -> dense -> bm25 as fallback).

The port's copy of `radiant_rag_tpu/agents/planning.py`, unchanged.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from radiant_rag_tpu_torch.agents.base import AgentContext
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, LLMAgent

logger = logging.getLogger(__name__)

PLAN_DEFAULTS: Dict[str, Any] = {
    "use_decomposition": False,
    "use_rewrite": True,
    "use_expansion": False,
    "use_rrf": True,
    "use_automerge": True,
    "use_rerank": True,
    "use_critic": True,
    "use_web_search": False,
    "use_multihop": False,
    "retrieval_mode": "hybrid",
    "tools_to_use": [],
}

_MODE_CYCLE = {"hybrid": "dense", "dense": "bm25", "bm25": "hybrid"}

_PLAN_PROMPT = """You are a query-planning agent for a retrieval-augmented QA system.
Given the user query, decide which pipeline features to enable.

Reply with ONLY a JSON object with these keys:
- use_decomposition (bool): split a multi-part question into sub-queries
- use_rewrite (bool): rewrite the query for retrieval
- use_expansion (bool): add synonym/related-term query variants
- use_rrf (bool): fuse dense + keyword results
- use_automerge (bool): merge sibling chunks into parent documents
- use_rerank (bool): cross-encoder rerank
- use_critic (bool): self-critique the answer
- use_web_search (bool): fetch web pages (only for clearly time-sensitive queries)
- use_multihop (bool): multi-hop reasoning for bridge/comparison questions
- retrieval_mode (string): "hybrid", "dense", or "bm25"
- tools_to_use (array of strings): e.g. ["calculator"] when arithmetic is needed

Query: {query}"""


class PlanningAgent(LLMAgent):
    name = "planning"
    category = AgentCategory.PLANNING

    def __init__(self, llm, strategy_memory=None, enabled: bool = True,
                 memory_min_confidence: float = 0.6) -> None:
        super().__init__(llm, enabled=enabled)
        self.strategy_memory = strategy_memory
        self.memory_min_confidence = memory_min_confidence

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> Dict[str, Any]:
        raw = self._chat_json(
            [{"role": "user", "content": _PLAN_PROMPT.format(query=ctx.query)}],
            expect=dict,
        )
        plan = self.validate_plan(raw or {})
        plan = self._apply_strategy_memory(ctx, plan)
        ctx.plan = plan
        ctx.retrieval_mode = plan["retrieval_mode"]
        return plan

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> Dict[str, Any]:
        """Default plan on failure (reference `planning.py:292-313`)."""
        plan = dict(PLAN_DEFAULTS)
        ctx.plan = plan
        ctx.retrieval_mode = plan["retrieval_mode"]
        return plan

    # -- helpers -----------------------------------------------------------
    def validate_plan(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """Merge with defaults; coerce types (reference `planning.py:173-216`)."""
        plan = dict(PLAN_DEFAULTS)
        for key, default in PLAN_DEFAULTS.items():
            if key not in raw:
                continue
            v = raw[key]
            if isinstance(default, bool):
                plan[key] = bool(v)
            elif key == "retrieval_mode":
                plan[key] = v if v in ("hybrid", "dense", "bm25") else "hybrid"
            elif key == "tools_to_use":
                plan[key] = [str(t) for t in v] if isinstance(v, list) else []
        return plan

    def _apply_strategy_memory(self, ctx: AgentContext, plan: Dict[str, Any]) -> Dict[str, Any]:
        if self.strategy_memory is None:
            return plan
        try:
            mode, confidence = self.strategy_memory.recommend_strategy(ctx.query)
            if mode and confidence > self.memory_min_confidence:
                self.log.info("strategy memory recommends %s (conf %.2f)", mode, confidence)
                plan["retrieval_mode"] = mode
        except Exception as exc:  # memory must never break planning
            self.log.warning("strategy memory failed: %s", exc)
        return plan

    def plan_retry(self, ctx: AgentContext, critique: Dict[str, Any]) -> Dict[str, Any]:
        """Mutate the plan after a failed critique (reference
        `planning.py:226-290`): enable expansion/decomposition on context
        issues and cycle the retrieval mode as a last resort."""
        plan = dict(ctx.plan or PLAN_DEFAULTS)
        issues = " ".join(str(i) for i in critique.get("issues", [])).lower()
        suggestions = " ".join(str(s) for s in critique.get("retry_suggestions", [])).lower()
        blob = issues + " " + suggestions
        changed = False
        if not plan.get("use_expansion") and ("coverage" in blob or "missing" in blob or "expand" in blob):
            plan["use_expansion"] = True
            changed = True
        if not plan.get("use_decomposition") and ("multiple" in blob or "decompos" in blob or "parts" in blob):
            plan["use_decomposition"] = True
            changed = True
        if not changed:
            plan["retrieval_mode"] = _MODE_CYCLE.get(plan.get("retrieval_mode", "hybrid"), "hybrid")
        ctx.plan = plan
        ctx.retrieval_mode = plan["retrieval_mode"]
        return plan
