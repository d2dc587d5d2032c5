"""Query decomposition, rewrite, and expansion agents.

Capability parity with reference `agents/decomposition.py:25`,
`agents/rewrite.py:24` (incl. the batched `rewrite_batch` single-LLM-call
optimization, `rewrite.py:111`), and `agents/expansion.py:25`
(`expand_batch`, `expansion.py:113`).

The port's copy of `radiant_rag_tpu/agents/query_processing.py`, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List

from radiant_rag_tpu_torch.agents.base import AgentContext
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, LLMAgent


class QueryDecompositionAgent(LLMAgent):
    """Split a complex query into at most `max_queries` sub-queries."""

    name = "decomposition"
    category = AgentCategory.QUERY_PROCESSING

    def __init__(self, llm, max_queries: int = 3, enabled: bool = True) -> None:
        super().__init__(llm, enabled=enabled)
        self.max_queries = max_queries

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[str]:
        prompt = (
            "Decompose the question into independent sub-questions that can be "
            "answered separately, ONLY if it genuinely asks multiple things. "
            f"Return a JSON array of at most {self.max_queries} strings. If the "
            "question is simple, return an array with just the original question.\n\n"
            f"Question: {ctx.query}"
        )
        arr = self._chat_json([{"role": "user", "content": prompt}], expect=list)
        subs = [str(q).strip() for q in (arr or []) if str(q).strip()]
        subs = subs[: self.max_queries] or [ctx.query]
        ctx.decomposed_queries = subs
        return subs

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[str]:
        ctx.decomposed_queries = [ctx.query]
        return ctx.decomposed_queries


class QueryRewriteAgent(LLMAgent):
    """Rewrite queries for retrieval; N queries in ONE LLM call."""

    name = "rewrite"
    category = AgentCategory.QUERY_PROCESSING

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> Dict[str, str]:
        queries = kwargs.get("queries") or ctx.decomposed_queries or [ctx.query]
        rewrites = self.rewrite_batch(queries)
        ctx.rewrites.update(rewrites)
        return rewrites

    def rewrite_batch(self, queries: List[str]) -> Dict[str, str]:
        """Batched rewrite (reference `rewrite.py:111`: 1 call for N queries)."""
        numbered = "\n".join(f"{i+1}. {q}" for i, q in enumerate(queries))
        prompt = (
            "Rewrite each query to maximize retrieval quality: expand acronyms, "
            "drop filler words, keep all key entities. Return a JSON array of "
            f"exactly {len(queries)} rewritten strings, in order.\n\n{numbered}"
        )
        arr = self._chat_json([{"role": "user", "content": prompt}], expect=list)
        out: Dict[str, str] = {}
        if arr and len(arr) == len(queries):
            for q, r in zip(queries, arr):
                r = str(r).strip()
                out[q] = r if r else q
        else:
            out = {q: q for q in queries}
        return out

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> Dict[str, str]:
        queries = kwargs.get("queries") or ctx.decomposed_queries or [ctx.query]
        return {q: q for q in queries}


class QueryExpansionAgent(LLMAgent):
    """Generate synonym/related-term variants; batched like rewrite."""

    name = "expansion"
    category = AgentCategory.QUERY_PROCESSING

    def __init__(self, llm, max_expansions: int = 2, enabled: bool = True) -> None:
        super().__init__(llm, enabled=enabled)
        self.max_expansions = max_expansions

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[str]:
        queries = kwargs.get("queries") or ctx.decomposed_queries or [ctx.query]
        expansions = self.expand_batch(queries)
        ctx.expansions = expansions
        return expansions

    def expand_batch(self, queries: List[str]) -> List[str]:
        """One LLM call for all queries (reference `expansion.py:113`)."""
        numbered = "\n".join(f"{i+1}. {q}" for i, q in enumerate(queries))
        prompt = (
            f"For each query, produce up to {self.max_expansions} alternative "
            "phrasings using synonyms or closely related terms. Return ONE flat "
            "JSON array of strings (all alternatives for all queries).\n\n"
            f"{numbered}"
        )
        arr = self._chat_json([{"role": "user", "content": prompt}], expect=list)
        seen = set(q.lower() for q in queries)
        out: List[str] = []
        for e in arr or []:
            e = str(e).strip()
            if e and e.lower() not in seen:
                seen.add(e.lower())
                out.append(e)
            if len(out) >= self.max_expansions * len(queries):
                break
        return out

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[str]:
        return []
