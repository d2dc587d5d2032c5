"""Answer synthesis from retrieved context.

Capability parity with reference `agents/synthesis.py:26-142`: formats at most
max_context_docs docs as numbered [DOC i] blocks with sources, instructs the
LLM to answer ONLY from context citing [DOC n], optionally prepends
conversation history and tool outputs.

The port's copy of `radiant_rag_tpu/agents/synthesis.py`, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, LLMAgent

_SYSTEM = (
    "You are a careful assistant answering questions from retrieved documents. "
    "Use ONLY the provided context. Cite supporting documents inline as [DOC n]. "
    "If the context does not contain the answer, say you don't know."
)


class AnswerSynthesisAgent(LLMAgent):
    name = "synthesis"
    category = AgentCategory.GENERATION

    def __init__(self, llm, max_context_docs: int = 8, max_chars_per_doc: int = 4000,
                 include_history: bool = True, enabled: bool = True) -> None:
        super().__init__(llm, enabled=enabled)
        self.max_context_docs = max_context_docs
        self.max_chars_per_doc = max_chars_per_doc
        self.include_history = include_history

    def format_context(self, docs: List[DocScore]) -> str:
        blocks = []
        for i, (doc, _score) in enumerate(docs[: self.max_context_docs], start=1):
            source = doc.source or "unknown"
            content = doc.content[: self.max_chars_per_doc]
            blocks.append(f"[DOC {i}] (Source: {source})\n{content}")
        return "\n\n".join(blocks)

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> str:
        docs = kwargs.get("docs") or ctx.context_docs
        context = self.format_context(docs)
        tool_notes = ""
        if ctx.tool_results:
            lines = [f"- {r.get('tool')}: {r.get('output')}" for r in ctx.tool_results]
            tool_notes = "\n\nTool results:\n" + "\n".join(lines)
        messages: List[Dict[str, str]] = [{"role": "system", "content": _SYSTEM}]
        if self.include_history and ctx.conversation_history:
            messages.extend(ctx.conversation_history[-6:])
        user = f"Context:\n{context}{tool_notes}\n\nQuestion: {ctx.query}"
        messages.append({"role": "user", "content": user})
        sink = ctx.extras.get("token_sink")
        if sink is not None:  # live token streaming (server /query/stream)
            answer = self.llm.chat_stream(messages, on_token=sink)
        else:
            answer = self._chat(messages)
        ctx.final_answer = answer.strip()
        return ctx.final_answer

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> str:
        ctx.final_answer = ""
        raise exc  # synthesis failure is fatal for the phase; orchestrator handles
