"""Hierarchical auto-merging: replace sibling chunks with their parent doc.

Capability parity with reference `agents/automerge.py:25-151`: group children
by parent_id; when >= min_children_to_merge siblings are present and the
parent is <= max_parent_chars, replace them with the parent at the max child
score; dedup keeping the best score per id (`automerge.py:85-137`).

The port's copy of `radiant_rag_tpu/agents/automerge.py`, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, BaseAgent
from radiant_rag_tpu_torch.agents.retrieval import dedup_best_score


class HierarchicalAutoMergingAgent(BaseAgent):
    name = "automerge"
    category = AgentCategory.POST_RETRIEVAL

    def __init__(self, store, min_children_to_merge: int = 2,
                 max_parent_chars: int = 50000, enabled: bool = True) -> None:
        super().__init__(enabled=enabled)
        self.store = store
        self.min_children_to_merge = min_children_to_merge
        self.max_parent_chars = max_parent_chars

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[DocScore]:
        docs = kwargs.get("docs")
        if docs is None:
            docs = ctx.fused_docs or ctx.dense_docs or ctx.bm25_docs
        merged = self.merge(docs)
        ctx.auto_merged_docs = merged
        return merged

    def merge(self, docs: List[DocScore]) -> List[DocScore]:
        by_parent: Dict[str, List[DocScore]] = {}
        no_parent: List[DocScore] = []
        for doc, score in docs:
            pid = doc.parent_id
            if pid:
                by_parent.setdefault(pid, []).append((doc, score))
            else:
                no_parent.append((doc, score))

        out: List[DocScore] = list(no_parent)
        for pid, children in by_parent.items():
            merged = False
            if len(children) >= self.min_children_to_merge:
                parent = self.store.get_doc(pid)
                if parent is not None and len(parent.content) <= self.max_parent_chars:
                    best = max(s for _, s in children)
                    out.append((parent, best))
                    merged = True
                    self.log.debug("merged %d children into parent %s", len(children), pid[:12])
            if not merged:
                out.extend(children)
        return dedup_best_score(out)

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[DocScore]:
        docs = kwargs.get("docs") or ctx.fused_docs or []
        ctx.auto_merged_docs = list(docs)
        return ctx.auto_merged_docs
