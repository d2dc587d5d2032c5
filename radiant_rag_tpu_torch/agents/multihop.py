"""Multi-hop reasoning: detect, decompose into sequential hops, retrieve+extract per hop.

Capability parity with reference `agents/multihop.py:78-552`: regex indicators
for bridge/comparison/temporal/compositional questions plus an LLM check;
LLM decomposition into <=3 sequential sub-questions; per-hop retrieve
(docs_per_hop, all levels) -> LLM answer+entity extraction -> accumulate
knowledge, stopping on low confidence or a sufficiency check. Merged docs are
handed back to the orchestrator to append to fused at score 0.7
(`orchestrator.py:1552-1563`).

The port's copy of `radiant_rag_tpu/agents/multihop.py`. Each hop's embed
and retrieve is a device stage (`base_agent.DeviceStages`): its failure
raises instead of dropping the hops.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, DeviceStages, LLMAgent

_INDICATORS = {
    "bridge": re.compile(r"\b(the (author|director|creator|founder|inventor) of|whose|of the (city|country|company) (that|which))\b", re.I),
    "comparison": re.compile(r"\b(compare|difference between|older|younger|larger|smaller|more than|less than|versus|vs\.?)\b", re.I),
    "temporal": re.compile(r"\b(before|after|during|when .* (was|did)|first|last|earliest|latest)\b", re.I),
    "compositional": re.compile(r"\b(and (also|then)|both .* and|as well as)\b", re.I),
}


class MultiHopReasoningAgent(LLMAgent):
    name = "multihop"
    category = AgentCategory.RETRIEVAL

    def __init__(self, llm, store, local_models, max_hops: int = 3,
                 docs_per_hop: int = 4, min_hop_confidence: float = 0.3,
                 enabled: bool = True, device_stages: Optional[DeviceStages] = None) -> None:
        super().__init__(llm, enabled=enabled)
        self.device_stage = device_stages or DeviceStages()
        self.store = store
        self.local_models = local_models
        self.max_hops = max_hops
        self.docs_per_hop = docs_per_hop
        self.min_hop_confidence = min_hop_confidence

    # -- detection -----------------------------------------------------------
    def detect(self, query: str, use_llm: bool = False) -> Tuple[bool, str]:
        """Regex indicators first (reference `multihop.py:98-113`), optional
        LLM confirmation (`multihop.py:183-197`)."""
        for kind, rx in _INDICATORS.items():
            if rx.search(query):
                return True, kind
        if use_llm:
            raw = self._chat_json([{
                "role": "user",
                "content": ("Does answering this require multi-hop reasoning "
                            "(finding an intermediate fact first)? Reply ONLY "
                            f'{{"multihop": bool, "kind": string}}.\n\nQuestion: {query}'),
            }], expect=dict)
            if raw and raw.get("multihop"):
                return True, str(raw.get("kind", "llm"))
        return False, ""

    # -- decomposition ---------------------------------------------------------
    def decompose_hops(self, query: str) -> List[str]:
        arr = self._chat_json([{
            "role": "user",
            "content": (
                "Break this question into a SEQUENCE of sub-questions where each "
                "depends on the previous answer. Use the placeholder {prev} where "
                f"the previous hop's answer should be substituted. Return a JSON "
                f"array of at most {self.max_hops} strings.\n\nQuestion: {query}"
            ),
        }], expect=list)
        hops = [str(h).strip() for h in (arr or []) if str(h).strip()]
        return hops[: self.max_hops] or [query]

    # -- execution ---------------------------------------------------------
    def _execute(self, ctx: AgentContext, **kwargs: Any) -> Dict[str, Any]:
        is_multi, kind = self.detect(ctx.query)
        if not is_multi and not kwargs.get("force", False):
            result = {"used": False, "kind": "", "hops": [], "docs": [], "knowledge": []}
            ctx.multihop = result
            return result
        hops = self.decompose_hops(ctx.query)
        knowledge: List[Dict[str, str]] = []
        all_docs: List[DocScore] = []
        prev_answer = ""
        for i, hop in enumerate(hops):
            hop_q = hop.replace("{prev}", prev_answer) if prev_answer else hop
            with self.device_stage("multihop retrieval"):
                emb = self.local_models.embed_single(hop_q)
                docs = self.store.retrieve_by_embedding(emb, top_k=self.docs_per_hop)
            all_docs.extend(docs)
            extraction = self._extract(hop_q, docs)
            confidence = float(extraction.get("confidence", 0.0) or 0.0)
            knowledge.append({
                "hop": hop_q, "answer": str(extraction.get("answer", "")),
                "entities": extraction.get("entities", []), "confidence": confidence,
            })
            prev_answer = str(extraction.get("answer", ""))
            if confidence < self.min_hop_confidence:
                self.log.info("multihop stopping at hop %d (confidence %.2f)", i + 1, confidence)
                break
            if extraction.get("sufficient"):
                break
        result = {"used": True, "kind": kind, "hops": hops, "docs": all_docs,
                  "knowledge": knowledge}
        ctx.multihop = result
        return result

    def _extract(self, hop_q: str, docs: List[DocScore]) -> Dict[str, Any]:
        context = "\n\n".join(f"[{i}] {d.content[:1000]}" for i, (d, _s) in enumerate(docs, 1))
        raw = self._chat_json([{
            "role": "user",
            "content": (
                "Answer the sub-question from the context. Reply ONLY JSON "
                '{"answer": string, "entities": [strings], "confidence": float 0-1, '
                '"sufficient": bool (true if this answers the ORIGINAL question)}.'
                f"\n\nSub-question: {hop_q}\n\nContext:\n{context}"
            ),
        }], expect=dict)
        return raw or {"answer": "", "entities": [], "confidence": 0.0, "sufficient": False}

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> Dict[str, Any]:
        result = {"used": False, "kind": "", "hops": [], "docs": [], "knowledge": []}
        ctx.multihop = result
        return result
