"""Agent development scaffold: the guide to adding an agent to the port.

The port's counterpart of `radiant_rag_tpu/agents/agent_template.py`: copy
one of the four templates at the bottom, rename it, and work through the
walkthrough below. Everything in this file is executable and covered by
tests/test_torch_agent_template.py, so the scaffold cannot rot silently.

=======================================================================
THE SHAPE OF AN AGENT
=======================================================================

An agent is one pipeline phase with a uniform lifecycle::

    result = agent.run(ctx, **kwargs)   # -> AgentResult
    result.data                         # whatever _execute returned
    result.status                       # SUCCESS | PARTIAL | FAILED | SKIPPED
    result.metrics.duration_ms          # timing, exported when configured

`run()` (base_agent.py) handles for you: disabled -> SKIPPED short
circuit, timing and per-agent stats, correlation-id logging, the
`_on_error` degradation protocol, and metrics export
(`BaseAgent.metrics_sink`, utils/metrics_export.py). You write `_execute`
and decide the failure policy in `_on_error`.

Three degradation outcomes, chosen by `_on_error`:

    re-raise (default)       -> FAILED: the orchestrator marks the feature
                                degraded and goes on without it
    return fallback value    -> PARTIAL: the pipeline proceeds on the
                                fallback, a warning is attached
    (raise inside _on_error) -> FAILED with the secondary error

and one that `_on_error` never sees: a failure on the card. Device work
runs inside `self.device_stage(name)` (`base_agent.DeviceStages`), which
holds the app's device lock and raises any failure there as a
`DeviceStageError`; `run()` re-raises it, so it reaches the caller of
`RAGOrchestrator.run`. A broken card is an error, never another answer.

=======================================================================
WALKTHROUGH: ADDING `keyword_boost`, STEP BY STEP
=======================================================================

Suppose you want an agent that extracts salient keywords and boosts
BM25-matched docs that contain them.

1.  **Pick a base class** by dependency:

    =================  ===========================  =====================
    base               you get                      for
    =================  ===========================  =====================
    BaseAgent          lifecycle only               pure/rule-based logic
    LLMAgent           self._chat / self._chat_json prompted steps
    RetrievalAgent     self._embed / self._retrieve store-touching steps
                       self.device_stage
    =================  ===========================  =====================

    Heavy numeric work does not go in the agent's Python loop: call the
    store and model surfaces, or write a small tensor function on the
    agent's device (TemplateDeviceOpAgent below). A hot path that needs
    its own kernel gets one in `csrc/` behind `ops/cuda_kernels.py`, with a
    plain PyTorch version that the CPU runs and the card is held against.

2.  **Config.** Add a frozen dataclass section to config.py and to
    AppConfig::

        @dataclass(frozen=True)
        class KeywordBoostConfig:
            enabled: bool = True
            max_keywords: int = 5

    `config_from_dict` parses it, and the environment overrides it
    (`RADIANT_KEYWORD_BOOST_MAX_KEYWORDS=3`). A field the code does not
    read yet goes into `_NOT_PORTED` with its reason, so a file that sets
    it raises instead of running another configuration.

3.  **Write the agent** (copy a template below). Contract details that
    matter:

    - `name` must be unique: it keys metrics, degradation marks and the
      registry.
    - `_execute(ctx, **kwargs)` reads inputs from the AgentContext
      (`agents/base.py`: query, effective_queries, dense/bm25/fused docs,
      extras) or kwargs, returns its output and, when later phases need
      it, writes it onto ctx (`ctx.extras[self.name] = out`).
    - LLM calls only through `self._chat` / `self._chat_json(expect=...)`:
      the client layers retries, backoff and JSON extraction / repair
      (llm/json_parser.py). Never json.loads raw model output.
    - `_chat_json` returns None when repair fails: treat None as a
      degraded result, not an exception.
    - Device calls only inside `with self.device_stage("<stage>"):`, one
      stage per stretch of device work, never around an LLM call (the
      lock would stall the server's searches for the LLM's latency).

4.  **Wire it into the orchestrator** (orchestrator.py): construct it in
    `__init__` next to its peers (passing `device_stages=stages` to a
    RetrievalAgent), then call it inside a `metrics.track_step` block::

        with metrics.track_step("keyword_boost"):
            res = self.keyword_boost.run(ctx)
            if res.status is AgentStatus.FAILED:
                metrics.mark_degraded("keyword_boost", res.error)

    Gate it twice: statically through `pipeline.use_*` (config) and, when
    the planner should decide per query, a plan key
    (`plan.get("use_keyword_boost", True)`).

5.  **Register it** (optional)::

        from radiant_rag_tpu_torch.agents.registry import register_agent
        register_agent("keyword_boost", category="post_retrieval")(KeywordBoostAgent)

    Registration enables lookup by name for tools and diagnostics; the
    orchestrator wires explicitly either way.

6.  **Tests** (tests/test_torch_agents.py patterns). The minimum set:

    - the success path with a scripted MockLLMBackend and a small
      TpuVectorStore on `device="cpu"`;
    - failure -> fallback: make the LLM raise, assert PARTIAL and that the
      fallback value flows;
    - a failure inside a device stage raises `DeviceStageError`;
    - disabled -> run() returns SKIPPED without calling anything;
    - if the agent writes ctx: the field lands where the next phase reads
      it;
    - where the JAX package has the agent, the port's against it on equal
      inputs (tests/_torch_agentic_world.py).

=======================================================================
PITFALLS
=======================================================================

- **Host round trips.** Each `.cpu()`, `.item()` or numpy conversion of a
  card tensor waits for the card. Batch all effective queries into one
  call and fetch once, as TemplateRetrievalAgent does.
- **Devices.** Put tensors on the agent's device
  (`self.local_models.device`), never on a hard-coded "cuda": the tests
  run every agent on the CPU.
- **ctx is shared, not yours.** Namespace anything you stash:
  `ctx.extras["keyword_boost"]`, never `ctx.extras["keywords"]`.
- **_on_error must be cheap and must not raise** unless you mean FAILED:
  a second LLM call inside _on_error multiplies tail latency exactly when
  the backend already struggles. It is never called for a card failure.
- **Don't swallow disabled-ness**: pass `enabled=config.<section>.enabled`
  to `super().__init__`; run() handles SKIPPED uniformly and tests can
  assert it.
- **Confidence**: if your agent produces one, set `metrics.confidence`
  in `_after_execute` so it is exported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import (
    AgentCategory,
    BaseAgent,
    LLMAgent,
    RetrievalAgent,
)

# ---------------------------------------------------------------------------
# Result dataclass pattern
# ---------------------------------------------------------------------------
# Agents returning more than a scalar return a small frozen dataclass with
# to_dict() (the report and JSON surfaces). Keep it flat: nested trees make
# the report builders and the /query JSON ugly.


@dataclass(frozen=True)
class TemplateOutput:
    keywords: List[str] = field(default_factory=list)
    boosted: int = 0
    confidence: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"keywords": list(self.keywords), "boosted": self.boosted,
                "confidence": self.confidence}


# ---------------------------------------------------------------------------
# TEMPLATE 1: plain agent (BaseAgent): rule-based, no dependencies
# ---------------------------------------------------------------------------


class TemplateAgent(BaseAgent):
    """Pure-logic agent: reads ctx, computes, writes back, returns.

    Use for: heuristics, routing decisions, bookkeeping phases. If you find
    yourself embedding text or scoring docs here, you want Template 3 or 4.
    """

    name = "template"
    category = AgentCategory.UTILITY

    def __init__(self, max_keywords: int = 5, enabled: bool = True) -> None:
        # config flows through the constructor; the agent never reads
        # AppConfig directly (keeps agents reusable outside the app facade)
        super().__init__(enabled=enabled)
        self.max_keywords = max_keywords

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> TemplateOutput:
        # naive keyword heuristic: the longest unique terms of the query
        words = sorted({w.lower().strip("?,.") for w in ctx.query.split()},
                       key=len, reverse=True)
        out = TemplateOutput(keywords=words[: self.max_keywords],
                             confidence=0.5 if words else 0.0)
        ctx.extras[self.name] = out.to_dict()  # visible to later phases
        return out

    def _after_execute(self, ctx: AgentContext, result: TemplateOutput,
                       **kwargs: Any) -> TemplateOutput:
        # hook: post-process / validate; also the place to attach confidence
        return result

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> TemplateOutput:
        # fallback -> PARTIAL; the pipeline proceeds with empty keywords
        return TemplateOutput()


# ---------------------------------------------------------------------------
# TEMPLATE 2: LLM agent (LLMAgent): structured JSON contract
# ---------------------------------------------------------------------------


class TemplateLLMAgent(LLMAgent):
    """Prompted agent with a strict JSON output contract.

    The pattern every LLM agent of the pipeline follows (planning.py,
    critic.py, fact_verification.py): one instruction, the smallest
    possible JSON schema spelled out literally in the prompt, `_chat_json`
    with `expect=` for shape validation, and a None-tolerant unpack.
    """

    name = "template_llm"
    category = AgentCategory.QUERY_PROCESSING

    def __init__(self, llm, max_keywords: int = 3, enabled: bool = True) -> None:
        super().__init__(llm, enabled=enabled)
        self.max_keywords = max_keywords

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[str]:
        arr = self._chat_json([{
            "role": "user",
            "content": (
                "Extract the most salient search keywords from the query.\n"
                f'Reply ONLY a JSON array of at most {self.max_keywords} '
                'strings, e.g. ["laser", "coherence"].\n\n'
                f"Query: {ctx.query}"
            ),
        }], expect=list)
        if not arr:  # _chat_json returns None when extraction / repair failed
            return []
        return [str(x) for x in arr][: self.max_keywords]

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[str]:
        # LLM down -> degrade to the rule-based extraction instead of dying
        words = sorted({w.lower().strip("?,.") for w in ctx.query.split()},
                       key=len, reverse=True)
        return words[: self.max_keywords]


# ---------------------------------------------------------------------------
# TEMPLATE 3: retrieval agent (RetrievalAgent): store + embedder
# ---------------------------------------------------------------------------


class TemplateRetrievalAgent(RetrievalAgent):
    """Store-backed agent: embed on the device, retrieve, post-filter.

    `self._embed_batch` runs the embedder on the models' device and
    `store.retrieve_by_embedding_batch` the store's two-stage search, both
    in one device stage: one lock acquisition, one host fetch per batch.
    """

    name = "template_retrieval"
    category = AgentCategory.RETRIEVAL

    def __init__(self, store, local_models, min_similarity: float = 0.0,
                 doc_level: Optional[str] = "leaf", enabled: bool = True,
                 device_stages=None) -> None:
        super().__init__(store, local_models, enabled=enabled, device_stages=device_stages)
        self.min_similarity = min_similarity
        self.doc_level = doc_level

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[DocScore]:
        top_k = int(kwargs.get("top_k", 5))
        # all effective queries in ONE device call: a loop per query pays the
        # launch and fetch cost per query
        queries = ctx.effective_queries or [ctx.query]
        with self.device_stage("template retrieval"):
            embs = self._embed_batch(queries)
            batches = self.store.retrieve_by_embedding_batch(
                embs, top_k=top_k, min_similarity=self.min_similarity,
                doc_level_filter=self.doc_level)
        seen: Dict[str, DocScore] = {}
        for hits in batches:
            for doc, score in hits:
                prev = seen.get(doc.doc_id)
                if prev is None or score > prev[1]:
                    seen[doc.doc_id] = (doc, score)
        out = sorted(seen.values(), key=lambda ds: -ds[1])[:top_k]
        ctx.dense_docs = out  # the conventional landing field for dense hits
        return out

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[DocScore]:
        return []  # retrieval degraded (not the card) -> other legs still feed fusion


# ---------------------------------------------------------------------------
# TEMPLATE 4: device-op agent: a small tensor function on the agent's device
# ---------------------------------------------------------------------------
# When an agent needs numeric work that is neither embedding nor store
# retrieval, write a module-level function over tensors and call it from
# _execute inside a device stage. It runs wherever its inputs live: the
# card in production, the CPU in the tests. Kernels of the hot path live in
# csrc/ behind ops/cuda_kernels.py; a function like this is for small glue
# math that would otherwise be a Python loop over docs.


def _mmr_select(doc_vecs: torch.Tensor, query_vec: torch.Tensor, lam: float,
                k: int) -> torch.Tensor:
    """Maximal marginal relevance over (n, d) float32 candidate vectors: k
    greedy steps on their device, each picking the first maximum of
    lam * relevance - (1 - lam) * (max similarity to the picks so far),
    the picks masked out. Returns the (k,) picked indices (int64)."""
    n = doc_vecs.shape[0]
    lam_t = torch.tensor(lam, dtype=torch.float32, device=doc_vecs.device)
    rel = doc_vecs @ query_vec  # (n,)
    chosen = torch.zeros(n, dtype=torch.bool, device=doc_vecs.device)
    max_sim = torch.full((n,), float("-inf"), dtype=torch.float32, device=doc_vecs.device)
    picks = []
    for _ in range(k):
        mmr = lam_t * rel - (1.0 - lam_t) * max_sim
        mmr = mmr.masked_fill(chosen, float("-inf"))
        idx = torch.argmax(mmr)  # the first maximum, as jnp.argmax takes
        picks.append(idx)
        chosen[idx] = True
        max_sim = torch.maximum(max_sim, doc_vecs @ doc_vecs[idx])
    return torch.stack(picks)


class TemplateDeviceOpAgent(RetrievalAgent):
    """Diversity re-selection (MMR) by an agent-owned tensor function on
    the models' device. The embed and the selection are one device stage:
    a failure there raises; `_on_error`'s input-order fallback serves only
    failures off the card."""

    name = "template_device_op"
    category = AgentCategory.POST_RETRIEVAL

    def __init__(self, store, local_models, lam: float = 0.7,
                 enabled: bool = True, device_stages=None) -> None:
        super().__init__(store, local_models, enabled=enabled, device_stages=device_stages)
        self.lam = lam

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[DocScore]:
        docs = ctx.fused_docs or ctx.dense_docs
        k = min(int(kwargs.get("top_k", 5)), len(docs))
        if k <= 1:
            return docs[:k]
        texts = [d.content for d, _ in docs]
        device = self.local_models.device
        with self.device_stage("mmr selection"):
            vecs = np.asarray(self._embed_batch(texts), np.float32)
            qv = np.asarray(self._embed(ctx.query), np.float32)
            picks = _mmr_select(torch.from_numpy(vecs).to(device),
                                torch.from_numpy(qv).to(device), self.lam, k).cpu()
        return [docs[int(i)] for i in picks]

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[DocScore]:
        docs = ctx.fused_docs or ctx.dense_docs
        return docs[: int(kwargs.get("top_k", 5))]  # fall back to input order
