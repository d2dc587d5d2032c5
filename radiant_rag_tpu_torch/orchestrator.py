"""RAGOrchestrator: the multi-agent query pipeline control loop.

The port's counterpart of `radiant_rag_tpu/orchestrator.py`: the
language phase (detection and translation to the canonical language when
`language.enabled`), the nine phases of `run` with the critic-retry loop,
web search (fused into the retrieval when the plan asks for it, served
alone when the retrieval found nothing), the simple-query fast path,
targeted retry ("context" re-retrieves with a mutated plan, "answer" only
regenerates), the low-confidence answer, strategy-memory outcomes, fact
verification and citation in a 2-worker pool, per-phase `RunMetrics`
with degradation marks, and the Prometheus / OpenTelemetry exporter
(`metrics.*`, handed to `BaseAgent.metrics_sink`). Hybrid retrieval is
the fused `HybridSearcher` over the store's engine and the BM25 index: all
effective queries embedded on the card (`embed_queries_device`) and
searched in one `search_rows`.
Over a sharded pod store it is the store's `search_hybrid`; the searcher is
then built over the store's single-device source engine only to calibrate
the fusion, whose mode and weights `set_fusion` carries to the pod (and the
rerank auto-disable probes do not run).

Two deviations from the JAX package, both so that a broken card cannot
hide behind a degraded answer:
  * every device call of the pipeline runs inside `DeviceStages`
    (`agents/base_agent.py`): under the device lock the server's searches
    take, one stage at a time (never across an LLM call), with a failure
    raised out of `run` as a `DeviceStageError`;
  * the fusion and rerank calibrations raise where the JAX methods log and
    serve equal weights or leave the stage unchanged.
LLM failures (`LLMError`, JSON that does not parse) degrade as there: a
translation that fails marks the run degraded with "language" and goes on
with the query as asked. As in the JAX package, web search needs a crawler
given to the constructor; without one it answers with the warning "web
search unavailable: no crawler configured" and fetches nothing.
"""

from __future__ import annotations

import logging
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from radiant_rag_tpu_torch.agents.automerge import HierarchicalAutoMergingAgent
from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore, new_agent_context
from radiant_rag_tpu_torch.agents.base_agent import BaseAgent, DeviceStages
from radiant_rag_tpu_torch.agents.citation import CitationTrackingAgent
from radiant_rag_tpu_torch.agents.context_eval import ContextEvaluationAgent
from radiant_rag_tpu_torch.agents.critic import CriticAgent
from radiant_rag_tpu_torch.agents.fact_verification import FactVerificationAgent
from radiant_rag_tpu_torch.agents.fusion import RRFAgent
from radiant_rag_tpu_torch.agents.language import LanguageDetectionAgent, TranslationAgent
from radiant_rag_tpu_torch.agents.multihop import MultiHopReasoningAgent
from radiant_rag_tpu_torch.agents.planning import PLAN_DEFAULTS, PlanningAgent
from radiant_rag_tpu_torch.agents.query_processing import (
    QueryDecompositionAgent, QueryExpansionAgent, QueryRewriteAgent,
)
from radiant_rag_tpu_torch.agents.rerank import CrossEncoderRerankingAgent
from radiant_rag_tpu_torch.agents.retrieval import (
    BM25RetrievalAgent, DenseRetrievalAgent, dedup_best_score,
)
from radiant_rag_tpu_torch.agents.strategy_memory import RetrievalStrategyMemory
from radiant_rag_tpu_torch.agents.summarization import SummarizationAgent
from radiant_rag_tpu_torch.agents.synthesis import AnswerSynthesisAgent
from radiant_rag_tpu_torch.agents.tools import ToolSelector, create_default_tool_registry
from radiant_rag_tpu_torch.agents.web_search import WebSearchAgent
from radiant_rag_tpu_torch.config import AppConfig
from radiant_rag_tpu_torch.index.hybrid import (
    HybridSearcher, check_bm25_rescore_limits, embed_queries_device, resolve_fused_depth,
)
from radiant_rag_tpu_torch.utils.metrics import RunMetrics
from radiant_rag_tpu_torch.utils.metrics_export import UnifiedMetrics, guarded

logger = logging.getLogger(__name__)

LOW_CONFIDENCE_RESPONSE = (
    "I don't have enough reliable information in the indexed documents to "
    "answer this question confidently. The retrieved context either doesn't "
    "cover the topic or doesn't support a grounded answer."
)


@dataclass
class PipelineResult:
    """Everything a run produced."""

    query: str
    answer: str
    success: bool = True
    run_id: str = ""
    docs: List[DocScore] = field(default_factory=list)
    plan: Dict[str, Any] = field(default_factory=dict)
    effective_queries: List[str] = field(default_factory=list)
    dense_docs: List[DocScore] = field(default_factory=list)
    bm25_docs: List[DocScore] = field(default_factory=list)
    web_docs: List[DocScore] = field(default_factory=list)
    fused_docs: List[DocScore] = field(default_factory=list)
    reranked_docs: List[DocScore] = field(default_factory=list)
    confidence: float = 0.0
    low_confidence: bool = False
    critic_notes: List[str] = field(default_factory=list)
    retry_count: int = 0
    fact_verification: Dict[str, Any] = field(default_factory=dict)
    citations: Dict[str, Any] = field(default_factory=dict)
    language: Dict[str, Any] = field(default_factory=dict)
    tool_results: List[Dict[str, Any]] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    degraded: Dict[str, str] = field(default_factory=dict)
    metrics: Dict[str, Any] = field(default_factory=dict)
    conversation_id: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "query": self.query,
            "answer": self.answer,
            "success": self.success,
            "run_id": self.run_id,
            "confidence": self.confidence,
            "low_confidence": self.low_confidence,
            "retry_count": self.retry_count,
            "plan": dict(self.plan),
            "effective_queries": list(self.effective_queries),
            "num_docs": len(self.docs),
            "warnings": list(self.warnings),
            "degraded": dict(self.degraded),
            "fact_verification": dict(self.fact_verification),
            "citations": dict(self.citations),
            "metrics": self.metrics,
        }


class RAGOrchestrator:
    def __init__(self, config: AppConfig, store, bm25_index, local_models, llm,
                 conversation_manager=None, web_crawler=None, metrics_collector=None,
                 metrics_exporter=None, device_lock=None) -> None:
        self.config = config
        self.store = store
        self.bm25_index = bm25_index
        self.local_models = local_models
        self.llm = llm
        self.conversation_manager = conversation_manager
        self.metrics_collector = metrics_collector
        cfg = config
        if metrics_exporter is None and (cfg.metrics.prometheus_enabled
                                         or cfg.metrics.otel_enabled):
            # raises ImportError naming the package an enabled exporter lacks
            metrics_exporter = UnifiedMetrics.create(
                prometheus_enabled=cfg.metrics.prometheus_enabled,
                prometheus_port=cfg.metrics.prometheus_port,
                otel_enabled=cfg.metrics.otel_enabled,
                otel_endpoint=cfg.metrics.otel_endpoint,
            )
        self.metrics_exporter = metrics_exporter
        if metrics_exporter is not None:
            BaseAgent.metrics_sink = metrics_exporter
        # every device call of a run: under device_lock (the app's, which
        # the server's searches share), failures raised (module doc)
        self.device_stage = DeviceStages(device_lock)

        # the fused device retrieval path, over the store's engine; a store
        # without one (the numpy backend) retrieves leg by leg. Over a pod
        # store the searcher is built on the source engine (the same rows)
        # to calibrate the fusion, and does not serve (module doc)
        self._hybrid = None
        self._hybrid_serves = False
        engine = self._store_engine()
        if engine is not None and hasattr(bm25_index, "index"):
            check_bm25_rescore_limits(cfg, engine.device)
            self._hybrid = HybridSearcher(engine, bm25_index._index)
            self._hybrid_serves = hasattr(store, "engine")
            # every search_rows through this searcher (serving, the agentic
            # path, warmup, calibration) fuses at retrieval.fused_depth
            self._hybrid.default_fused_depth = resolve_fused_depth(cfg.retrieval)

        self.strategy_memory = (
            RetrievalStrategyMemory(cfg.strategy_memory.path, cfg.strategy_memory.decay)
            if cfg.strategy_memory.enabled else None
        )
        p = cfg.pipeline
        stages = self.device_stage
        self.planning = PlanningAgent(
            llm, strategy_memory=self.strategy_memory, enabled=p.use_planning,
            memory_min_confidence=cfg.strategy_memory.min_confidence)
        self.decomposition = QueryDecompositionAgent(
            llm, max_queries=cfg.query.max_decomposed_queries, enabled=p.use_decomposition)
        self.rewrite = QueryRewriteAgent(llm, enabled=p.use_rewrite)
        self.expansion = QueryExpansionAgent(
            llm, max_expansions=cfg.query.max_expansions, enabled=p.use_expansion)
        self.dense = DenseRetrievalAgent(
            store, local_models, top_k=cfg.retrieval.dense_top_k,
            min_similarity=cfg.retrieval.min_similarity,
            search_scope=cfg.retrieval.search_scope, device_stages=stages)
        self.bm25 = BM25RetrievalAgent(bm25_index, top_k=cfg.retrieval.bm25_top_k,
                                       device_stages=stages)
        self.web_search = WebSearchAgent(
            llm, crawler=web_crawler, max_urls=cfg.web_search.max_urls,
            cache_ttl_s=cfg.web_search.cache_ttl_s,
            blocked_domains=cfg.web_search.blocked_domains,
            trigger_keywords=cfg.web_search.trigger_keywords,
            enabled=p.use_web_search)
        self.fusion = RRFAgent(rrf_k=cfg.retrieval.rrf_k, top_k=cfg.retrieval.fused_top_k,
                               enabled=p.use_rrf)
        self.automerge = HierarchicalAutoMergingAgent(
            store, min_children_to_merge=cfg.automerge.min_children_to_merge,
            max_parent_chars=cfg.automerge.max_parent_chars,
            enabled=p.use_automerge and cfg.automerge.enabled)
        self.rerank = CrossEncoderRerankingAgent(
            local_models, top_k=cfg.rerank.top_k,
            candidate_multiplier=cfg.rerank.candidate_multiplier,
            min_candidates=cfg.rerank.min_candidates,
            max_chars=cfg.rerank.max_chars,
            enabled=p.use_rerank and cfg.rerank.enabled,
            prior_weight=cfg.rerank.prior_weight, device_stages=stages)
        # measured CE auto-disable state (`_ensure_rerank_calibration`):
        # corpus size at the last probe run (-1 = never) + the probe verdict
        self._rerank_calibrated_at = -1
        self.rerank_calibration: Dict[str, Any] = {}
        self.synthesis = AnswerSynthesisAgent(
            llm, max_context_docs=cfg.synthesis.max_context_docs,
            max_chars_per_doc=cfg.synthesis.max_chars_per_doc,
            include_history=cfg.synthesis.include_conversation_history)
        self.critic = CriticAgent(
            llm, max_chars_per_doc=cfg.critic.max_chars_per_doc,
            max_docs=cfg.critic.max_docs,
            confidence_threshold=cfg.agentic.confidence_threshold,
            give_up_confidence=cfg.agentic.give_up_confidence,
            enabled=p.use_critic)
        self.context_eval = ContextEvaluationAgent(
            llm=llm, use_llm=cfg.context_eval.use_llm,
            min_mean_score=cfg.context_eval.min_mean_score,
            min_docs=cfg.context_eval.min_docs,
            enabled=p.use_context_eval and cfg.context_eval.enabled)
        self.summarization = SummarizationAgent(
            llm, local_models=local_models,
            max_total_context_chars=cfg.summarization.max_total_context_chars,
            max_doc_chars=cfg.summarization.max_doc_chars,
            dedup_similarity=cfg.summarization.dedup_similarity,
            keep_recent_turns=cfg.summarization.keep_recent_turns,
            enabled=p.use_summarization, device_stages=stages)
        self.multihop = MultiHopReasoningAgent(
            llm, store, local_models, max_hops=cfg.multihop.max_hops,
            docs_per_hop=cfg.multihop.docs_per_hop,
            min_hop_confidence=cfg.multihop.min_hop_confidence,
            enabled=p.use_multihop and cfg.multihop.enabled, device_stages=stages)
        self.fact_verifier = FactVerificationAgent(
            llm, max_claims=cfg.fact_verification.max_claims,
            correct_answer=cfg.fact_verification.correct_answer) \
            if p.use_fact_verification and cfg.fact_verification.enabled else None
        self.citation = CitationTrackingAgent(
            llm, style=cfg.citation.style,
            min_confidence=cfg.citation.min_confidence,
            include_bibliography=cfg.citation.include_bibliography) \
            if p.use_citation and cfg.citation.enabled else None
        self.language_detector = LanguageDetectionAgent(
            llm=llm, min_confidence=cfg.language.min_confidence) \
            if cfg.language.enabled else None
        self.translator = TranslationAgent(
            llm, canonical_language=cfg.language.canonical_language,
            max_chars_per_llm_call=cfg.language.max_chars_per_llm_call) \
            if cfg.language.enabled else None
        self.tool_registry = create_default_tool_registry(cfg.tools.allow_code_execution) \
            if p.use_tools and cfg.tools.enabled else None
        self.tool_selector = ToolSelector(llm, self.tool_registry) if self.tool_registry else None

    # ------------------------------------------------------------------
    @staticmethod
    def _is_simple_query(query: str) -> bool:
        """Fast-path heuristic: short wh-questions and short queries without
        conjunctions skip decomposition, expansion and multihop."""
        words = query.strip().split()
        if len(words) <= 5:
            return True
        wh = ("what", "who", "when", "where", "which", "how", "is", "are", "does", "do")
        if len(words) <= 10 and words[0].lower() in wh:
            conjunctions = {"and", "or", "but", "also", "plus", "versus", "vs"}
            return not any(w.lower().strip(",.?") in conjunctions for w in words)
        return False

    # ------------------------------------------------------------------
    def run(self, query: str, conversation_id: str = "",
            conversation_history: Optional[List[Dict[str, str]]] = None,
            progress: Optional[Any] = None,
            token_sink: Optional[Any] = None) -> PipelineResult:
        """`progress(event, step_name, info)`: an optional live observer
        called at every phase boundary; `token_sink(chunk)`: an optional
        live generation-token callback (both drive /query/stream). The run
        holds the exporter's active-runs gauge."""
        exporter = self.metrics_exporter
        with guarded(None if exporter is None else exporter.track_run):
            return self._run(query, conversation_id, conversation_history, progress,
                             token_sink)

    def _run(self, query: str, conversation_id: str,
             conversation_history: Optional[List[Dict[str, str]]],
             progress: Optional[Any], token_sink: Optional[Any]) -> PipelineResult:
        ctx = new_agent_context(query)
        if token_sink is not None:
            ctx.extras["token_sink"] = token_sink
        if conversation_history:
            # compress long histories, keeping recent turns verbatim
            keep = self.config.summarization.keep_recent_turns
            if self.summarization.enabled and len(conversation_history) > 2 * keep:
                try:
                    conversation_history = self.summarization.compress_conversation(
                        conversation_history)
                except Exception:  # an LLM call: degrades to the full history
                    pass
            ctx.conversation_history = conversation_history
        metrics = RunMetrics(run_id=ctx.run_id)
        metrics.observer = progress
        result = PipelineResult(query=query, answer="", run_id=ctx.run_id,
                                conversation_id=conversation_id)
        cfg = self.config

        # Phase 0: language (host and LLM work; a failed translation runs on
        # with the query as asked)
        if self.language_detector is not None and self.translator is not None:
            with metrics.track_step("language"):
                try:
                    info = self.translator.translate_with_detection(query, self.language_detector)
                    ctx.language = {"source_language": info["source_language"],
                                    "translated": info["translated"],
                                    "confidence": info["confidence"]}
                    if info["translated"]:
                        ctx.query = info["text"]
                except Exception as exc:  # an LLM call: degrades as in the JAX package
                    metrics.mark_degraded("language", str(exc))

        simple = self._is_simple_query(ctx.query)

        # Phase 1: planning
        with metrics.track_step("planning", simple=simple):
            plan_res = self.planning.run(ctx)
            if not plan_res.success or plan_res.status.value == "skipped":
                ctx.plan = dict(PLAN_DEFAULTS)
                ctx.retrieval_mode = ctx.plan["retrieval_mode"]
            if plan_res.status.value == "partial":
                metrics.mark_degraded("planning", plan_res.error)
            if simple:  # the fast path turns the heavy query processing off
                ctx.plan["use_decomposition"] = False
                ctx.plan["use_expansion"] = False
                ctx.plan["use_multihop"] = False
        result.plan = dict(ctx.plan)

        # Phase 2: tools
        if self.tool_selector is not None and ctx.plan.get("tools_to_use") is not None:
            with metrics.track_step("tools"):
                try:
                    planned = [{"tool": t, "input": self._tool_input(t, ctx.query)}
                               for t in ctx.plan.get("tools_to_use", [])]
                    if not planned and not simple:
                        planned = self.tool_selector.select(ctx.query)
                    for item in planned[:3]:
                        tr = self.tool_registry.run(item["tool"], item["input"])
                        if tr.success:
                            ctx.tool_results.append(tr.to_dict())
                except Exception as exc:
                    metrics.mark_degraded("tools", str(exc))
        result.tool_results = list(ctx.tool_results)

        # Retry loop (phases 3-7)
        critique: Dict[str, Any] = {}
        retrieval_cached = False
        for attempt in range(cfg.agentic.max_critic_retries + 1):
            is_retry = attempt > 0
            if not is_retry or not retrieval_cached:
                # Phase 3: query processing
                with metrics.track_step("query_processing", attempt=attempt):
                    self._run_query_processing(ctx, metrics)
                # Phase 4: retrieval
                with metrics.track_step("retrieval", attempt=attempt,
                                        mode=ctx.retrieval_mode):
                    self._run_retrieval(ctx, metrics)
                # Phase 4.5: multihop
                if ctx.plan.get("use_multihop") and self.multihop.enabled:
                    with metrics.track_step("multihop"):
                        # the planner asked for multihop: skip the agent's
                        # own indicator check
                        mh = self.multihop.run(ctx, force=True)
                        if mh.success and mh.data and mh.data.get("used"):
                            extra = [(d, 0.7) for d, _s in mh.data.get("docs", [])]
                            ctx.fused_docs = dedup_best_score(ctx.fused_docs + extra)
                # Phase 5: post-retrieval
                with metrics.track_step("post_retrieval"):
                    self._run_post_retrieval(ctx, metrics)
                ctx.confidences["retrieval_quality"] = \
                    self.critic.evaluate_retrieval_quality(ctx.context_docs)
                retrieval_cached = True

            # Phase 5.5: context evaluation (pre-generation gate)
            if self.context_eval.enabled:
                with metrics.track_step("context_eval"):
                    ev_res = self.context_eval.run(ctx)
                    if ev_res.success and ev_res.data is not None:
                        ev = ev_res.data
                        exhausted_and_empty = (not ev.sufficient
                                               and attempt >= cfg.agentic.max_critic_retries
                                               and not ctx.context_docs)
                        if ev.recommendation == "abort" or exhausted_and_empty:
                            result.answer = LOW_CONFIDENCE_RESPONSE
                            result.low_confidence = True
                            result.confidence = ev.confidence
                            break
                        if ev.recommendation in ("expand_retrieval", "rewrite_query") \
                                and attempt < cfg.agentic.max_critic_retries:
                            ctx.plan["use_expansion"] = True
                            if ev.recommendation == "rewrite_query":
                                self.planning.plan_retry(ctx, {"issues": ["rewrite_query"]})
                            retrieval_cached = False
                            ctx.retry_history.append({"attempt": attempt,
                                                      "reason": ev.recommendation})
                            continue

            # Phase 5.6: summarization / context compression
            if self.summarization.enabled:
                with metrics.track_step("summarization"):
                    sum_res = self.summarization.run(ctx)
                    if sum_res.success and sum_res.data:
                        # compressed docs replace the best available stage
                        if ctx.reranked_docs:
                            ctx.reranked_docs = sum_res.data
                        else:
                            ctx.fused_docs = sum_res.data

            # Phase 6: generation
            with metrics.track_step("generation", attempt=attempt):
                gen_res = self.synthesis.run(ctx)
                if not gen_res.success:
                    metrics.mark_degraded("generation", gen_res.error)
                    result.answer = LOW_CONFIDENCE_RESPONSE
                    result.low_confidence = True
                    result.success = False
                    break
                result.answer = ctx.final_answer

            # Phase 7: critique
            if not self.critic.enabled or not ctx.plan.get("use_critic", True):
                result.confidence = 0.7
                break
            with metrics.track_step("critique", attempt=attempt):
                crit_res = self.critic.run(ctx)
                critique = crit_res.data if crit_res.success and crit_res.data else {}
            result.confidence = critique.get("confidence", 0.5)
            result.critic_notes = list(ctx.critic_notes)

            if not critique.get("should_retry") or attempt >= cfg.agentic.max_critic_retries:
                if self.critic.should_give_up(critique, attempt, cfg.agentic.max_critic_retries):
                    result.answer = LOW_CONFIDENCE_RESPONSE
                    result.low_confidence = True
                break
            # context issues re-retrieve with a mutated plan; answer issues
            # regenerate
            issue = critique.get("issue_type", "answer")
            ctx.retry_history.append({"attempt": attempt, "issue_type": issue,
                                      "confidence": result.confidence})
            result.retry_count = attempt + 1
            if issue == "context":
                self.planning.plan_retry(ctx, critique)
                retrieval_cached = False

        # Phase 7.5: strategy memory
        if self.strategy_memory is not None:
            with metrics.track_step("strategy_memory"):
                try:
                    self.strategy_memory.record_outcome(
                        query, ctx.retrieval_mode,
                        success=not result.low_confidence,
                        confidence=result.confidence)
                except Exception as exc:
                    metrics.mark_degraded("strategy_memory", str(exc))

        # Phases 8/9: fact verification || citation (LLM calls only)
        docs_for_verification = ctx.context_docs
        if result.answer and not result.low_confidence and docs_for_verification:
            with metrics.track_step("verification_and_citation"):
                with ThreadPoolExecutor(max_workers=2) as pool:
                    fv_future = pool.submit(self._run_fact_verification, ctx, result) \
                        if self.fact_verifier else None
                    cite_future = pool.submit(self._run_citation, ctx, result) \
                        if self.citation else None
                    if fv_future is not None:
                        try:
                            fv_future.result()
                        except Exception as exc:
                            metrics.mark_degraded("fact_verification", str(exc))
                    if cite_future is not None:
                        try:
                            cite_future.result()
                        except Exception as exc:
                            metrics.mark_degraded("citation", str(exc))

        # conversation turn
        if self.conversation_manager is not None and conversation_id:
            try:
                self.conversation_manager.add_turn(conversation_id, query, result.answer)
            except Exception as exc:
                metrics.mark_degraded("conversation", str(exc))

        # finalize
        result.effective_queries = list(ctx.effective_queries)
        result.dense_docs = ctx.dense_docs
        result.bm25_docs = ctx.bm25_docs
        result.web_docs = ctx.web_docs
        result.fused_docs = ctx.fused_docs
        result.reranked_docs = ctx.reranked_docs
        result.docs = ctx.context_docs
        result.language = dict(ctx.language)
        result.warnings = list(ctx.warnings)
        result.degraded = dict(metrics.degraded)
        result.metrics = metrics.to_dict()
        if self.metrics_collector is not None:
            self.metrics_collector.record(metrics)
        return result

    @staticmethod
    def _tool_input(tool: str, query: str) -> str:
        """A tool's input from the query (calculator: the longest
        arithmetic-looking span)."""
        if tool == "calculator":
            spans = re.findall(r"[\d\.\s\+\-\*\/\(\)%]+", query)
            spans = [s.strip() for s in spans if any(c.isdigit() for c in s)]
            if spans:
                return max(spans, key=len)
        return query

    # ------------------------------------------------------------------
    def _run_query_processing(self, ctx: AgentContext, metrics: RunMetrics) -> None:
        queries = [ctx.query]
        if ctx.plan.get("use_decomposition") and self.decomposition.enabled:
            res = self.decomposition.run(ctx)
            if res.success and res.data:
                queries = list(res.data)
        if ctx.plan.get("use_rewrite") and self.rewrite.enabled:
            res = self.rewrite.run(ctx, queries=queries)
            if res.success and res.data:
                queries = [res.data.get(q, q) for q in queries]
            elif not res.success:
                metrics.mark_degraded("rewrite", res.error)
        if ctx.plan.get("use_expansion") and self.expansion.enabled:
            res = self.expansion.run(ctx, queries=queries)
            if res.success and res.data:
                queries = queries + list(res.data)
        ctx.effective_queries = queries[:8]

    def _run_retrieval(self, ctx: AgentContext, metrics: RunMetrics) -> None:
        mode = ctx.retrieval_mode
        queries = ctx.effective_queries or [ctx.query]
        if mode == "hybrid" and self._hybrid is not None and self._hybrid_serves:
            self._run_hybrid_fused(ctx, queries)
        elif mode == "hybrid" and getattr(self.store, "can_hybrid", False):
            self._run_hybrid_pod(ctx, queries)
        else:
            if mode in ("hybrid", "dense"):
                res = self.dense.run(ctx, queries=queries)
                if not res.success:
                    metrics.mark_degraded("dense_retrieval", res.error)
            if mode in ("hybrid", "bm25"):
                res = self.bm25.run(ctx, queries=queries)
                if not res.success:
                    metrics.mark_degraded("bm25_retrieval", res.error)
            runs = [r for r in (ctx.dense_docs, ctx.bm25_docs) if r]
            if ctx.plan.get("use_rrf", True) and len(runs) > 1 and self.fusion.enabled:
                self.fusion.run(ctx, runs=runs)
            else:
                ctx.fused_docs = dedup_best_score([h for r in runs for h in r])[
                    : self.config.retrieval.fused_top_k]

        # web search (host fetches and LLM calls): served alone when the
        # retrieval found nothing, fused with it when the plan asks
        if not ctx.fused_docs and self.web_search.enabled:
            res = self.web_search.run(ctx, force=True)
            if res.success and res.data:
                ctx.fused_docs = list(res.data)[: self.config.retrieval.fused_top_k]
        elif ctx.plan.get("use_web_search") and self.web_search.enabled:
            res = self.web_search.run(ctx)
            if res.success and res.data:
                ctx.fused_docs = self.fusion.fuse(
                    [ctx.fused_docs, res.data],
                    top_k=self.config.retrieval.fused_top_k)

    def invalidate_fusion_calibration(self) -> None:
        """Re-calibrate the leg weights on the next query. Call after
        anything that changes a leg's quality out of band of corpus growth
        (an embedder hot-swap, a BM25 analyzer change). The rerank verdict
        is re-earned too: it was priced against the old fused order."""
        if self._hybrid is not None:
            self._hybrid.invalidate_calibration()
        self._rerank_calibrated_at = -1
        if self.rerank_calibration.get("auto_disabled") and \
                self.config.pipeline.use_rerank and self.config.rerank.enabled:
            self.rerank.enabled = True  # re-measure before trusting the off

    def _ensure_rerank_calibration(self) -> None:
        """Measured CE auto-disable: price the rerank stage against the fused
        order it consumes, on the live corpus. Self-retrieval probes (ICT
        spans + synonym paraphrases, the fusion calibrator's probe family)
        are answered by the fused hybrid at the rerank candidate depth; the
        CE blend reranks them and both orders are scored by probe-target
        MRR. A stage that cannot beat its own input by
        rerank.auto_disable_min_gain is switched off for the session. Runs
        again after > 20% corpus growth or invalidate_fusion_calibration().
        Corpora under 8x the probe count skip the check. A failure raises
        (module doc)."""
        rcfg = self.config.rerank
        n_probes = int(rcfg.auto_disable_probes)
        if n_probes <= 0 or self._hybrid is None or not self._hybrid_serves:
            return
        if not (self.rerank.enabled or self.rerank_calibration.get("auto_disabled")):
            return
        count = int(self.store.count_documents())
        if self._rerank_calibrated_at >= 0 and \
                (count - self._rerank_calibrated_at) <= 0.2 * max(self._rerank_calibrated_at, 1):
            return
        if count < 8 * n_probes:
            self._rerank_calibrated_at = count
            return
        from radiant_rag_tpu_torch.parallel.data import make_paraphrase_query, make_pseudo_query

        engine = self._hybrid.engine
        rng = np.random.default_rng(17)
        rows, queries = [], []
        tries = 0
        while len(rows) < n_probes and tries < 20 * n_probes:
            tries += 1
            r = int(rng.integers(0, engine.count))
            doc = self._doc_of_row(r)
            if doc is None or not doc.content or len(doc.content.split()) < 6:
                continue
            q = (make_paraphrase_query(doc.content, rng)
                 if len(rows) % 2 else make_pseudo_query(doc.content, rng))
            if not q.strip():
                continue
            rows.append(r)
            queries.append(q)
        if len(rows) < max(4, n_probes // 2):
            self._rerank_calibrated_at = count
            return
        kc = max(self.rerank.top_k * self.rerank.candidate_multiplier,
                 self.rerank.min_candidates)
        with self.device_stage("rerank calibration probes"):
            q_embs = np.asarray(self.local_models.embed(queries), np.float32)
            res = self._hybrid.search_rows(q_embs, queries, dense_k=kc, bm25_k=kc, fused_k=kc)
        f_scores, f_rows = res["fused"]

        def rr_incoming(qi: int) -> float:
            hits = [int(x) for x in f_rows[qi] if x >= 0]
            return 1.0 / (hits.index(rows[qi]) + 1) if rows[qi] in hits else 0.0

        was_enabled = self.rerank.enabled
        self.rerank.enabled = True  # probe the stage even if it was off
        rr_in, rr_ce = [], []
        try:
            for qi in range(len(rows)):
                docs = []
                for j, r in enumerate(f_rows[qi]):
                    d = self._doc_of_row(r) if r >= 0 else None
                    if d is not None:
                        docs.append((d, float(f_scores[qi][j])))
                if not docs:
                    continue
                reranked = self.rerank.rerank(queries[qi], docs, top_k=kc)
                rr_in.append(rr_incoming(qi))
                rank = 0.0
                for pos, (d, _) in enumerate(reranked, start=1):
                    if self.store.row_of(d.doc_id) == rows[qi]:
                        rank = 1.0 / pos
                        break
                rr_ce.append(rank)
        finally:
            self.rerank.enabled = was_enabled
        if not rr_ce:
            # no probe hydrated to a doc: no evidence either way, so the
            # stage stays as it was (the JAX package disables it on a gain
            # of 0.0 here)
            self._rerank_calibrated_at = count
            return
        gain = float(np.mean(rr_ce) - np.mean(rr_in))
        min_gain = float(rcfg.auto_disable_min_gain)
        verdict = {
            "probes": len(rr_ce), "incoming_mrr": round(float(np.mean(rr_in)), 4),
            "rerank_mrr": round(float(np.mean(rr_ce)), 4),
            "gain": round(gain, 4), "min_gain": min_gain,
            "auto_disabled": gain < min_gain,
        }
        self.rerank_calibration = verdict
        self._rerank_calibrated_at = count
        if verdict["auto_disabled"]:
            self.rerank.enabled = False
            logger.warning(
                "rerank auto-disabled: CE blend adds %+.4f MRR over the fused order on %d "
                "probes (< %.3f); re-enable via rerank.auto_disable_probes=0 or retrain the "
                "cross-encoder", gain, len(rr_ce), min_gain)
        else:
            self.rerank.enabled = True
            logger.info("rerank calibration: %s", verdict)

    def _ensure_fusion_calibration(self) -> None:
        """Calibrate the per-leg fusion against the live corpus when it is
        due (never yet, or after > 20% growth; `calibrate_fusion`). Skipped
        under fusion_weighting 'equal'. A failure raises (module doc)."""
        hy = self._hybrid
        if hy is None or not hy.needs_calibration():
            return
        rcfg = self.config.retrieval
        if rcfg.fusion_weighting == "equal":
            return

        def text_of(row: int):
            doc = self._doc_of_row(row)
            return doc.content if doc is not None else None

        hy.calibrate_fusion(self.local_models.embed, text_of, n_probes=rcfg.calibration_probes,
                            paraphrase_fraction=rcfg.calibration_paraphrase_fraction,
                            seeds=rcfg.calibration_seeds)
        logger.info("fusion calibration: %s", hy.last_calibration)
        if hasattr(self.store, "set_fusion"):  # a pod store serves what the probes chose
            self.store.set_fusion(hy.fusion_mode, hy.leg_weights)

    def _store_engine(self):
        """The device engine under the store: its own, or a pod store's
        source's; None for a store without one."""
        if hasattr(self.store, "engine"):
            return self.store.engine
        return getattr(getattr(self.store, "source", None), "engine", None)

    def refresh_fused_searcher(self) -> HybridSearcher:
        """The fused searcher on the live BM25 index (load and rebuild
        replace it) and the store's engine (clear_index replaces it; the
        JAX package keeps searching the old one, ROADMAP section C),
        calibrated when due. A new engine re-earns both calibrations."""
        hy = self._hybrid
        hy.rebind_bm25(self.bm25_index.index)
        engine = self._store_engine()
        if hy.engine is not engine:
            hy.engine = engine
            self.invalidate_fusion_calibration()
        self._ensure_fusion_calibration()
        return hy

    def calibrate_pod_fusion(self) -> None:
        """The fusion calibration of a pod store: the probes run over the
        source engine (`refresh_fused_searcher`), and the selected mode and
        weights go to the pod (`_ensure_fusion_calibration`)."""
        if self._hybrid is not None:
            self.refresh_fused_searcher()

    def _run_hybrid_pod(self, ctx: AgentContext, queries: Sequence[str]) -> None:
        """Hybrid retrieval over a pod store: per-shard kernels, the legs
        merged across shards and with the delta segment, the calibrated
        fusion, then the same cross-query aggregation as the fused path."""
        cfg = self.config.retrieval
        with self.device_stage("hybrid retrieval"):
            self.calibrate_pod_fusion()
            embeddings = self.local_models.embed(list(queries))
            res = self.store.search_hybrid(
                embeddings, list(queries), top_k=max(cfg.dense_top_k, cfg.bm25_top_k),
                fused_k=cfg.fused_top_k, rrf_k=cfg.rrf_k, return_legs=True,
                fused_depth=resolve_fused_depth(cfg))
        ctx.dense_docs = dedup_best_score([h for run in res["dense"] for h in run
                                           if h[1] >= cfg.min_similarity])
        ctx.bm25_docs = dedup_best_score([h for run in res["bm25"] for h in run])
        per_query_runs = [run for run in res["fused"] if run]
        if len(per_query_runs) > 1:
            ctx.fused_docs = self.fusion.fuse(per_query_runs, top_k=cfg.fused_top_k)
        else:
            ctx.fused_docs = (per_query_runs[0] if per_query_runs else [])[: cfg.fused_top_k]

    def _run_hybrid_fused(self, ctx: AgentContext, queries: Sequence[str]) -> None:
        """Fused hybrid retrieval on the card: every effective query
        embedded on the card and searched in one search_rows, then the
        per-query fused lists aggregated across queries by RRF."""
        cfg = self.config.retrieval
        level = {"leaves": 0, "parents": 1, "all": -1}.get(cfg.search_scope, -1)
        with self.device_stage("hybrid retrieval"):
            self.refresh_fused_searcher()
            embeddings = None
            qdev = embed_queries_device(self.local_models, self._hybrid.engine, list(queries))
            if qdev is None:
                embeddings = self.local_models.embed(list(queries))
            res = self._hybrid.search_rows(
                embeddings, list(queries), _qdev=qdev,
                dense_k=cfg.dense_top_k, bm25_k=cfg.bm25_top_k,
                fused_k=cfg.fused_top_k, rrf_k=cfg.rrf_k,
                mode=self.store.default_search_mode,
                rescore_multiplier=self.config.quantization.rescore_multiplier,
                level_code=level, fusion=cfg.fusion_weighting)
        ctx.dense_docs = self._hydrate(*res["dense"], min_sim=cfg.min_similarity)
        ctx.bm25_docs = self._hydrate(*res["bm25"], min_sim=0.0)
        # cross-query rank aggregation: each effective query's fused list
        # is one RRF run, so a doc ranked well by several queries beats a
        # doc ranked first by one
        per_query_runs = [run for run in self.fused_runs(*res["fused"]) if run]
        if len(per_query_runs) > 1:
            ctx.fused_docs = self.fusion.fuse(per_query_runs, top_k=cfg.fused_top_k)
        else:
            ctx.fused_docs = (per_query_runs[0] if per_query_runs else [])[: cfg.fused_top_k]

    def _doc_of_row(self, row: int):
        doc_id = self.store.id_for_row(int(row))
        return self.store.get_doc(doc_id) if doc_id else None

    def _hydrate(self, scores: np.ndarray, rows: np.ndarray,
                 min_sim: float = -1e30) -> List[DocScore]:
        """One leg's rows of every query as docs, best score per doc."""
        hits: List[DocScore] = []
        for qi in range(rows.shape[0]):
            for s, r in zip(scores[qi], rows[qi]):
                if r < 0 or s < min_sim:
                    continue
                doc = self._doc_of_row(r)
                if doc is not None:
                    hits.append((doc, float(s)))
        return dedup_best_score(hits)

    def fused_runs(self, scores: np.ndarray, rows: np.ndarray) -> List[List[DocScore]]:
        """Each query's fused rows as a (doc, score) run, in rank order
        (serving's hits too)."""
        runs = []
        for qi in range(rows.shape[0]):
            run: List[DocScore] = []
            for s, r in zip(scores[qi], rows[qi]):
                if r < 0:
                    continue
                doc = self._doc_of_row(r)
                if doc is not None:
                    run.append((doc, float(s)))
            runs.append(run)
        return runs

    def _run_post_retrieval(self, ctx: AgentContext, metrics: RunMetrics) -> None:
        if ctx.plan.get("use_automerge", True) and self.automerge.enabled:
            res = self.automerge.run(ctx)
            if not res.success:
                metrics.mark_degraded("automerge", res.error)
        if ctx.plan.get("use_rerank", True):
            self._ensure_rerank_calibration()
        if ctx.plan.get("use_rerank", True) and self.rerank.enabled:
            res = self.rerank.run(ctx)
            if not res.success:
                metrics.mark_degraded("rerank", res.error)

    def _run_fact_verification(self, ctx: AgentContext, result: PipelineResult) -> None:
        report = self.fact_verifier.verify(result.answer, ctx.context_docs, ctx.query)
        result.fact_verification = report.to_dict()
        ctx.fact_verification = result.fact_verification
        if report.corrected_answer and \
                report.overall_score < self.config.fact_verification.min_overall_score:
            result.answer = report.corrected_answer

    def _run_citation(self, ctx: AgentContext, result: PipelineResult) -> None:
        cited = self.citation.cite(result.answer, ctx.context_docs)
        result.citations = cited.to_dict()
        ctx.citations = result.citations
        if cited.matches:
            result.answer = cited.text
            if cited.bibliography:
                result.answer += "\n" + cited.bibliography

    def get_agent_stats(self) -> List[Dict[str, Any]]:
        agents = [self.planning, self.decomposition, self.rewrite, self.expansion,
                  self.dense, self.bm25, self.web_search, self.fusion, self.automerge,
                  self.rerank, self.synthesis, self.critic, self.context_eval,
                  self.summarization, self.multihop]
        return [a.get_stats() for a in agents]


class SimplifiedOrchestrator:
    """Minimal RAG: embed -> retrieve top-k -> numbered context -> LLM. The
    embed and retrieve are one device stage (module doc)."""

    def __init__(self, store, local_models, llm, top_k: int = 5, device_lock=None) -> None:
        self.store = store
        self.local_models = local_models
        self.llm = llm
        self.top_k = top_k
        self.device_stage = DeviceStages(device_lock)

    def run(self, query: str) -> str:
        with self.device_stage("simple query retrieval"):
            emb = self.local_models.embed_single(query)
            docs = self.store.retrieve_by_embedding(emb, top_k=self.top_k)
        context = "\n\n".join(f"[{i}] {d.content[:2000]}"
                              for i, (d, _s) in enumerate(docs, start=1))
        return self.llm.chat([
            {"role": "system", "content":
                "Answer from the numbered context only. Cite like [1]."},
            {"role": "user", "content": f"Context:\n{context}\n\nQuestion: {query}"},
        ])
