"""The port's `RAGOrchestrator.run` against the JAX package's (CPU).

Whole runs over tests/_torch_agentic_world.py's stacks (equal weights, the
same documents, each package its own fresh strategy memory), driven by the
same scripted LLM. Mirrors `tests/test_orchestrator.py` and
`tests/test_degradation.py`: full run, context retry, low-confidence give
up, dense-only and BM25-only modes, tools, the simplified orchestrator,
multihop merge, cross-query rank aggregation, summarization, conversation
history, strategy memory, the empty index, and the rerank auto-disable
verdict with its opt-out.

Equal: the answer, plan, effective queries, retry count, confidence, low
confidence, citations (less the random audit id), fact verification and
degradation marks, and the doc-id order of dense_docs, bm25_docs,
fused_docs and reranked_docs; scores within tests/_torch_parity.py's rtol
1e-5 / atol 1e-6. The rerank calibration's MRRs and verdict are exactly
equal.

The deliberate difference (ROADMAP: card failures raise): a failure on the
card (the cross-encoder, the embedder, the search) raises out of the port's
`run`, where the JAX package degrades; an LLM failure degrades in both.
"""

import dataclasses
import json

import numpy as np
import pytest

from radiant_rag_tpu import config as jcfg
from radiant_rag_tpu.agents.base import new_agent_context as jax_context
from radiant_rag_tpu.llm.backends import BaseLLMBackend as JaxBackend
from radiant_rag_tpu.llm.backends import LLMError as JaxLLMError
from radiant_rag_tpu.llm.client import LLMClient as JaxClient
from radiant_rag_tpu.orchestrator import LOW_CONFIDENCE_RESPONSE as JAX_LOW
from radiant_rag_tpu.orchestrator import RAGOrchestrator as JaxOrchestrator
from radiant_rag_tpu.orchestrator import SimplifiedOrchestrator as JaxSimplified
from radiant_rag_tpu_torch import config as tcfg
from radiant_rag_tpu_torch.agents.base import new_agent_context
from radiant_rag_tpu_torch.agents.base_agent import DeviceStageError
from radiant_rag_tpu_torch.llm.backends import BaseLLMBackend, LLMError
from radiant_rag_tpu_torch.llm.client import LLMClient
from radiant_rag_tpu_torch.orchestrator import (
    LOW_CONFIDENCE_RESPONSE, RAGOrchestrator, SimplifiedOrchestrator,
)

from _torch_agentic_world import (
    BAD_CRITIQUE, BIG_DOCS, GOOD_CRITIQUE, RETRY_CRITIQUE, assert_runs_match, llms,
    make_stacks, orchestrators, plan,
)
from _torch_app_world import assert_hits_match


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    return make_stacks(tmp_path_factory.mktemp("orch"))


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """96 docs: enough for the rerank auto-disable probes at 8."""
    return make_stacks(tmp_path_factory.mktemp("big"), docs=BIG_DOCS)


# the seeded cross-encoder's logits are negative, so the heuristic context
# gate (scores clipped to [0, 1]) asks for a new retrieval on every attempt
# (test_context_gate_retries_match_jax); the other cases open it
_GATE_OPEN = {"context_eval": {"min_mean_score": -1.0}}


def run_both(stacks, question, script=None, sections=None, gate=False, **kw):
    sections = {**({} if gate else _GATE_OPEN), **(sections or {})}
    jo, to = orchestrators(stacks, script, sections)
    ref, got = jo.run(question, **kw), to.run(question, **kw)
    assert_runs_match(ref, got)
    return ref, got, (jo, to)


def test_full_pipeline_matches_jax(stacks):
    ref, got, _ = run_both(stacks, "What do mitochondria produce?")
    assert got.success and "ATP" in got.answer and got.confidence >= 0.8
    assert not got.low_confidence and got.docs and got.plan["retrieval_mode"] == "hybrid"
    assert got.citations["num_matches"] == 1 and got.fact_verification["claims"]
    steps = [s["name"] for s in got.metrics["steps"]]
    for phase in ("planning", "retrieval", "post_retrieval", "generation", "critique"):
        assert phase in steps
    assert LOW_CONFIDENCE_RESPONSE == JAX_LOW


@pytest.mark.parametrize("question", [
    "What is ATP?", "who discovered penicillin today ok", "a b c d e f",
    "What is the difference between photosynthesis and respiration, and how do both "
    "processes relate to ATP production in plant cells?",
    "How does the cell, or its nucleus, store DNA", "Is ATP versus GTP the main currency",
])
def test_simple_query_heuristic_matches_jax(question):
    assert RAGOrchestrator._is_simple_query(question) == JaxOrchestrator._is_simple_query(question)


def test_context_retry_matches_jax(stacks):
    ref, got, (jo, to) = run_both(
        stacks, "Explain how the energy currency of cells gets produced and used",
        script={"Evaluate this answer": [RETRY_CRITIQUE, GOOD_CRITIQUE]})
    assert got.retry_count == 1 and got.confidence >= 0.8
    steps = [s for s in got.metrics["steps"] if s["name"] == "retrieval"]
    # "missing" turns expansion on: the plan changed, so the mode stays
    assert [s["extra"]["mode"] for s in steps] == ["hybrid", "hybrid"]
    assert to.llm.backend.responder.counts["Evaluate this answer"] == 2


def test_context_gate_retries_match_jax(stacks):
    """The context gate asks for a new retrieval on each attempt: the plan's
    mode cycles hybrid -> dense -> bm25, then the last attempt answers."""
    ref, got, _ = run_both(stacks, "Explain how the energy currency of cells gets produced "
                                   "and used", gate=True)
    steps = [s for s in got.metrics["steps"] if s["name"] == "retrieval"]
    assert [s["extra"]["mode"] for s in steps] == ["hybrid", "dense", "bm25"]


def test_low_confidence_give_up_matches_jax(stacks):
    ref, got, _ = run_both(stacks, "What is the meaning of everything?",
                           script={"Evaluate this answer": BAD_CRITIQUE})
    assert got.low_confidence and got.answer == LOW_CONFIDENCE_RESPONSE


@pytest.mark.parametrize("mode,question", [("dense", "cell nucleus DNA contents"),
                                           ("bm25", "ribosomes proteins")])
def test_retrieval_modes_match_jax(stacks, mode, question):
    ref, got, _ = run_both(stacks, question,
                           script={"query-planning agent": plan(retrieval_mode=mode)})
    assert got.plan["retrieval_mode"] == mode
    assert bool(got.dense_docs) == (mode == "dense") and bool(got.bm25_docs) == (mode == "bm25")


def test_tool_execution_matches_jax(stacks):
    ref, got, _ = run_both(stacks, "what is 2*3+4",
                           script={"query-planning agent": plan(tools_to_use=["calculator"])})
    assert got.tool_results == [{"tool": "calculator", "success": True, "output": 10,
                                 "error": ""}]


def test_simplified_orchestrator_matches_jax(stacks):
    jllm, tllm = llms()
    (_, js, _, jm), (_, ts, _, tm) = stacks["j"], stacks["t"]
    ref = JaxSimplified(js, jm, jllm).run("What do mitochondria produce?")
    got = SimplifiedOrchestrator(ts, tm, tllm).run("What do mitochondria produce?")
    assert got == ref and "ATP" in got
    assert tllm.backend.calls == jllm.backend.calls


def _multihop_script():
    return {"query-planning agent": plan(use_multihop=True),
            "SEQUENCE of sub-questions": '["What is the energy currency?", "What produces {prev}?"]',
            "Answer the sub-question": [json.dumps({"answer": "ATP", "entities": [],
                                                    "confidence": 0.9, "sufficient": False}),
                                        json.dumps({"answer": "mitochondria", "entities": [],
                                                    "confidence": 0.9, "sufficient": True})]}


def test_multihop_merge_matches_jax(stacks):
    ref, got, (jo, to) = run_both(
        stacks, "What organelle is the producer of the energy currency of the cell?",
        script=_multihop_script())
    assert got.success and got.docs
    assert to.llm.backend.responder.counts["Answer the sub-question"] == 2
    assert any(s == 0.7 for _, s in got.fused_docs)  # the hop docs' merge score


def test_query_processing_and_rank_aggregation_match_jax(stacks):
    """Decomposition, rewrite and expansion give 6 effective queries, one
    search_rows of B = 6 on the card, whose per-query fused lists are
    aggregated across queries by RRF."""
    script = {"query-planning agent": plan(use_decomposition=True, use_rewrite=True,
                                           use_expansion=True),
              "Decompose the question": '["How do mitochondria make ATP?", '
                                        '"Where is DNA stored in the cell?"]',
              "Rewrite each query": '["mitochondria ATP production", "DNA storage nucleus"]',
              "alternative phrasings": '["energy currency cells", "chromosomes nucleus", '
                                       '"ribosomes protein synthesis", "golgi transport"]'}
    ref, got, _ = run_both(stacks, "Explain how mitochondria make ATP and where the cell "
                                   "keeps its DNA today", script=script)
    assert len(got.effective_queries) == 6 and len(got.fused_docs) == 6


def test_cross_query_rank_aggregation(stacks):
    """A doc ranked 2nd by both queries beats a doc ranked 1st by one."""
    _, to = orchestrators(stacks)
    store = stacks["t"][1]
    A, B, C = 0, 1, 2

    def fake_search_rows(embs, texts, **kw):
        k = kw.get("fused_k", 15)
        pad = lambda lst: lst + [-1] * (k - len(lst))  # noqa: E731
        rows = np.asarray([pad([A, B]), pad([C, B])], np.int64)
        scores = np.where(rows >= 0, 1.0, -1e30).astype(np.float32)
        blank_r, blank_s = np.full((2, k), -1, np.int64), np.full((2, k), -1e30, np.float32)
        return {"dense": (blank_s, blank_r), "bm25": (blank_s, blank_r), "fused": (scores, rows)}

    to._hybrid.search_rows = fake_search_rows
    to._hybrid._calibrated_at = to._hybrid.engine.count
    ctx = new_agent_context("multi")
    ctx.plan = {}
    to._run_hybrid_fused(ctx, ["sub-question one", "sub-question two"])
    ids = [d.doc_id for d, _ in ctx.fused_docs]
    assert ids[0] == store.id_for_row(B)
    assert set(ids[:3]) == {store.id_for_row(r) for r in (A, B, C)}


def test_hybrid_fused_retrieval_matches_jax(stacks):
    """_run_hybrid_fused alone, at one and at several queries."""
    jo, to = orchestrators(stacks)
    for queries in (["What produces ATP in the cell?"],
                    ["ATP energy", "DNA chromosomes", "protein transport golgi"]):
        jctx, tctx = jax_context("q"), new_agent_context("q")
        jctx.plan, tctx.plan = {}, {}
        jo._run_hybrid_fused(jctx, queries)
        to._run_hybrid_fused(tctx, queries)
        for leg in ("dense_docs", "bm25_docs", "fused_docs"):
            assert_hits_match([getattr(jctx, leg)], [getattr(tctx, leg)], leg)
        assert tctx.fused_docs and len({d.doc_id for d, _ in tctx.fused_docs}) == \
            len(tctx.fused_docs)


def test_summarization_in_run_matches_jax(stacks):
    """A context over max_total_context_chars: the dedup embeds the docs on
    the device and long docs are summarized by the LLM."""
    ref, got, _ = run_both(
        stacks, "Explain how the energy currency of cells gets produced and used",
        script={"Summarize the passage": "A short summary."},
        sections={"summarization": {"max_total_context_chars": 100, "max_doc_chars": 60,
                                    "dedup_similarity": 0.999}})
    assert any(d.meta.get("compressed") for d, _ in got.reranked_docs)


def test_conversation_history_matches_jax(stacks):
    history = [{"role": r, "content": f"{r} turn {i}"} for i in range(5)
               for r in ("user", "assistant")]
    ref, got, (jo, to) = run_both(stacks, "And what about the nucleus and its DNA content?",
                                  script={"Summarize this conversation": "They talked."},
                                  conversation_history=history)
    synth = [c for c in to.llm.backend.calls if "Question:" in c[-1]["content"]][0]
    assert synth[1]["content"] == "Earlier conversation summary: They talked."
    assert [c for c in jo.llm.backend.calls if "Question:" in c[-1]["content"]][0] == synth


def test_strategy_memory_sequence_matches_jax(stacks, tmp_path):
    """The same sequence of runs gives both packages the same memory; each
    reads the other's file."""
    paths = {k: str(tmp_path / f"{k}.json.gz") for k in "jt"}
    script = {"Evaluate this answer": [GOOD_CRITIQUE, RETRY_CRITIQUE, GOOD_CRITIQUE,
                                       BAD_CRITIQUE]}
    jo, to = orchestrators(stacks, script)
    for orch, key in ((jo, "j"), (to, "t")):
        orch.strategy_memory.path = paths[key]
    questions = ["What is ATP?", "Explain how the energy currency of cells is made today",
                 "How do ribosomes build the proteins of a cell", "What is DNA?",
                 "What is the nucleus?", "What is a chloroplast?"]
    for q in questions:
        assert_runs_match(jo.run(q), to.run(q))
    assert to.strategy_memory.stats == jo.strategy_memory.stats
    from radiant_rag_tpu.agents.strategy_memory import RetrievalStrategyMemory as JaxMemory
    from radiant_rag_tpu_torch.agents.strategy_memory import RetrievalStrategyMemory

    for q in questions:
        assert RetrievalStrategyMemory(paths["j"]).recommend_strategy(q) == \
            JaxMemory(paths["t"]).recommend_strategy(q) == jo.strategy_memory.recommend_strategy(q)


def test_empty_index_low_confidence_like_jax(stacks, tmp_path):
    from radiant_rag_tpu.index.bm25 import PersistentBM25Index as JaxBM25
    from radiant_rag_tpu.index.store import TpuVectorStore as JaxStore
    from radiant_rag_tpu_torch.index.bm25 import PersistentBM25Index
    from radiant_rag_tpu_torch.index.store import TpuVectorStore

    jc, tc = stacks["j"][0], stacks["t"][0]
    empty = {"j": (jc, JaxStore(dim=64, index_config=jc.index), None, stacks["j"][3]),
             "t": (tc, TpuVectorStore(dim=64, index_config=tc.index, device="cpu"), None,
                   stacks["t"][3])}
    empty["j"] = empty["j"][:2] + (JaxBM25(empty["j"][1], path=str(tmp_path / "j.gz")),
                                   empty["j"][3])
    empty["t"] = empty["t"][:2] + (PersistentBM25Index(empty["t"][1], path=str(tmp_path / "t.gz"),
                                                       device="cpu"), empty["t"][3])
    ref, got, _ = run_both(empty, "Is the sun a star?")
    assert got.low_confidence and got.answer == LOW_CONFIDENCE_RESPONSE


def test_pipeline_result_serializable(stacks):
    _, got, _ = run_both(stacks, "What is ATP?")
    d = got.to_dict()
    json.dumps(d)
    assert d["query"] == "What is ATP?" and d["num_docs"] == len(got.docs)


# ------------------------------------------------------------- degradation --
class _Flaky:
    """Fails planning and critique with retryable 500s; answers synthesis."""

    def chat(self, messages, **kw):
        last = messages[-1]["content"]
        if "query-planning" in last or "Evaluate this answer" in last:
            raise self.error("500 injected", status=500)
        if "Context:" in last and "Question:" in last:
            return "Mitochondria produce ATP."
        return "[]"


class _Dead:
    def chat(self, messages, **kw):
        raise self.error("connection refused")


@pytest.mark.parametrize("kind", ["flaky", "dead"])
def test_llm_failures_degrade_like_jax(stacks, kind):
    mixin = {"flaky": _Flaky, "dead": _Dead}[kind]
    jbackend = type("J", (mixin, JaxBackend), {"error": JaxLLMError})()
    tbackend = type("T", (mixin, BaseLLMBackend), {"error": LLMError})()
    (jc, js, jb, jm), (tc, ts, tb, tm) = stacks["j"], stacks["t"]
    jo = JaxOrchestrator(jc, js, jb, jm, JaxClient(jcfg.LLMConfig(max_retries=0,
                                                                  retry_backoff_s=0),
                                                   backend=jbackend))
    to = RAGOrchestrator(tc, ts, tb, tm, LLMClient(tcfg.LLMConfig(max_retries=0,
                                                                 retry_backoff_s=0),
                                                   backend=tbackend))
    for orch in (jo, to):
        orch.strategy_memory = None
    ref, got = jo.run("Is the mitochondria a cell part?"), to.run("Is the mitochondria a cell part?")
    assert_runs_match(ref, got)
    if kind == "flaky":
        assert "mitochondria" in got.answer.lower() and got.degraded["planning"]
    else:
        assert got.answer == LOW_CONFIDENCE_RESPONSE and not got.success
        assert "generation" in got.degraded


class _BrokenModels:
    """The stack's models with one device call replaced by a failure."""

    def __init__(self, models, broken):
        self._models, self._broken = models, broken
        self.embedder = models.embedder

    def __getattr__(self, name):
        if name == self._broken:
            def fail(*a, **kw):
                raise RuntimeError(f"injected {name} failure")
            return fail
        return getattr(self._models, name)


@pytest.mark.parametrize("broken", ["rerank", "embed", "embed_device"])
def test_device_failures_raise_where_jax_degrades(stacks, broken):
    models = {k: _BrokenModels(stacks[k][3], broken) for k in "jt"}
    jo, to = orchestrators(stacks, models=models)
    question = "What do mitochondria produce?"
    if broken == "rerank":  # the JAX rerank agent serves the incoming order
        ref = jo.run(question)
        assert ref.success and "rerank" not in ref.degraded and ref.reranked_docs
    with pytest.raises(DeviceStageError, match=f"injected {broken} failure"):
        to.run(question)


def test_device_failure_in_the_dense_agent_raises(stacks):
    models = {k: _BrokenModels(stacks[k][3], "embed") for k in "jt"}
    jo, to = orchestrators(stacks, script={"query-planning agent": plan(retrieval_mode="dense")},
                           models=models)
    ref = jo.run("cell nucleus DNA contents")
    assert not ref.dense_docs  # the JAX dense agent degrades to []
    with pytest.raises(DeviceStageError, match="dense retrieval"):
        to.run("cell nucleus DNA contents")


def test_strategy_memory_failure_is_isolated_like_jax(stacks, monkeypatch):
    jo, to = orchestrators(stacks)
    for orch in (jo, to):
        monkeypatch.setattr(orch.strategy_memory, "record_outcome",
                            lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    ref, got = jo.run("What is ATP?"), to.run("What is ATP?")
    assert_runs_match(ref, got)
    assert got.degraded == {"strategy_memory": "disk full"}


def test_pod_store_hybrid_raises_naming_its_item(stacks):
    """A hybrid store with no device engine behind it takes the pod path:
    its own search_hybrid, with the legs and the fused depth (the pod path
    was not ported before; tests/test_torch_sharded_app.py holds it against
    the JAX package)."""
    calls = []

    class PodStore:
        can_hybrid = True

        def search_hybrid(self, embeddings, queries, **kw):
            calls.append((len(queries), kw))
            return {"fused": [[]], "dense": [[]], "bm25": [[]]}

    cfg, _, bm25, models = stacks["t"]
    orch = RAGOrchestrator(cfg, PodStore(), bm25, models, llms()[1])
    assert orch._hybrid is None and not orch._hybrid_serves
    ctx = new_agent_context("q")
    orch._run_retrieval(ctx, None)
    assert calls == [(1, {"top_k": 10, "fused_k": 15, "rrf_k": 60, "return_legs": True,
                          "fused_depth": 60})]
    assert ctx.fused_docs == [] and ctx.dense_docs == []


# ---------------------------------------------------- rerank auto-disable ---
@pytest.mark.parametrize("probes", [8, 12])
def test_rerank_auto_disable_verdict_matches_jax(big, probes):
    jo, to = orchestrators(big, sections={"rerank": {"auto_disable_probes": probes,
                                                     "auto_disable_min_gain": 0.005}})
    assert to.rerank.enabled and jo.rerank.enabled
    jo._ensure_rerank_calibration()
    to._ensure_rerank_calibration()
    assert to.rerank_calibration == jo.rerank_calibration
    v = to.rerank_calibration
    assert v and v["probes"] >= 4 and v["auto_disabled"] == (v["gain"] < v["min_gain"])
    assert to.rerank.enabled == jo.rerank.enabled == (not v["auto_disabled"])
    stamp = to._rerank_calibrated_at
    to._ensure_rerank_calibration()  # sticky until growth or invalidation
    assert to._rerank_calibrated_at == stamp == jo._rerank_calibrated_at
    to.invalidate_fusion_calibration()
    assert to._rerank_calibrated_at == -1 and to.rerank.enabled
    # a whole run after the verdict agrees too
    for orch in (jo, to):
        orch._rerank_calibrated_at = stamp
        orch.rerank.enabled = not v["auto_disabled"]
    assert_runs_match(jo.run("Document about nucleus dna mechanisms in detail"),
                      to.run("Document about nucleus dna mechanisms in detail"))


def test_rerank_auto_disable_opt_out_matches_jax(big):
    jo, to = orchestrators(big, sections={"rerank": {"auto_disable_probes": 0}})
    for orch in (jo, to):
        orch._ensure_rerank_calibration()
        assert orch.rerank.enabled and not orch.rerank_calibration


def test_rerank_calibration_failure_raises(big):
    """The JAX package logs a failed calibration and leaves the stage as it
    was; the port raises it."""
    models = {k: _BrokenModels(big[k][3], "rerank") for k in "jt"}
    jo, to = orchestrators(big, sections={"rerank": {"auto_disable_probes": 8}}, models=models)
    jo._ensure_rerank_calibration()
    assert jo.rerank.enabled and not jo.rerank_calibration
    with pytest.raises(DeviceStageError, match="injected rerank failure"):
        to._ensure_rerank_calibration()
    assert to.rerank.enabled and not to.rerank_calibration


def test_agent_stats_after_a_run(stacks):
    _, got, (jo, to) = run_both(stacks, "What do mitochondria produce?")
    names = [s["name"] for s in to.get_agent_stats()]
    assert names == [s["name"] for s in jo.get_agent_stats()] and "web_search" in names
    runs = {s["name"]: s["runs"] for s in to.get_agent_stats()}
    assert runs == {s["name"]: s["runs"] for s in jo.get_agent_stats()}
    assert dataclasses.asdict(to.config.rerank) == dataclasses.asdict(jo.config.rerank)
