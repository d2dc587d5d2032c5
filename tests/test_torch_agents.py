"""The port's agents, LLM-facing helpers, tools, strategy memory and
conversations against the JAX package's (CPU).

Each case mirrors one of `tests/test_agents.py`, `test_agents2.py`,
`test_agents3.py` or `test_utils.py` and runs the same body over both
packages (`P` is the JAX package or the port): the JAX test's assertions
hold for the port, and the two packages' outputs on the same inputs and
the same scripted LLM are equal. Scores are host arithmetic on equal
inputs, so they are compared exactly. Files written by either package
(strategy memory, conversations) are read by the other.

The one deliberate difference: a failure inside a device stage (the
embed, store or BM25 search of the retrieval agents, the cross-encoder of
the rerank agent, the dedup embed of summarization, a multihop hop) raises
`DeviceStageError` out of the port's `BaseAgent.run`, where the JAX agent
degrades (ROADMAP: card failures raise).
"""

import json
import types

import numpy as np
import pytest

import radiant_rag_tpu.agents.automerge as j_automerge
import radiant_rag_tpu.agents.base as j_base
import radiant_rag_tpu.agents.base_agent as j_base_agent
import radiant_rag_tpu.agents.citation as j_citation
import radiant_rag_tpu.agents.context_eval as j_context_eval
import radiant_rag_tpu.agents.critic as j_critic
import radiant_rag_tpu.agents.fact_verification as j_fact_verification
import radiant_rag_tpu.agents.fusion as j_fusion
import radiant_rag_tpu.agents.multihop as j_multihop
import radiant_rag_tpu.agents.planning as j_planning
import radiant_rag_tpu.agents.query_processing as j_query_processing
import radiant_rag_tpu.agents.rerank as j_rerank
import radiant_rag_tpu.agents.retrieval as j_retrieval
import radiant_rag_tpu.agents.strategy_memory as j_strategy_memory
import radiant_rag_tpu.agents.summarization as j_summarization
import radiant_rag_tpu.agents.synthesis as j_synthesis
import radiant_rag_tpu.agents.tools as j_tools
import radiant_rag_tpu.index.doc as j_doc
import radiant_rag_tpu.llm.backends as j_backends
import radiant_rag_tpu.llm.client as j_client
import radiant_rag_tpu.utils.conversation as j_conversation
import radiant_rag_tpu_torch.agents.automerge as t_automerge
import radiant_rag_tpu_torch.agents.base as t_base
import radiant_rag_tpu_torch.agents.base_agent as t_base_agent
import radiant_rag_tpu_torch.agents.citation as t_citation
import radiant_rag_tpu_torch.agents.context_eval as t_context_eval
import radiant_rag_tpu_torch.agents.critic as t_critic
import radiant_rag_tpu_torch.agents.fact_verification as t_fact_verification
import radiant_rag_tpu_torch.agents.fusion as t_fusion
import radiant_rag_tpu_torch.agents.multihop as t_multihop
import radiant_rag_tpu_torch.agents.planning as t_planning
import radiant_rag_tpu_torch.agents.query_processing as t_query_processing
import radiant_rag_tpu_torch.agents.rerank as t_rerank
import radiant_rag_tpu_torch.agents.retrieval as t_retrieval
import radiant_rag_tpu_torch.agents.strategy_memory as t_strategy_memory
import radiant_rag_tpu_torch.agents.summarization as t_summarization
import radiant_rag_tpu_torch.agents.synthesis as t_synthesis
import radiant_rag_tpu_torch.agents.tools as t_tools
import radiant_rag_tpu_torch.index.doc as t_doc
import radiant_rag_tpu_torch.llm.backends as t_backends
import radiant_rag_tpu_torch.llm.client as t_client
import radiant_rag_tpu_torch.utils.conversation as t_conversation

_NAMES = ("automerge", "base", "base_agent", "citation", "context_eval", "critic",
          "fact_verification", "fusion", "multihop", "planning", "query_processing", "rerank",
          "retrieval", "strategy_memory", "summarization", "synthesis", "tools", "doc",
          "backends", "client", "conversation")
J = types.SimpleNamespace(**{n: globals()[f"j_{n}"] for n in _NAMES}, name="jax")
T = types.SimpleNamespace(**{n: globals()[f"t_{n}"] for n in _NAMES}, name="torch")


def both(body):
    """body(P) over both packages; their results must be equal."""
    ref, got = body(J), body(T)
    assert got == ref, (ref, got)
    return got


def llm(P, script=None, default="ok", responder=None):
    return P.client.LLMClient(backend=P.backends.MockLLMBackend(
        script=script, default=default, responder=responder))


def docs(P, *contents):
    return [(P.doc.StoredDoc(f"id{i}", c, {"source": f"s{i}.txt"}), 0.9 - 0.1 * i)
            for i, c in enumerate(contents)]


def leaf(P, i, parent=None, content="leaf content"):
    return P.doc.StoredDoc(f"leaf{i}", f"{content} {i}",
                           {"doc_level": "leaf", "parent_id": parent or ""})


def ids(hits):
    return [d.doc_id for d, _ in hits]


# ---------------------------------------------------------------- lifecycle --
def _agents(P):
    class SimpleTestAgent(P.base_agent.BaseAgent):
        name = "simple_test"

        def __init__(self, fail=False, **kw):
            super().__init__(**kw)
            self.fail = fail
            self.hooks = []

        def _before_execute(self, ctx, **kw):
            self.hooks.append("before")

        def _execute(self, ctx, **kw):
            self.hooks.append("execute")
            if self.fail:
                raise RuntimeError("boom")
            return {"ok": True, "echo": kw.get("extra")}

        def _after_execute(self, ctx, result, **kw):
            self.hooks.append("after")
            return result

    class FallbackTestAgent(SimpleTestAgent):
        name = "fallback_test"

        def _on_error(self, ctx, exc, **kw):
            self.hooks.append("on_error")
            return {"fallback": True}

    return SimpleTestAgent, FallbackTestAgent


def _outcome(agent, result):
    return (result.success, result.status.value, result.data, result.error,
            list(result.warnings), list(agent.hooks))


@pytest.mark.parametrize("kind", ["success", "failure", "fallback", "disabled"])
def test_lifecycle_matches_jax(kind):
    def body(P):
        simple, fallback = _agents(P)
        agent = {"success": lambda: simple(), "failure": lambda: simple(fail=True),
                 "fallback": lambda: fallback(fail=True),
                 "disabled": lambda: simple(enabled=False)}[kind]()
        ctx = P.base.new_agent_context("q")
        result = agent.run(ctx, extra=42)
        assert result.metrics.agent_name == agent.name and result.metrics.duration_ms >= 0
        assert agent.log.correlation_id == ctx.run_id
        return _outcome(agent, result), {k: v for k, v in agent.get_stats().items()
                                         if k not in ("total_ms", "avg_ms")}

    (ok, status, data, error, warnings, hooks), stats = both(body)
    assert status == {"success": "success", "failure": "failed", "fallback": "partial",
                      "disabled": "skipped"}[kind]
    assert stats["runs"] == (0 if kind == "disabled" else 1)


def test_execute_raises_and_llm_agent_requires_llm():
    def body(P):
        simple, _ = _agents(P)
        with pytest.raises(P.base_agent.AgentError, match="boom"):
            simple(fail=True).execute(P.base.new_agent_context("q"))

        class L(P.base_agent.LLMAgent):
            name = "l"

            def _execute(self, ctx, **kw):
                return "x"

        with pytest.raises(ValueError):
            L(None)
        return L(llm(P)).execute(P.base.new_agent_context("q"))

    assert both(body) == "x"


def test_device_stage_failure_raises_in_the_port_only():
    """An agent whose device stage fails: the JAX agent degrades through
    _on_error; the port's raises DeviceStageError, counted as a failure."""
    class Agent(t_base_agent.BaseAgent):
        name = "device_probe"

        def __init__(self):
            super().__init__()
            self.stage = t_base_agent.DeviceStages()

        def _execute(self, ctx, **kw):
            with self.stage("probe"):
                raise RuntimeError("card lost")

        def _on_error(self, ctx, exc, **kw):
            return "degraded"

    agent = Agent()
    with pytest.raises(t_base_agent.DeviceStageError, match="probe: RuntimeError: card lost"):
        agent.run(t_base.new_agent_context("q"))
    assert agent.get_stats()["failures"] == 1 and agent.get_stats()["runs"] == 1
    assert isinstance(t_base_agent.DeviceStageError("x"), RuntimeError)


def test_device_stages_share_one_lock():
    import threading

    lock = threading.RLock()
    stages = t_base_agent.DeviceStages(lock)
    with stages("outer"):
        assert lock._is_owned()
        with stages("inner"):  # re-entrant: a stage inside a stage
            pass
    assert not lock._is_owned()


# ---------------------------------------------------------------- tools -----
def test_calculator_and_code_execution_match_jax():
    def body(P):
        calc = P.tools.CalculatorTool()
        out = [calc.run(e).to_dict() for e in ("2*(3+4)", "sqrt(16) + 1", "pi", "min(3, 1, 2)",
                                               "__import__('os')", "open('/etc/passwd')",
                                               "'a' * 99999999", "2**99999", "1 < 2")]
        gated = P.tools.CodeExecutionTool(allowed=False).run("result = 1").to_dict()
        tool = P.tools.CodeExecutionTool(allowed=True)
        return out, gated, tool.run("result = sum(range(10))").to_dict(), \
            tool.run("import os").success

    out, gated, ran, imported = both(body)
    assert [o["output"] for o in out[:4]] == [14, 5.0, pytest.approx(3.14159265), 1]
    assert not any(o["success"] for o in out[4:])
    assert not gated["success"] and ran["output"] == 45 and not imported


def test_default_tool_registry_and_selector_match_jax():
    def body(P):
        reg = P.tools.create_default_tool_registry()
        sel = P.tools.ToolSelector(llm(P, default=json.dumps(
            [{"tool": "calculator", "input": "6*7"}, {"tool": "nope", "input": "x"}])), reg)
        return (reg.run("calculator", "1+1").output, reg.run("code_execution", "result=1").success,
                reg.run("nope", "x").success, reg.list_tools(), sel.select("six times seven"))

    calc, code, nope, tools, selected = both(body)
    assert (calc, code, nope) == (2, False, False)
    assert selected == [{"tool": "calculator", "input": "6*7"}]


# ---------------------------------------------------------------- memory ----
def test_strategy_memory_learning_matches_jax(tmp_path):
    def body(P):
        mem = P.strategy_memory.RetrievalStrategyMemory(path=str(tmp_path / f"{P.name}.json.gz"))
        classes = [mem.classify(q) for q in ("what is X", "how do I fly", "compare a vs b",
                                              "latest news", "solar panel", "why not")]
        empty = mem.recommend_strategy("what is Y")
        for _ in range(6):
            mem.record_outcome("what is A", "bm25", success=True, persist=False)
            mem.record_outcome("what is A", "dense", success=False, persist=False)
        mem.save()
        return classes, empty, mem.recommend_strategy("what is B"), mem.get_stats()

    classes, empty, (mode, conf), stats = both(body)
    assert classes[:2] == ["definition", "howto"] and empty == (None, 0.0)
    assert mode == "bm25" and conf > 0.5


def test_strategy_memory_file_crosses_packages(tmp_path):
    """A memory file written by either package is read by the other."""
    for writer, reader in ((J, T), (T, J)):
        path = str(tmp_path / f"{writer.name}.json.gz")
        mem = writer.strategy_memory.RetrievalStrategyMemory(path=path)
        for i in range(5):
            mem.record_outcome(f"how do I solve {i}", "dense", success=True, confidence=0.8)
        other = reader.strategy_memory.RetrievalStrategyMemory(path=path)
        assert other.recommend_strategy("how do I fly") == mem.recommend_strategy("how do I fly")
        assert other.stats == mem.stats


# ---------------------------------------------------------------- planning --
def test_planning_validates_and_defaults_match_jax():
    def body(P):
        agent = P.planning.PlanningAgent(llm(P, default=json.dumps(
            {"use_rerank": "yes", "retrieval_mode": "bogus", "tools_to_use": "nope"})))
        ctx = P.base.new_agent_context("q")
        return agent.execute(ctx), ctx.retrieval_mode

    plan, mode = both(body)
    assert plan["use_rerank"] is True and plan["retrieval_mode"] == "hybrid"
    assert plan["tools_to_use"] == [] and mode == "hybrid"


def test_planning_fallback_on_garbage_matches_jax():
    def body(P):
        agent = P.planning.PlanningAgent(llm(P, default="not json"))
        return agent.execute(P.base.new_agent_context("q"))

    assert both(body) == j_planning.PLAN_DEFAULTS == t_planning.PLAN_DEFAULTS


def test_planning_llm_error_degrades_to_defaults_like_jax():
    def body(P):
        class Down(P.backends.BaseLLMBackend):
            def chat(self, messages, **kw):
                raise P.backends.LLMError("503", status=503)

        client = P.client.LLMClient(P.client.LLMConfig(max_retries=0, retry_backoff_s=0),
                                    backend=Down())
        agent = P.planning.PlanningAgent(client)
        res = agent.run(P.base.new_agent_context("q"))
        return res.status.value, res.data, res.error, client.stats()

    status, data, error, stats = both(body)
    assert status == "partial" and "503" in error and stats == {"calls": 1, "errors": 1}


def test_planning_strategy_memory_injection_matches_jax(tmp_path):
    def body(P):
        mem = P.strategy_memory.RetrievalStrategyMemory(path=str(tmp_path / f"{P.name}.gz"))
        for _ in range(6):
            mem.record_outcome("what is A", "bm25", success=True, persist=False)
        agent = P.planning.PlanningAgent(llm(P, default="{}"), strategy_memory=mem)
        return agent.execute(P.base.new_agent_context("what is B"))

    assert both(body)["retrieval_mode"] == "bm25"


@pytest.mark.parametrize("issues,plan_over", [
    (["something vague"], {"use_expansion": True, "use_decomposition": True}),
    (["coverage is missing key aspects"], {}),
    (["the question has multiple parts"], {"use_expansion": True}),
])
def test_plan_retry_matches_jax(issues, plan_over):
    def body(P):
        agent = P.planning.PlanningAgent(llm(P, default="{}"))
        ctx = P.base.new_agent_context("q")
        ctx.plan = dict(P.planning.PLAN_DEFAULTS, **plan_over)
        out = []
        for _ in range(3):
            agent.plan_retry(ctx, {"issues": issues})
            out.append((dict(ctx.plan), ctx.retrieval_mode))
        return out

    out = both(body)
    if not plan_over:
        assert out[0][0]["use_expansion"] and out[0][1] == "hybrid"
    if len(plan_over) == 2:
        assert [m for _, m in out] == ["dense", "bm25", "hybrid"]


# -------------------------------------------------------- query processing --
def test_query_processing_agents_match_jax():
    def body(P):
        script = {"Decompose the question": '["part one?", "part two?", "three", "four"]',
                  "Rewrite each query": '["p1 rewritten", ""]',
                  "alternative phrasings": '["Part One?", "alt one", "alt two", "alt three", '
                                           '"alt four", "alt five"]'}
        client = llm(P, script=script)
        ctx = P.base.new_agent_context("q")
        decomp = P.query_processing.QueryDecompositionAgent(client, max_queries=3).execute(ctx)
        rw = P.query_processing.QueryRewriteAgent(client).execute(ctx, queries=decomp[:2])
        exp = P.query_processing.QueryExpansionAgent(client, max_expansions=2).execute(
            ctx, queries=decomp[:2])
        wrong = P.query_processing.QueryRewriteAgent(llm(P, default='["only one"]')) \
            .rewrite_batch(["q1", "q2"])
        return decomp, rw, exp, wrong, ctx.decomposed_queries, ctx.rewrites, ctx.expansions

    decomp, rw, exp, wrong, *_ = both(body)
    assert decomp == ["part one?", "part two?", "three"]
    assert rw == {"part one?": "p1 rewritten", "part two?": "part two?"}
    assert "Part One?" not in exp and len(exp) == 4
    assert wrong == {"q1": "q1", "q2": "q2"}


# ---------------------------------------------------------------- critic ----
def test_critic_matches_jax():
    def body(P):
        agent = P.critic.CriticAgent(llm(P, default="{}"), give_up_confidence=0.2,
                                     confidence_threshold=0.5)
        norms = [agent.normalize(raw) for raw in (
            {"relevance": 9, "faithfulness": 9, "coverage": 9, "confidence": "bad"},
            {"relevance": 99, "coverage": -5}, {"confidence": 1.5, "issue_type": "weird"},
            {"ok": False, "issues": ["", "gap"], "should_retry": 0})]
        give_up = [agent.should_give_up({"confidence": c}, attempt=a, max_retries=2)
                   for c, a in ((0.1, 0), (0.4, 0), (0.4, 2), (0.9, 2))]
        quality = [agent.evaluate_retrieval_quality(d) for d in ([], docs(P, "a", "b"))]
        ctx = P.base.new_agent_context("q")
        ctx.final_answer = "an answer"
        critic = P.critic.CriticAgent(llm(P, default=json.dumps(
            {"confidence": 0.3, "issues": ["missing context"], "should_retry": True,
             "issue_type": "context"})))
        run = critic.execute(ctx, docs=docs(P, "x" * 5000, "y"))
        return norms, give_up, quality, run, ctx.critic_notes, ctx.confidences

    norms, give_up, quality, run, notes, conf = both(body)
    np.testing.assert_allclose(norms[0]["confidence"], 0.9)
    assert norms[1]["relevance"] == 10 and norms[1]["coverage"] == 0
    assert give_up == [True, False, True, False]
    np.testing.assert_allclose(quality, [0.0, 0.85])
    assert run["issue_type"] == "context" and notes == ["missing context"]


# ---------------------------------------------------------------- citation --
@pytest.mark.parametrize("style", ["inline", "footnote", "academic", "hyperlink", "enterprise"])
def test_citation_styles_match_jax(style):
    answer = "Mitochondria produce ATP for the cell. Plants use photosynthesis instead."
    arr = json.dumps([{"sources": ["1"], "confidence": 0.9},
                      {"sources": ["2", "7"], "confidence": 0.8}])

    def body(P):
        agent = P.citation.CitationTrackingAgent(llm(P, default=arr), style=style)
        cited = agent.cite(answer, docs(P, "ATP is made in mitochondria",
                                        "Photosynthesis happens in plants"))
        assert len(cited.audit_id) == 16
        return cited.text, cited.bibliography, {k: v for k, v in cited.to_dict().items()
                                                if k != "audit_id"}

    text, bib, summary = both(body)
    assert "Sources:" in bib and summary["num_matches"] == 2


def test_citation_regex_fallback_matches_jax():
    def body(P):
        agent = P.citation.CitationTrackingAgent(llm(P, default="not json"), style="inline")
        cited = agent.cite(
            "The mitochondria generates cellular energy through respiration processes.",
            docs(P, "mitochondria cellular energy respiration in detail explained"))
        return cited.text, [(m.claim, m.source_keys, m.confidence) for m in cited.matches]

    assert both(body)[1]


# ---------------------------------------------------------------- multihop --
def test_multihop_detection_and_hops_match_jax():
    class Store:
        def __init__(self, P):
            self.hits = docs(P, "ATP is the energy currency", "mitochondria make ATP")

        def retrieve_by_embedding(self, emb, top_k=4):
            return self.hits[:top_k]

    class Models:
        def embed_single(self, text):
            return np.ones(4, np.float32)

    def body(P):
        agent = P.multihop.MultiHopReasoningAgent.__new__(P.multihop.MultiHopReasoningAgent)
        detected = [agent.detect(q) for q in ("Who is the author of the book that won in 1997?",
                                              "What is the difference between X and Y?",
                                              "What is photosynthesis?")]
        calls = {"n": 0}

        def responder(messages):
            last = messages[-1]["content"]
            if "SEQUENCE of sub-questions" in last:
                return '["What is the energy currency?", "What produces {prev}?"]'
            calls["n"] += 1
            return json.dumps({"answer": "ATP" if calls["n"] == 1 else "mitochondria",
                               "entities": ["x"], "confidence": 0.9,
                               "sufficient": calls["n"] >= 2})

        mh = P.multihop.MultiHopReasoningAgent(llm(P, responder=responder), Store(P), Models(),
                                               docs_per_hop=1)
        ctx = P.base.new_agent_context("Which organelle is the producer of the energy currency?")
        out = mh.execute(ctx, force=True)
        return detected, out["used"], out["hops"], out["knowledge"], ids(out["docs"])

    detected, used, hops, knowledge, hop_docs = both(body)
    assert [d[0] for d in detected] == [True, True, False] and used
    assert knowledge[1]["hop"] == "What produces ATP?" and hop_docs == ["id0", "id0"]


def test_multihop_device_failure_raises_in_the_port_only():
    class Models:
        def embed_single(self, text):
            raise RuntimeError("embed failed")

    def agent(P):
        return P.multihop.MultiHopReasoningAgent(
            llm(P, default='["hop one"]'), object(), Models())

    res = agent(J).run(j_base.new_agent_context("q"), force=True)
    assert res.status.value == "partial" and res.data["used"] is False
    with pytest.raises(t_base_agent.DeviceStageError, match="multihop retrieval"):
        agent(T).run(t_base.new_agent_context("q"), force=True)


# ------------------------------------------------------------- summarization
class _DupModels:
    def embed(self, texts):
        base = np.eye(3, 8, dtype=np.float32)
        out = [base[0], base[0] + 0.01, base[2]][:len(texts)]
        return np.stack([v / np.linalg.norm(v) for v in out])


def test_summarization_matches_jax():
    def body(P):
        agent = P.summarization.SummarizationAgent(
            llm(P, default="summary"), local_models=_DupModels(), max_total_context_chars=10,
            dedup_similarity=0.9)
        stats = P.summarization.CompressionStats()
        kept = agent.dedup(docs(P, "first duplicate text", "second duplicate text",
                                "unique other"), stats)
        long_ = P.summarization.SummarizationAgent(
            llm(P, default="SHORT SUMMARY"), local_models=None, max_total_context_chars=100,
            max_doc_chars=50)
        ctx = P.base.new_agent_context("q")
        ctx.fused_docs = docs(P, "x" * 200, "short")
        out = long_.execute(ctx)
        history = [{"role": "user", "content": f"turn {i}"} for i in range(6)]
        conv = long_.compress_conversation(history)
        return (ids(kept), stats.__dict__, [(d.content, d.meta) for d, _ in out],
                ctx.extras["compression"], conv)

    kept, stats, out, comp, conv = both(body)
    assert kept == ["id0", "id2"] and stats["docs_deduped"] == 1
    assert out[0][0] == "SHORT SUMMARY" and out[0][1]["compressed"] is True
    assert conv[0]["role"] == "system" and len(conv) == 5


def test_summarization_device_failure_raises_in_the_port_only():
    class Broken:
        def embed(self, texts):
            raise RuntimeError("embed failed")

    def agent(P):
        return P.summarization.SummarizationAgent(llm(P), local_models=Broken(),
                                                  max_total_context_chars=1)

    d = "first text", "second text", "third"
    res = agent(J).run(j_base.new_agent_context("q"), docs=docs(J, *d))
    assert res.status.value == "partial" and len(res.data) == 3
    with pytest.raises(t_base_agent.DeviceStageError, match="summarization dedup"):
        agent(T).run(t_base.new_agent_context("q"), docs=docs(T, *d))


# ------------------------------------------------------------- context eval -
def test_context_eval_matches_jax():
    def body(P):
        agent = P.context_eval.ContextEvaluationAgent()
        Doc = P.doc.StoredDoc
        evs = [agent.heuristic_eval(d).to_dict() for d in (
            [], [(Doc("a", "x", {}), 0.05), (Doc("b", "y", {}), 0.04)],
            [(Doc("a", "x", {}), 0.8)])]
        judged = P.context_eval.ContextEvaluationAgent(
            llm=llm(P, default=json.dumps({"sufficient": False, "confidence": 0.4,
                                           "relevance": 0.2, "coverage": 0.1,
                                           "missing_aspects": ["dates"],
                                           "recommendation": "expand_retrieval"})),
            use_llm=True)
        ctx = P.base.new_agent_context("q")
        return evs, judged.execute(ctx, docs=[(Doc("a", "x", {}), 0.8)]).to_dict(), \
            ctx.confidences

    evs, judged, conf = both(body)
    assert [e["recommendation"] for e in evs] == ["expand_retrieval", "rewrite_query", "proceed"]
    assert judged["recommendation"] == "expand_retrieval" and conf == {"context_eval": 0.4}


# ------------------------------------------------------- fact verification --
@pytest.mark.parametrize("statuses", [("contradicted", "supported"), ("supported",),
                                      ("bogus", "not_supported")])
def test_fact_verification_matches_jax(statuses):
    def body(P):
        def responder(messages):
            last = messages[-1]["content"]
            if "atomic factual claims" in last:
                return json.dumps([f"claim {i}" for i in range(len(statuses))])
            if "For each claim" in last:
                return json.dumps([{"status": s, "evidence": "e", "confidence": 0.9}
                                   for s in statuses])
            return "CORRECTED ANSWER"

        agent = P.fact_verification.FactVerificationAgent(llm(P, responder=responder))
        report = agent.verify("An answer.", docs(P, "Some context."), "q")
        return report.to_dict(), report.corrected_answer, report.needs_correction

    report, corrected, needs = both(body)
    assert needs == any(s in ("contradicted", "not_supported") for s in statuses)
    assert corrected == ("CORRECTED ANSWER" if needs else "")


# ---------------------------------------------------------------- synthesis -
def test_synthesis_messages_match_jax():
    def body(P):
        backend = P.backends.MockLLMBackend(default="  The answer [DOC 1].  ")
        agent = P.synthesis.AnswerSynthesisAgent(P.client.LLMClient(backend=backend),
                                                 max_context_docs=2, max_chars_per_doc=10)
        ctx = P.base.new_agent_context("q?")
        ctx.fused_docs = docs(P, "first document text", "second", "third")
        ctx.tool_results = [{"tool": "calculator", "output": 42}]
        ctx.conversation_history = [{"role": "user", "content": f"h{i}"} for i in range(8)]
        tokens = []
        ctx.extras["token_sink"] = tokens.append
        return agent.execute(ctx), backend.calls, tokens

    answer, calls, tokens = both(body)
    assert answer == "The answer [DOC 1]." and len(calls[0]) == 8 and tokens


# ---------------------------------------------------------------- automerge -
class DictStore:
    def __init__(self, docs_):
        self.docs = {d.doc_id: d for d in docs_}

    def get_doc(self, doc_id):
        return self.docs.get(doc_id)


@pytest.mark.parametrize("case", ["merge", "threshold", "too_large", "missing_parent"])
def test_automerge_matches_jax(case):
    def body(P):
        parent = P.doc.StoredDoc("p1", "x" * 100 if case == "too_large" else "the parent",
                                 {"doc_level": "parent"})
        store = DictStore([] if case == "missing_parent" else [parent])
        agent = P.automerge.HierarchicalAutoMergingAgent(
            store, min_children_to_merge=3 if case == "threshold" else 2, max_parent_chars=50)
        d = [(leaf(P, 1, "p1"), 0.9), (leaf(P, 2, "p1"), 0.7), (leaf(P, 3, ""), 0.5)]
        return [(d_.doc_id, s) for d_, s in agent.merge(d)]

    merged = both(body)
    assert ("p1", 0.9) in merged if case == "merge" else "p1" not in dict(merged)


# ---------------------------------------------------------------- rrf agent -
def test_rrf_agent_matches_jax():
    def body(P):
        agent = P.fusion.RRFAgent(rrf_k=60, top_k=10)
        a, b, c = leaf(P, 1), leaf(P, 2), leaf(P, 3)
        fused = agent.fuse([[(a, 0.9), (b, 0.5)], [(b, 12.0), (c, 3.0)]])
        ctx = P.base.new_agent_context("q")
        ctx.dense_docs = [(leaf(P, i), 0.9 - i / 10) for i in range(3)]
        passthrough = P.fusion.RRFAgent(top_k=2)._on_error(ctx, RuntimeError("x"))
        return [(d.doc_id, s) for d, s in fused], ids(passthrough)

    fused, passthrough = both(body)
    assert fused[0] == ("leaf2", 1 / 62 + 1 / 61) and passthrough == ["leaf0", "leaf1"]


# ---------------------------------------------------------------- rerank ----
class FakeModels:
    def rerank(self, query, docs_, top_k=None, max_chars=3000):
        order = list(range(len(docs_)))[::-1]
        if top_k:
            order = order[:top_k]
        return [(i, float(len(docs_) - rank)) for rank, i in enumerate(order)]


@pytest.mark.parametrize("prior_weight,n,top_k,tied", [(0.0, 6, 2, False), (100.0, 8, 3, False),
                                                       (1.0, 4, 2, True), (1.0, 40, 8, False)])
def test_rerank_agent_matches_jax(prior_weight, n, top_k, tied):
    def body(P):
        agent = P.rerank.CrossEncoderRerankingAgent(FakeModels(), top_k=top_k,
                                                    candidate_multiplier=2, min_candidates=3,
                                                    prior_weight=prior_weight)
        d = [(leaf(P, i), 0.5 if tied else 1.0 - i * 0.01) for i in range(n)]
        ctx = P.base.new_agent_context("q")
        ctx.fused_docs = d
        out = agent.execute(ctx)
        return [(doc.doc_id, s) for doc, s in out], ids(agent._on_error(ctx, RuntimeError("x")))

    out, on_error = both(body)
    assert len(out) == top_k and len(on_error) == top_k


def test_rerank_device_failure_raises_in_the_port_only():
    class Broken:
        def rerank(self, *a, **kw):
            raise RuntimeError("injected rerank failure")

    def run(P):
        agent = P.rerank.CrossEncoderRerankingAgent(Broken(), top_k=2)
        ctx = P.base.new_agent_context("q")
        ctx.fused_docs = [(leaf(P, i), 0.5) for i in range(5)]
        return agent.run(ctx)

    res = run(J)
    assert res.status.value == "partial" and ids(res.data) == ["leaf0", "leaf1"]
    with pytest.raises(t_base_agent.DeviceStageError, match="rerank: RuntimeError: injected"):
        run(T)


# ------------------------------------------------------ retrieval agents ----
class FakeStore:
    def __init__(self, P, fail=False):
        self.P, self.fail = P, fail

    def retrieve_by_embedding_batch(self, embs, top_k=10, min_similarity=0.0,
                                    doc_level_filter=None):
        if self.fail:
            raise RuntimeError("search failed")
        assert doc_level_filter == "leaf"
        return [[(leaf(self.P, i), 0.5 + 0.1 * i + 0.01 * q) for i in range(top_k)]
                for q in range(len(embs))]

    def search_batch(self, queries, top_k=10):
        return self.retrieve_by_embedding_batch(np.zeros((len(queries), 2)), top_k, 0.0, "leaf")


class EmbedModels:
    def embed(self, texts):
        return np.zeros((len(texts), 2), np.float32)


@pytest.mark.parametrize("fail", [False, True])
def test_retrieval_agents_match_jax_and_raise_on_device_failure(fail):
    def run(P):
        dense = P.retrieval.DenseRetrievalAgent(FakeStore(P, fail), EmbedModels(), top_k=3)
        bm25 = P.retrieval.BM25RetrievalAgent(FakeStore(P, fail), top_k=2)
        ctx = P.base.new_agent_context("q")
        return [dense.run(ctx, queries=["a", "b"]), bm25.run(ctx, queries=["a"])], ctx

    jres, jctx = run(J)
    if not fail:
        tres, tctx = run(T)
        for a, b in zip(jres, tres):
            assert [(d.doc_id, s) for d, s in b.data] == [(d.doc_id, s) for d, s in a.data]
        assert ids(tctx.dense_docs) == ids(jctx.dense_docs) == ["leaf2", "leaf1", "leaf0"]
        return
    assert [r.status.value for r in jres] == ["partial", "partial"] and not jctx.dense_docs
    with pytest.raises(t_base_agent.DeviceStageError, match="dense retrieval"):
        run(T)
    bm25 = t_retrieval.BM25RetrievalAgent(FakeStore(T, True))
    with pytest.raises(t_base_agent.DeviceStageError, match="bm25 retrieval"):
        bm25.run(t_base.new_agent_context("q"))


def test_dedup_best_score_matches_jax():
    def body(P):
        a, b = leaf(P, 1), leaf(P, 2)
        return [(d.doc_id, s) for d, s in P.retrieval.dedup_best_score(
            [(a, 0.2), (b, 0.9), (a, 0.7), (b, 0.1)])]

    assert both(body) == [("leaf2", 0.9), ("leaf1", 0.7)]


# ------------------------------------------------------------ conversation --
def test_conversation_manager_matches_jax_and_crosses_packages(tmp_path):
    def body(P):
        mgr = P.conversation.ConversationManager(data_dir=str(tmp_path / P.name), max_turns=2)
        cid = mgr.start_conversation("c-" + P.name)
        for i in (1, 2, 3):
            mgr.add_turn(cid, f"q{i}", f"a{i}")
        conv = mgr.get(cid)
        return [t.query for t in conv.turns], mgr.get_history_for_synthesis(cid)

    turns, history = both(body)
    assert turns == ["q2", "q3"] and history[-1] == {"role": "assistant", "content": "a3"}
    for writer, reader in ((J, T), (T, J)):
        store = reader.conversation.ConversationStore(str(tmp_path / writer.name))
        conv = store.load("c-" + writer.name)
        assert [t.query for t in conv.turns] == ["q2", "q3"]
        assert store.list_ids() == ["c-" + writer.name]


def test_conversation_store_ttl_and_sanitization_match_jax(tmp_path):
    import time

    def body(P):
        root = tmp_path / P.name
        store = P.conversation.ConversationStore(str(root), ttl_s=0.05)
        conv = P.conversation.Conversation("c1")
        conv.add_turn("q", "a")
        store.save(conv)
        loaded = store.load("c1") is not None
        time.sleep(0.06)
        evil = P.conversation.ConversationStore(str(root / "evil"))
        evil.save(P.conversation.Conversation("../../evil"))
        return loaded, store.load("c1"), store.list_ids(), \
            [p.name for p in (root / "evil").glob("*.json")]

    assert both(body) == (True, None, [], ["evil.json"])
