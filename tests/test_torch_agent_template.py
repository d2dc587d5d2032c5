"""The port's agent registry, agent templates, intelligent chunking and the
two library processors against the JAX package's (CPU).

Mirrors tests/test_agent_template.py: every template runs its success
path, its degradation path and the SKIPPED short-circuit in both packages
on equal inputs (tests/_torch_agentic_world.py's stacks). TEMPLATE 4's MMR
is a plain PyTorch function in the port: its picks equal the JAX
`_mmr_select`'s (`jax.jit` + `lax.scan`) over the same float32 vectors, and
a failure inside its device stage raises instead of taking the
input-order fallback. The chunking agent and the processors split and
translate the same files into the same chunks.
"""

import numpy as np
import pytest
import torch

from radiant_rag_tpu.agents import agent_template as jtpl
from radiant_rag_tpu.agents import chunking as jchunk
from radiant_rag_tpu.agents import registry as jreg
from radiant_rag_tpu.agents.base import new_agent_context as jax_ctx
from radiant_rag_tpu.agents.language import LanguageDetectionAgent as JaxDetector
from radiant_rag_tpu.agents.language import TranslationAgent as JaxTranslator
from radiant_rag_tpu.ingestion import processor as jproc
from radiant_rag_tpu_torch.agents import agent_template as ttpl
from radiant_rag_tpu_torch.agents import chunking as tchunk
from radiant_rag_tpu_torch.agents import registry as treg
from radiant_rag_tpu_torch.agents.base import new_agent_context
from radiant_rag_tpu_torch.agents.base_agent import AgentStatus, DeviceStageError
from radiant_rag_tpu_torch.agents.language import LanguageDetectionAgent, TranslationAgent
from radiant_rag_tpu_torch.ingestion import processor as tproc

from _torch_agentic_world import BIG_DOCS, llms, make_stacks

Q = "what makes a laser emit coherent photons"


def ctxs(q=Q):
    return jax_ctx(q), new_agent_context(q)


# ---------------------------------------------------------------- registry
def test_registry_matches_jax():
    out = []
    for mod in (jreg, treg):
        reg = mod.AgentRegistry()
        assert not reg and len(reg) == 0
        mod.register_agent("b", description="bee", category="retrieval", tags=["x", "y"],
                           registry=reg)(lambda v: v * 2)
        reg.register(lambda v: v + 1, name="a", version="2.0", tags=["y"])
        out.append((len(reg), "a" in reg, reg.invoke("a", 1), reg.invoke("b", 4),
                    [m.name for m in reg.list_agents()],
                    [m.name for m in reg.list_agents(category="retrieval")],
                    sorted(m.name for m in reg.find_by_tag("y")), reg.get("a").metadata.version,
                    reg.unregister("a"), reg.unregister("a"), reg.get("a")))
        with pytest.raises(KeyError, match="not registered"):
            reg.invoke("zz")
        assert mod.get_global_registry() is mod.get_global_registry()
    assert out[1] == out[0] == (2, True, 2, 8, ["a", "b"], ["b"], ["a", "b"], "2.0", True,
                                False, None)


# ---------------------------------------------------------------- templates 1 and 2
def test_plain_template_matches_jax():
    (jc, tc) = ctxs()
    for kw in ({"max_keywords": 3}, {"enabled": False}):
        ref, got = jtpl.TemplateAgent(**kw).run(jc), ttpl.TemplateAgent(**kw).run(tc)
        assert got.status.value == ref.status.value
        assert (got.data and got.data.to_dict()) == (ref.data and ref.data.to_dict())
    assert tc.extras["template"] == jc.extras["template"] and tc.extras["template"]["keywords"]
    assert ttpl.TemplateOutput().to_dict() == jtpl.TemplateOutput().to_dict()


def test_llm_template_contract_and_fallback_match_jax():
    for script in ({"salient search keywords": '["laser", "coherence"]'},
                   {"salient search keywords": "no json here"}):
        jllm, tllm = llms(script)
        (jc, tc) = ctxs()
        ref, got = jtpl.TemplateLLMAgent(jllm).run(jc), ttpl.TemplateLLMAgent(tllm).run(tc)
        assert got.status.value == ref.status.value == "success" and got.data == ref.data

    class Down:
        def __call__(self, messages):
            raise RuntimeError("backend down")

    from radiant_rag_tpu import config as jcfg
    from radiant_rag_tpu.llm.backends import MockLLMBackend as JaxMock
    from radiant_rag_tpu.llm.client import LLMClient as JaxClient
    from radiant_rag_tpu_torch.config import LLMConfig
    from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
    from radiant_rag_tpu_torch.llm.client import LLMClient

    (jc, tc) = ctxs()
    ref = jtpl.TemplateLLMAgent(JaxClient(jcfg.LLMConfig(max_retries=0),
                                          backend=JaxMock(responder=Down()))).run(jc)
    got = ttpl.TemplateLLMAgent(LLMClient(LLMConfig(max_retries=0),
                                          backend=MockLLMBackend(responder=Down()))).run(tc)
    assert got.status is AgentStatus.PARTIAL and got.data == ref.data and got.data
    assert got.warnings and ref.warnings


# ---------------------------------------------------------------- templates 3 and 4
@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    return make_stacks(tmp_path_factory.mktemp("tpl"), docs=BIG_DOCS[:24])


def _agents(stacks, cls_name, **kw):
    (_, js, _, jm), (_, ts, _, tm) = stacks["j"], stacks["t"]
    return getattr(jtpl, cls_name)(js, jm, **kw), getattr(ttpl, cls_name)(ts, tm, **kw)


def _ids(docs):
    return [d.doc_id for d, _ in docs]


def test_retrieval_template_matches_jax(stacks):
    ja, ta = _agents(stacks, "TemplateRetrievalAgent", min_similarity=-1.0)
    (jc, tc) = ctxs("mitochondria energy")
    jc.effective_queries = tc.effective_queries = ["mitochondria energy", "golgi transport"]
    ref, got = ja.run(jc, top_k=6), ta.run(tc, top_k=6)
    assert got.status is AgentStatus.SUCCESS and _ids(got.data) == _ids(ref.data)
    np.testing.assert_allclose([s for _, s in got.data], [s for _, s in ref.data],
                               rtol=1e-5, atol=1e-6)
    assert tc.dense_docs == got.data and len(set(_ids(got.data))) == len(got.data) == 6


@pytest.mark.parametrize("n,k,lam", [(12, 5, 0.7), (30, 10, 0.5), (8, 8, 0.0), (16, 4, 1.0),
                                     (40, 1, 0.3)])
def test_mmr_select_matches_jax(n, k, lam):
    import jax.numpy as jnp

    rng = np.random.default_rng(n * 100 + k)
    vecs = rng.standard_normal((n, 24)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    qv = vecs[0] + 0.1 * rng.standard_normal(24).astype(np.float32)
    ref = np.asarray(jtpl._mmr_select(jnp.asarray(vecs), jnp.asarray(qv), jnp.float32(lam), k))
    got = ttpl._mmr_select(torch.from_numpy(vecs), torch.from_numpy(qv), lam, k)
    assert got.dtype == torch.int64 and got.tolist() == ref.tolist()
    assert len(set(got.tolist())) == k


@pytest.mark.parametrize("lam", [0.7, 1.0])
def test_mmr_first_pick_ignores_relevance_as_jax(lam):
    """A trap of the reference kept for parity (ROADMAP C): `max_sim`
    starts at -inf, so the first step's scores are all +inf (NaN at
    lam = 1) and both packages pick index 0 first, though the query is
    nearest to another doc. A fix in both packages changes this pin."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((10, 16)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    qv = vecs[6].copy()
    assert int(np.argmax(vecs @ qv)) == 6
    ref = np.asarray(jtpl._mmr_select(jnp.asarray(vecs), jnp.asarray(qv), jnp.float32(lam), 3))
    got = ttpl._mmr_select(torch.from_numpy(vecs), torch.from_numpy(qv), lam, 3)
    assert got.tolist() == ref.tolist() and got.tolist()[0] == 0


def _seeded(stacks, q="mitochondria energy", k=8):
    ja, ta = _agents(stacks, "TemplateRetrievalAgent", min_similarity=-1.0)
    (jc, tc) = ctxs(q)
    ja.run(jc, top_k=k)
    ta.run(tc, top_k=k)
    jc.fused_docs, tc.fused_docs = jc.dense_docs, tc.dense_docs
    return jc, tc


def test_device_op_template_mmr_matches_jax(stacks):
    jc, tc = _seeded(stacks)
    for lam, k in ((0.7, 4), (0.3, 6), (0.9, 1)):
        ja, ta = _agents(stacks, "TemplateDeviceOpAgent", lam=lam)
        ref, got = ja.run(jc, top_k=k), ta.run(tc, top_k=k)
        assert got.status is AgentStatus.SUCCESS and _ids(got.data) == _ids(ref.data)
        assert len(set(_ids(got.data))) == len(got.data) == k
    ja, ta = _agents(stacks, "TemplateDeviceOpAgent", enabled=False)
    assert ta.run(tc).status is AgentStatus.SKIPPED and ta.run(tc).data is None


def test_device_op_template_raises_a_device_failure(stacks):
    """A failure inside the device stage (here the embed) raises out of
    run(); the JAX template degrades it to the input order."""
    jc, tc = _seeded(stacks)
    ja, ta = _agents(stacks, "TemplateDeviceOpAgent")

    def boom(*a, **k):
        raise RuntimeError("embedder exploded")

    ja._embed_batch = ta._embed_batch = boom
    ref = ja.run(jc, top_k=2)
    assert ref.status.value == "partial" and _ids(ref.data) == _ids(jc.fused_docs[:2])
    with pytest.raises(DeviceStageError, match="mmr selection: RuntimeError: embedder exploded"):
        ta.run(tc, top_k=2)
    ra, rt = _agents(stacks, "TemplateRetrievalAgent")
    rt._embed_batch = boom
    with pytest.raises(DeviceStageError, match="template retrieval"):
        rt.run(tc)


def test_device_op_template_falls_back_off_the_card(stacks):
    """A failure outside the device stage (a doc without text) takes the
    input-order fallback, as in the JAX package."""
    jc, tc = _seeded(stacks)

    class NoText:
        doc_id = "broken"

        @property
        def content(self):
            raise ValueError("no text")

    jc.fused_docs = jc.fused_docs[:3] + [(NoText(), 0.1)]
    tc.fused_docs = tc.fused_docs[:3] + [(NoText(), 0.1)]
    ja, ta = _agents(stacks, "TemplateDeviceOpAgent")
    ref, got = ja.run(jc, top_k=2), ta.run(tc, top_k=2)
    assert got.status is AgentStatus.PARTIAL and got.status.value == ref.status.value
    assert _ids(got.data) == _ids(ref.data) == _ids(tc.fused_docs[:2])


# ---------------------------------------------------------------- chunking and processors
PROSE = " ".join(f"Sentence {i} talks about the river and the hills at dusk." for i in range(60))
MARKDOWN = "\n\n".join(f"# Part {i}\n\n" + "Some words here. " * (5 + 20 * (i % 3))
                       for i in range(8))
CODE = "\n".join(f"def f{i}(x):\n    return x + {i}\n\n\nclass C{i}:\n    pass\n"
                 for i in range(40))


@pytest.mark.parametrize("text", [PROSE, MARKDOWN, CODE, "", "short text"],
                         ids=["prose", "markdown", "code", "empty", "short"])
def test_chunking_rules_match_jax(text):
    for kw in ({}, {"target_chunk_size": 300, "max_chunk_size": 500}):
        ref = jchunk.IntelligentChunkingAgent(**kw).chunk(text)
        got = tchunk.IntelligentChunkingAgent(**kw).chunk(text)
        assert [(c.content, c.index, c.doc_type) for c in got] == \
            [(c.content, c.index, c.doc_type) for c in ref]
    assert tchunk.IntelligentChunkingAgent.detect_doc_type(text) == \
        jchunk.IntelligentChunkingAgent.detect_doc_type(text)


def test_llm_chunking_matches_jax():
    for reply in ("[700, 1500, 99999, -3, 1500, \"x\"]", "[10]", "not json", "[]"):
        jllm, tllm = llms({"Propose character offsets": reply})
        ref = jchunk.IntelligentChunkingAgent(jllm, llm_threshold=100).chunk(PROSE)
        got = tchunk.IntelligentChunkingAgent(tllm, llm_threshold=100).chunk(PROSE)
        assert [(c.content, c.index, c.doc_type) for c in got] == \
            [(c.content, c.index, c.doc_type) for c in ref]


def _files(d):
    d.mkdir(parents=True, exist_ok=True)
    (d / "prose.txt").write_text(PROSE)
    (d / "notes.md").write_text(MARKDOWN)
    (d / "de.txt").write_text("Der Hund ist nicht auf der Straße, und das ist gut so. "
                              "Die Katze schläft im Haus, während es draußen regnet.")
    (d / "en.txt").write_text("The dog is not on the street and that is good for everyone.")
    return d


def test_intelligent_processor_matches_jax(tmp_path):
    d = _files(tmp_path / "docs")
    jllm, tllm = llms({"Propose character offsets": "[500, 1200]"})
    for jagent, tagent in ((jchunk.IntelligentChunkingAgent(), tchunk.IntelligentChunkingAgent()),
                           (jchunk.IntelligentChunkingAgent(jllm, llm_threshold=200),
                            tchunk.IntelligentChunkingAgent(tllm, llm_threshold=200))):
        ref = jproc.IntelligentDocumentProcessor(jagent, chunk_size=400).process_paths([str(d)])
        got = tproc.IntelligentDocumentProcessor(tagent, chunk_size=400).process_paths([str(d)])
        assert [(c.content, c.meta) for c in got] == [(c.content, c.meta) for c in ref]
        assert len(got) > 4


def test_translating_processor_matches_jax(tmp_path):
    d = _files(tmp_path / "docs")

    def responder(messages):
        last = messages[-1]["content"]
        if "from German to English" in last:
            return "The dog is not on the street. The cat sleeps in the house."
        raise RuntimeError("unexpected translation")

    from radiant_rag_tpu import config as jcfg
    from radiant_rag_tpu.llm.backends import MockLLMBackend as JaxMock
    from radiant_rag_tpu.llm.client import LLMClient as JaxClient
    from radiant_rag_tpu_torch.config import LLMConfig
    from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
    from radiant_rag_tpu_torch.llm.client import LLMClient

    jllm = JaxClient(jcfg.LLMConfig(max_retries=0), backend=JaxMock(responder=responder))
    tllm = LLMClient(LLMConfig(max_retries=0), backend=MockLLMBackend(responder=responder))
    for path in (d, d / "de.txt"):
        ref = jproc.TranslatingDocumentProcessor(JaxDetector(), JaxTranslator(jllm)) \
            .process_paths([str(path)])
        got = tproc.TranslatingDocumentProcessor(LanguageDetectionAgent(),
                                                 TranslationAgent(tllm)).process_paths([str(path)])
        assert [(c.content, c.meta) for c in got] == [(c.content, c.meta) for c in ref]
    de = [c for c in got if c.meta.get("original_language") == "de"]
    assert de and de[0].content.startswith("The dog") and de[0].meta["language_code"] == "en"
    assert "Straße" in de[0].meta["original_content"]
    # a translation that fails keeps the original text, in both packages
    down = tproc.TranslatingDocumentProcessor(LanguageDetectionAgent(), TranslationAgent(
        LLMClient(LLMConfig(max_retries=0), backend=MockLLMBackend(
            responder=lambda m: (_ for _ in ()).throw(RuntimeError("down"))))))
    kept = down.process_paths([str(d / "de.txt")])
    assert kept[0].content.startswith("Der Hund") and kept[0].meta["language_code"] == "de"
