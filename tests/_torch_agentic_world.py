"""Shared world of the agentic parity tests: the JAX package's and the port's
pipeline stacks over equal configs, equal weights and the same documents,
one scripted LLM responder that drives both, and the comparison of two runs.

Each stack is (config, store, BM25 index, local models) of its package:
a 2-layer, 64-wide float32 embedder and cross-encoder (the JAX weights
carried across with `convert.bert_params_from_jax` /
`cross_encoder_params_from_jax`), a `TpuVectorStore` holding the JAX
embeddings of the documents, and a `PersistentBM25Index` built from it.
The corpora are smaller than the hybrid's stage-1 depth (kc = 240), so
every stage 1, binary included, keeps every row (tests/test_torch_app.py).

Tolerance (tests/_torch_parity.py): doc ids in the same order and scores
within rtol 1e-5 / atol 1e-6, a swap allowed only between docs whose
reference scores tie within that; everything else a run returns (answer,
plan, effective queries, retry count, confidence, citations, fact
verification) exactly equal.
"""

import itertools
import json

import numpy as np

from radiant_rag_tpu import config as jcfg
from radiant_rag_tpu.index.bm25 import PersistentBM25Index as JaxBM25
from radiant_rag_tpu.index.store import TpuVectorStore as JaxStore
from radiant_rag_tpu.llm.backends import MockLLMBackend as JaxMock
from radiant_rag_tpu.llm.client import LLMClient as JaxClient
from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
from radiant_rag_tpu.models.cross_encoder import CrossEncoder as JaxCrossEncoder
from radiant_rag_tpu.models.embedder import Embedder as JaxEmbedder
from radiant_rag_tpu.models.registry import LocalNLPModels as JaxModels
from radiant_rag_tpu_torch import config as tcfg
from radiant_rag_tpu_torch.index.bm25 import PersistentBM25Index
from radiant_rag_tpu_torch.index.store import TpuVectorStore
from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
from radiant_rag_tpu_torch.llm.client import LLMClient
from radiant_rag_tpu_torch.models.bert import BertConfig
from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
from radiant_rag_tpu_torch.models.embedder import Embedder
from radiant_rag_tpu_torch.models.registry import LocalNLPModels

from _torch_app_world import assert_hits_match

DOCS = [
    "The mitochondria is the powerhouse of the cell, producing ATP through respiration.",
    "Photosynthesis converts sunlight into chemical energy in plant chloroplasts.",
    "The cell nucleus contains DNA organized into chromosomes.",
    "Ribosomes synthesize proteins by translating messenger RNA.",
    "The Golgi apparatus packages proteins for transport out of the cell.",
    "ATP is the energy currency used by all living cells.",
]
TOPICS = ["mitochondria energy", "photosynthesis light", "nucleus dna", "ribosome protein",
          "golgi transport", "membrane lipid"]
BIG_DOCS = [f"Document {i} about {TOPICS[i % len(TOPICS)]} with unique token zq{i} "
            "describing cellular biology mechanisms in detail." for i in range(96)]
ARCH = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128)
EMB = dict(dim=64, num_layers=2, num_heads=4, hidden_dim=128, vocab_size=1000, max_seq_len=64,
           batch_size=8, dtype="float32", checkpoint_dir="")

GOOD_CRITIQUE = json.dumps({
    "ok": True, "confidence": 0.9, "relevance": 9, "faithfulness": 9,
    "coverage": 8, "issues": [], "should_retry": False, "issue_type": "none",
})
RETRY_CRITIQUE = json.dumps({
    "ok": False, "confidence": 0.3, "relevance": 3, "faithfulness": 4, "coverage": 2,
    "issues": ["missing context"], "should_retry": True, "issue_type": "context",
})
BAD_CRITIQUE = json.dumps({
    "ok": False, "confidence": 0.1, "relevance": 1, "faithfulness": 1,
    "coverage": 1, "issues": ["hopeless"], "should_retry": True, "issue_type": "answer",
})
DEFAULT_PLAN = {
    "use_decomposition": False, "use_rewrite": False, "use_expansion": False,
    "use_rrf": True, "use_automerge": True, "use_rerank": True,
    "use_critic": True, "use_web_search": False, "use_multihop": False,
    "retrieval_mode": "hybrid", "tools_to_use": [],
}


def plan(**over) -> str:
    return json.dumps({**DEFAULT_PLAN, **over})


class Responder:
    """A deterministic scripted LLM keyed on the agents' fixed prompt
    phrases. `script` maps a phrase of the last message to a reply (or to a
    list of replies, one per call, the last repeated). One instance per
    package: its calls are counted per package."""

    def __init__(self, script=None):
        self.script = dict(script or {})
        self.counts = {}

    def __call__(self, messages):
        last = messages[-1]["content"]
        for key, reply in self.script.items():
            if key in last:
                n = self.counts.get(key, 0)
                self.counts[key] = n + 1
                return reply[min(n, len(reply) - 1)] if isinstance(reply, list) else reply
        if "query-planning agent" in last:
            return plan()
        if "Evaluate this answer" in last:
            return GOOD_CRITIQUE
        if ("Rewrite each query" in last or "alternative phrasings" in last
                or "Which tools" in last):
            return "[]"
        if "atomic factual claims" in last:
            return '["Mitochondria produce ATP."]'
        if "For each claim" in last:
            return '[{"status": "supported", "evidence": "ATP", "confidence": 0.9}]'
        if "Match each answer sentence" in last:
            return '[{"sources": ["1"], "confidence": 0.8}]'
        if "Context:" in last and "Question:" in last:
            return "Mitochondria produce ATP, the cell's energy currency [DOC 1]."
        return "ok"


def llms(script=None, **client_kw):
    """(JAX client, port client), each over its package's mock backend
    driven by its own Responder of the same script."""
    jr, tr = Responder(script), Responder(script)
    return (JaxClient(jcfg.LLMConfig(**client_kw), backend=JaxMock(responder=jr)),
            LLMClient(tcfg.LLMConfig(**client_kw), backend=MockLLMBackend(responder=tr)))


def _config(mod, tmp, **over):
    return mod.AppConfig(
        index=mod.IndexConfig(dim=64, initial_capacity=256, data_dir=str(tmp / "idx")),
        embedding=mod.EmbeddingConfig(**EMB),
        cross_encoder=mod.CrossEncoderConfig(max_seq_len=64, batch_size=16),
        strategy_memory=mod.StrategyMemoryConfig(path=str(tmp / "sm.json.gz")),
        conversation=mod.ConversationConfig(data_dir=str(tmp / "conv")),
        **over)


def make_stacks(tmp, docs=DOCS):
    """{"j": (cfg, store, bm25, models), "t": ...} over the same documents."""
    import jax
    import jax.numpy as jnp
    import torch

    from radiant_rag_tpu_torch.convert import bert_params_from_jax, cross_encoder_params_from_jax

    jconf, tconf = _config(jcfg, tmp / "j"), _config(tcfg, tmp / "t")
    jemb = JaxEmbedder(jconf.embedding, seed=4)
    jce = JaxCrossEncoder(jconf.cross_encoder, bert_cfg=JaxBertConfig(dtype=jnp.float32, **ARCH),
                          seed=3)
    jmodels = JaxModels(jconf, embedder=jemb, cross_encoder=jce)
    temb = Embedder(tconf.embedding, device="cpu",
                    params=bert_params_from_jax(jax.tree.map(np.asarray, jemb.params)))
    tce = CrossEncoder(tconf.cross_encoder, bert_cfg=BertConfig(dtype=torch.float32, **ARCH),
                       params=cross_encoder_params_from_jax(jax.tree.map(np.asarray, jce.params)),
                       device="cpu")
    tmodels = LocalNLPModels(tconf, embedder=temb, cross_encoder=tce)
    embs = np.asarray(jmodels.embed(docs), np.float32)
    triples = [(text, {"source": f"doc{i}.txt"}, embs[i]) for i, text in enumerate(docs)]
    jstore = JaxStore(dim=64, index_config=jconf.index, quantization=jconf.quantization)
    tstore = TpuVectorStore(dim=64, index_config=tconf.index, quantization=tconf.quantization,
                            device="cpu")
    jstore.upsert_batch(triples)
    tstore.upsert_batch(triples)
    jbm = JaxBM25(jstore, path=str(tmp / "j" / "bm25.json.gz"))
    tbm = PersistentBM25Index(tstore, path=str(tmp / "t" / "bm25.json.gz"), device="cpu")
    jbm.build_from_store()
    tbm.build_from_store()
    return {"j": (jconf, jstore, jbm, jmodels), "t": (tconf, tstore, tbm, tmodels)}


def replace_sections(cfg, **sections):
    """cfg with whole sections replaced by fields: {"rerank": {...}}."""
    import dataclasses

    return dataclasses.replace(cfg, **{name: dataclasses.replace(getattr(cfg, name), **fields)
                                       for name, fields in sections.items()})


_MEMORIES = itertools.count()


def orchestrators(stacks, script=None, sections=None, llm_kw=None, models=None):
    """(JAX orchestrator, port orchestrator) over the stacks, each with its
    own fresh LLM client of `script`, its own fresh strategy-memory file
    (unless `sections` names one), the config sections replaced, and
    optionally other local models ({"j": ..., "t": ...})."""
    from radiant_rag_tpu.orchestrator import RAGOrchestrator as JaxOrchestrator
    from radiant_rag_tpu_torch.orchestrator import RAGOrchestrator

    jllm, tllm = llms(script, **(llm_kw or {}))
    out = []
    for key, make, client in (("j", JaxOrchestrator, jllm), ("t", RAGOrchestrator, tllm)):
        cfg, store, bm25, local = stacks[key]
        over = {"strategy_memory": {"path": f"{cfg.strategy_memory.path}.{next(_MEMORIES)}"},
                **(sections or {})}
        out.append(make(replace_sections(cfg, **over), store, bm25,
                        (models or {}).get(key, local), client))
    return tuple(out)


def _ids(docs):
    return [d.doc_id for d, _ in docs]


def assert_runs_match(ref, got):
    """Two PipelineResults of the same question (module doc)."""
    for key in ("query", "answer", "success", "plan", "effective_queries", "retry_count",
                "confidence", "low_confidence", "critic_notes", "fact_verification",
                "tool_results", "warnings", "degraded"):
        assert getattr(got, key) == getattr(ref, key), (key, getattr(ref, key),
                                                        getattr(got, key))
    cites = [{k: v for k, v in c.citations.items() if k != "audit_id"} for c in (ref, got)]
    assert cites[1] == cites[0]
    assert bool(got.citations.get("audit_id")) == bool(ref.citations.get("audit_id"))
    for leg in ("dense_docs", "bm25_docs", "fused_docs", "reranked_docs", "docs"):
        assert_hits_match([getattr(ref, leg)], [getattr(got, leg)], leg)
    assert [s["name"] for s in got.metrics["steps"]] == [s["name"] for s in ref.metrics["steps"]]
