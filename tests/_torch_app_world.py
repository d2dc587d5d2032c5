"""Shared world of the app and server parity tests: both packages' apps
over equal configs, equal embedder weights, the same mock LLM and the same
documents, and the comparison of their hit lists (tolerance:
tests/_torch_parity.py)."""

import json

import numpy as np

from radiant_rag_tpu import config as jcfg
from radiant_rag_tpu.app import RadiantTPU as JaxApp
from radiant_rag_tpu.llm.backends import MockLLMBackend
from radiant_rag_tpu.llm.client import LLMClient
from radiant_rag_tpu.models.embedder import Embedder as JaxEmbedder
from radiant_rag_tpu.models.registry import LocalNLPModels as JaxModels
from radiant_rag_tpu_torch import config as tcfg
from radiant_rag_tpu_torch.app import RadiantTPU
from radiant_rag_tpu_torch.llm.backends import MockLLMBackend as TorchMock
from radiant_rag_tpu_torch.llm.client import LLMClient as TorchClient
from radiant_rag_tpu_torch.models.embedder import Embedder
from radiant_rag_tpu_torch.models.registry import LocalNLPModels

from _torch_parity import assert_rows_match

EMB = dict(preset="none", dim=32, num_layers=1, num_heads=2, hidden_dim=64, vocab_size=500,
           max_seq_len=32, batch_size=64, dtype="float32", checkpoint_dir="")
# the cross-encoder's architecture (float32, the JAX weights carried across)
CE = dict(vocab_size=500, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)
WORDS = ("solar panel energy light cell power wind turbine battery grid voltage current "
         "photon lens laser mirror crystal signal noise filter memory cache index query "
         "vector search batch device kernel thread score rank token").split()
QUERIES = ["solar panel energy", "laser light crystal", "memory cache index", "wind turbine",
           "vector search query", "signal noise filter", "battery grid voltage", "kernel thread",
           "photon lens mirror", "token rank score", "device batch", "power current"]


def _sections(mod, tmp, **over):
    """The sections both packages read, as each package's dataclasses."""
    return dict(
        index=mod.IndexConfig(dim=32, initial_capacity=256, data_dir=str(tmp / "idx"),
                              **over.get("index", {})),
        embedding=mod.EmbeddingConfig(**EMB),
        bm25=mod.BM25Config(index_path=str(tmp / "bm25.json.gz"), sketch_dim=128),
        retrieval=mod.RetrievalConfig(calibration_probes=32),
        server=mod.ServerConfig(max_batch=16, max_wait_ms=20.0),
        cross_encoder=mod.CrossEncoderConfig(max_seq_len=64, batch_size=16),
    )


def make_apps(tmp, responder=None, **over):
    """(JAX app, port app) over equal configs and equal embedder weights,
    each with a mock LLM (`responder(messages)`, else the mock's "ok")."""
    import jax
    import jax.numpy as jnp
    import torch

    from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
    from radiant_rag_tpu.models.cross_encoder import CrossEncoder as JaxCrossEncoder
    from radiant_rag_tpu_torch.convert import bert_params_from_jax, cross_encoder_params_from_jax
    from radiant_rag_tpu_torch.models.bert import BertConfig
    from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder

    jconf, tconf = (mod.AppConfig(**_sections(mod, tmp / key, **over),
                                  conversation=mod.ConversationConfig(data_dir=str(tmp / key / "c")),
                                  strategy_memory=mod.StrategyMemoryConfig(
                                      path=str(tmp / key / "sm.json.gz")))
                    for mod, key in ((jcfg, "j"), (tcfg, "t")))
    jemb = JaxEmbedder(jconf.embedding, seed=4)
    params = bert_params_from_jax(jax.tree.map(np.asarray, jemb.params))
    temb = Embedder(tconf.embedding, device="cpu", params=params)
    jce = JaxCrossEncoder(jconf.cross_encoder, bert_cfg=JaxBertConfig(dtype=jnp.float32, **CE),
                          seed=3)
    tce = CrossEncoder(tconf.cross_encoder, bert_cfg=BertConfig(dtype=torch.float32, **CE),
                       params=cross_encoder_params_from_jax(jax.tree.map(np.asarray, jce.params)),
                       device="cpu")
    japp = JaxApp(config=jconf, llm=LLMClient(backend=MockLLMBackend(responder=responder)),
                  local_models=JaxModels(jconf, embedder=jemb, cross_encoder=jce))
    tapp_ = RadiantTPU(tconf, llm=TorchClient(backend=TorchMock(responder=responder)),
                       local_models=LocalNLPModels(tconf, embedder=temb, cross_encoder=tce),
                       device="cpu")
    return japp, tapp_


def write_docs(d, n_files=30, seed=7):
    """Text files of zipfian words (about 5 leaf chunks each) and one file
    of each other type the processor reads without optional libraries."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        words = [WORDS[z % len(WORDS)] for z in rng.zipf(1.4, 420)]
        sents = [" ".join(words[s:s + 14]).capitalize() + "." for s in range(0, 420, 14)]
        (d / f"doc{i:02d}.txt").write_text(f"Document {i} about {WORDS[i]}. " + " ".join(sents))
    (d / "notes.md").write_text("# Lasers\n\nA laser emits coherent light through a crystal.\n\n"
                                "## Memory\n\nThe cache keeps the index in device memory.\n")
    (d / "page.html").write_text("<html><head><title>Wind</title><style>x{}</style></head>"
                                 "<body><p>Wind turbines make power for the grid.</p>"
                                 "<script>var a;</script><p>Batteries store it.</p></body></html>")
    (d / "table.csv").write_text("name,part\nturbine,blade\npanel,photon cell\nlaser,mirror\n")
    (d / "records.json").write_text(json.dumps(
        [{"title": "Filter", "text": "A filter removes signal noise from the current."},
         {"title": "Kernel", "text": "A kernel thread scores every token in the batch."}]))
    (d / "tool.py").write_text("import os\n\n\ndef rank(scores):\n    \"\"\"Rank the scores of "
                               "a query.\"\"\"\n    return sorted(scores)\n\n\nclass Index:\n"
                               "    def search(self, vector):\n        return [vector]\n")
    return d


def _hits_as_rows(ref_hits, got_hits):
    """Per-query (doc-id code, score) arrays of two hit lists (equal lengths)."""
    codes = {}
    ref_rows, got_rows, ref_s, got_s = [], [], [], []
    width = max([len(h) for h in ref_hits + got_hits] + [1])
    for r, g in zip(ref_hits, got_hits):
        assert len(r) == len(g), ([d.doc_id for d, _ in r], [d.doc_id for d, _ in g])
        for hits, rows, scores in ((r, ref_rows, ref_s), (g, got_rows, got_s)):
            ids = [codes.setdefault(d.doc_id, len(codes)) for d, _ in hits]
            rows.append(ids + [-1] * (width - len(ids)))
            scores.append([s for _, s in hits] + [0.0] * (width - len(ids)))
    return np.asarray(ref_rows), np.asarray(ref_s), np.asarray(got_rows), np.asarray(got_s)


def assert_hits_match(ref_hits, got_hits, what=""):
    ref_rows, ref_s, got_rows, got_s = _hits_as_rows(ref_hits, got_hits)
    assert_rows_match(ref_rows, ref_s, got_rows, got_s, what)


