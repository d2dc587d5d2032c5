"""The pluggable embedding and reranking backends (`llm/model_backends.py`)
against the JAX package's on the CPU, as tests/test_local_llm.py and
tests/test_agents.py hold the JAX ones: the same tiny HF BERT (built here
and saved to disk, no network) through both packages'
TransformersEmbeddingBackend, the same mock LLM through both
LLMRerankingBackends, the same loopback endpoint through both
OpenAI-compatible backends, and the built-in encoder's backend with the
JAX weights carried across. Embeddings equal within rtol 1e-5 / atol
1e-6 (float32, device "cpu"); rankings and scores equal exactly."""

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from radiant_rag_tpu import config as jcfg
from radiant_rag_tpu.llm import model_backends as jmb
from radiant_rag_tpu.llm.backends import MockLLMBackend as JaxMock
from radiant_rag_tpu.llm.client import LLMClient as JaxClient
from radiant_rag_tpu.models.embedder import Embedder as JaxEmbedder
from radiant_rag_tpu_torch import config as tcfg
from radiant_rag_tpu_torch.convert import bert_params_from_jax
from radiant_rag_tpu_torch.llm import model_backends as tmb
from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
from radiant_rag_tpu_torch.llm.client import LLMClient
from radiant_rag_tpu_torch.models.embedder import Embedder

TOL = dict(rtol=1e-5, atol=1e-6)
TEXTS = ["hello world", "laser light", "the a hello", "world laser the light a"]
SMALL = dict(dim=32, num_layers=1, num_heads=2, hidden_dim=64, vocab_size=500, max_seq_len=32,
             batch_size=4, preset="none", checkpoint_dir="", dtype="float32")


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """A tiny HF BertModel and a word-level tokenizer saved to disk."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import BertConfig as HFBertConfig, BertModel, PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("bert")
    cfg = HFBertConfig(vocab_size=60, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                       intermediate_size=64, max_position_embeddings=64)
    torch.manual_seed(0)
    BertModel(cfg).eval().save_pretrained(str(d))
    words = ["[UNK]", "[PAD]", "hello", "world", "laser", "light", "a", "the"]
    tok = Tokenizer(WordLevel({w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                            pad_token="[PAD]").save_pretrained(str(d))
    return str(d)


@pytest.mark.parametrize("pooling,normalize,batch_size", [
    ("mean", True, 2), ("mean", True, 8), ("cls", True, 3), ("mean", False, 2)])
def test_transformers_embedding_backend_equals_jax(bert_dir, pooling, normalize, batch_size):
    got_be = tmb.TransformersEmbeddingBackend(bert_dir, pooling=pooling, normalize=normalize,
                                              batch_size=batch_size, device="cpu")
    ref_be = jmb.TransformersEmbeddingBackend(bert_dir, pooling=pooling, normalize=normalize,
                                              batch_size=batch_size)
    got = got_be.embed(TEXTS)
    np.testing.assert_allclose(got, ref_be.embed(TEXTS), **TOL)
    assert got.shape == (4, 32) and got.dtype == np.float32
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    assert got_be.embedding_dimension() == ref_be.embedding_dimension() == 32
    np.testing.assert_allclose(got_be.embed_single("hello world"), got[0], **TOL)


def test_transformers_backend_refuses_a_pooling_and_defaults_to_the_card(bert_dir):
    with pytest.raises(ValueError, match="mean|cls"):
        tmb.TransformersEmbeddingBackend(bert_dir, pooling="max", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmb.TransformersEmbeddingBackend(bert_dir)


def test_embedding_factory_builds_each_backend_as_jax(bert_dir):
    """'transformers' (lazy: nothing loaded), 'openai_compatible' and the
    built-in 'jax' backend, from configurations both packages parse."""
    for kind, want in (("transformers", "TransformersEmbeddingBackend"),
                       ("openai_compatible", "OpenAICompatibleEmbeddingBackend")):
        data = {"embedding": {"backend": kind, "weights_path": bert_dir,
                              "model_name": "bge-small"}}
        tconf = tcfg.config_from_dict(data)
        jconf = jcfg.AppConfig(embedding=jcfg.EmbeddingConfig(
            backend=kind, weights_path=bert_dir, model_name="bge-small"))
        got = tmb.create_embedding_backend(tconf, device="cpu")
        ref = jmb.create_embedding_backend(jconf)
        assert type(got).__name__ == type(ref).__name__ == want
        if kind == "transformers":
            assert got.model_path == ref.model_path == bert_dir and got._model is None
            assert got.max_seq_len == ref.max_seq_len and got.batch_size == ref.batch_size
        else:
            assert (got.base_url, got.model, got.embedding_dimension) == \
                (ref.base_url, ref.model, ref.embedding_dimension)


def test_builtin_embedding_backend_equals_jax():
    """The port's Embedder with the JAX weights behind the 'jax' key,
    also importable as JaxEmbeddingBackend."""
    jconf = dataclasses.replace(jcfg.AppConfig(), embedding=jcfg.EmbeddingConfig(**SMALL))
    jemb = JaxEmbedder(jconf.embedding, seed=4)
    tconf = tcfg.config_from_dict({"embedding": SMALL})
    temb = Embedder(tconf.embedding, device="cpu",
                    params=bert_params_from_jax(jax.tree.map(np.asarray, jemb.params)))
    got = tmb.create_embedding_backend(tconf, embedder=temb)
    assert isinstance(got, tmb.JaxEmbeddingBackend) and tmb.JaxEmbeddingBackend is \
        tmb.TorchEmbeddingBackend
    ref = jmb.create_embedding_backend(jconf, embedder=jemb)
    np.testing.assert_allclose(got.embed(TEXTS), ref.embed(TEXTS), rtol=1e-5, atol=1e-5)
    assert got.embedding_dimension == ref.embedding_dimension == 32


class _Embeddings(BaseHTTPRequestHandler):
    """POST /embeddings: a vector per input from its characters, answered
    out of order (the backends sort by index)."""

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        data = [{"index": i, "embedding": [float(len(t)), float(sum(map(ord, t)) % 97), 1.0]}
                for i, t in enumerate(body["input"])]
        out = json.dumps({"data": data[::-1], "model": body["model"]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *args):
        pass


def test_openai_compatible_embedding_backend_equals_jax():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Embeddings)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/"
        got = tmb.OpenAICompatibleEmbeddingBackend(url, "m", dimension=3).embed(TEXTS)
        ref = jmb.OpenAICompatibleEmbeddingBackend(url, "m", dimension=3).embed(TEXTS)
        np.testing.assert_array_equal(got, ref)
        assert got.shape == (4, 3) and got[0, 0] == len(TEXTS[0])
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("reply,top_k", [("[2, 9, 5]", None), ("[2, 9, 5]", 2),
                                         ("[1, \"x\"]", None), ("not json", None)])
def test_llm_reranking_backend_equals_jax(reply, top_k):
    got = tmb.LLMRerankingBackend(LLMClient(backend=MockLLMBackend(default=reply)))
    ref = jmb.LLMRerankingBackend(JaxClient(backend=JaxMock(default=reply)))
    docs = ["a", "b", "c"]
    assert got.rerank("q", docs, top_k=top_k) == ref.rerank("q", docs, top_k=top_k)
    if reply == "[2, 9, 5]":
        assert [i for i, _ in got.rerank("q", docs)] == [1, 2, 0]


def test_reranking_factory_as_jax():
    """cross_encoder.backend 'llm' builds the LLM-prompted reranker (an LLM
    client is required), the default the built-in cross-encoder's."""
    tconf = tcfg.config_from_dict({"cross_encoder": {"backend": "llm"}})
    client = LLMClient(backend=MockLLMBackend(default="[3, 1]"))
    got = tmb.create_reranking_backend(tconf, llm=client)
    assert isinstance(got, tmb.LLMRerankingBackend)
    assert got.rerank("q", ["x", "y"]) == [(0, 3.0), (1, 1.0)]
    for mod, conf in ((tmb, tconf), (jmb, jcfg.AppConfig(
            cross_encoder=jcfg.CrossEncoderConfig(backend="llm")))):
        with pytest.raises(ValueError, match="requires an LLM client"):
            mod.create_reranking_backend(conf)

    class CE:
        def rerank(self, query, docs, top_k=None, max_chars=3000):
            return [(len(docs) - 1, float(max_chars))][:top_k]

    default = tmb.create_reranking_backend(tcfg.config_from_dict({}), cross_encoder=CE())
    assert isinstance(default, tmb.JaxRerankingBackend)
    assert default.rerank("q", ["a", "b"], top_k=1, max_chars=7) == [(1, 7.0)]


@pytest.mark.parametrize("section,backend", [("embedding", "transformers"),
                                             ("embedding", "openai_compatible"),
                                             ("cross_encoder", "llm"), (None, None)])
def test_app_says_it_serves_the_built_in_encoder_for_another_backend(caplog, section, backend):
    """embedding.backend / cross_encoder.backend reach only the factories:
    the app's models say so when a config names another backend, and say
    nothing at the defaults."""
    from types import SimpleNamespace

    from radiant_rag_tpu_torch.models.registry import LocalNLPModels

    cfg = tcfg.config_from_dict({section: {"backend": backend}} if section else {})
    with caplog.at_level("WARNING", logger="radiant_rag_tpu_torch.models.registry"):
        LocalNLPModels(cfg, embedder=SimpleNamespace(device=torch.device("cpu")))
    if section is None:
        assert "backend" not in caplog.text
    else:
        assert f"{section}.backend '{backend}'" in caplog.text
        assert "serves the built-in encoder" in caplog.text
