"""Import hygiene of the PyTorch port: it imports neither jax nor any module
of the JAX package, and its entry points refuse to fall back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
import radiant_rag_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "radiant_rag_tpu" or m.startswith("radiant_rag_tpu.")]
assert not bad, bad
new = {"config", "index.base", "index.doc", "index.docstore", "index.factory", "index.graph",
       "index.numpy_store", "index.store", "models", "models.bert", "models.cross_encoder",
       "models.device_rerank", "models.embedder", "models.hf_loading", "models.pretrained",
       "models.registry", "models.tokenizer", "utils.cache", "app", "server", "orchestrator",
       "__main__", "utils.batching", "utils.metrics", "utils.logging", "parallel.data",
       "ingestion.processor", "ingestion.json_parser", "ingestion.code_chunker",
       "llm", "llm.json_parser", "llm.backends", "llm.client", "agents", "agents.base",
       "agents.base_agent", "agents.retrieval", "agents.fusion", "agents.automerge",
       "agents.rerank", "agents.planning", "agents.strategy_memory", "agents.query_processing",
       "agents.context_eval", "agents.summarization", "agents.synthesis", "agents.critic",
       "agents.multihop", "agents.fact_verification", "agents.citation", "agents.tools",
       "utils.conversation", "parallel.train", "parallel.checkpoint", "parallel.mesh",
       "parallel.sharded_index", "parallel.sharded_store", "parallel.multihost",
       "agents.lang_profiles", "agents.language", "ingestion.web_crawler",
       "ingestion.github_crawler", "agents.web_search", "agents.chunking",
       "utils.metrics_export", "ui", "ui.display", "ui.reports", "ui.tui_model", "ui.tui",
       "utils.profiling", "agents.registry", "agents.agent_template", "llm.local_backend",
       "llm.model_backends", "ingestion.image_captioner", "utils.model_manager",
       "parallel.tensor_parallel"}
assert {"radiant_rag_tpu_torch." + m for m in new} <= set(names), names
import torch
assert not torch.cuda.is_available()
from radiant_rag_tpu_torch.config import config_from_dict
from radiant_rag_tpu_torch.index.bm25 import BM25Index, PersistentBM25Index
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
from radiant_rag_tpu_torch.index.factory import create_vector_store
from radiant_rag_tpu_torch.index.store import TpuVectorStore
from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
from radiant_rag_tpu_torch.models.embedder import Embedder
from radiant_rag_tpu_torch.models.registry import LocalNLPModels
from radiant_rag_tpu_torch.app import RadiantTPU
from radiant_rag_tpu_torch.models.bert import BertConfig
from radiant_rag_tpu_torch.parallel import data, train
from radiant_rag_tpu_torch.parallel.mesh import create_mesh
from radiant_rag_tpu_torch.llm.model_backends import TransformersEmbeddingBackend
from radiant_rag_tpu_torch.ingestion.image_captioner import HuggingFaceVLMCaptioner
assert config_from_dict({}).llm.device == "cuda"
tiny = BertConfig(vocab_size=64, hidden_size=8, num_layers=1, num_heads=2, intermediate_size=16)
for make in (lambda: train.make_train_state(tiny), lambda: train.make_ce_train_state(tiny),
             lambda: train.contrastive_train_step(), lambda: train.cross_encoder_train_step(),
             lambda: data.train_cross_encoder(["a b c"], bert_cfg=tiny, steps=2),
             lambda: DeviceVectorIndex(64), lambda: BM25Index(),
             lambda: DeviceVectorIndex(64, device="cuda"), lambda: TpuVectorStore(64),
             lambda: create_vector_store(config_from_dict({})), lambda: create_mesh(),
             lambda: create_vector_store(config_from_dict({"index": {"backend": "sharded"}})),
             lambda: PersistentBM25Index(None), lambda: Embedder(), lambda: CrossEncoder(),
             lambda: LocalNLPModels(), lambda: Embedder(device="cuda"),
             lambda: RadiantTPU(), lambda: RadiantTPU(config_from_dict({}), device="cuda"),
             lambda: data.train_embedder(None, config_from_dict({}).embedding, steps=2),
             lambda: TransformersEmbeddingBackend("model"), lambda: HuggingFaceVLMCaptioner(".")):
    try:
        make()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise AssertionError("an entry point fell back to the CPU")
DeviceVectorIndex(64, device="cpu")
from radiant_rag_tpu_torch.models.device_rerank import DeviceReranker
assert DeviceReranker(CrossEncoder(device="cpu")).device == torch.device("cpu")
print("ok", len(names))
"""


def jax_section_as_the_port_reads_it(ref, name, data):
    """The JAX package's section `name` as a dict, with the one default the
    port does not share: llm.device is "cuda" (the JAX package's "cpu")
    unless the file sets it, since the port's entry points run on the card
    unless asked for the CPU."""
    import dataclasses

    want = dataclasses.asdict(getattr(ref, name))
    if name == "llm" and "device" not in data.get("llm", {}):
        assert want["device"] == "cpu"
        want["device"] = "cuda"
    return want


def test_port_imports_no_jax_and_needs_cuda_by_default():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted((REPO / "radiant_rag_tpu_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_name_no_jax_import(path):
    """Static check as well: no port module imports jax or the JAX package
    (the port's own name starts with radiant_rag_tpu, hence the dot)."""
    for line in path.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            mod = words[1].rstrip(",")
            assert mod != "jax" and not mod.startswith("jax."), line
            assert mod != "radiant_rag_tpu" and not mod.startswith("radiant_rag_tpu."), line


def test_load_config_raises_instead_of_serving_defaults(tmp_path, caplog):
    """The JAX package's load_config warns and serves the defaults when a
    file does not parse; the port's raises, so no other configuration runs."""
    from radiant_rag_tpu_torch.config import load_config

    bad = tmp_path / "bad.yaml"
    bad.write_text("index: [unclosed\n  store_fp32: false\n")
    with pytest.raises(Exception) as info:
        load_config(str(bad))
    assert "yaml" in type(info.value).__module__.lower() or "YAML" in str(info.value)
    assert not [r for r in caplog.records if r.levelname == "WARNING"]
    with pytest.raises(FileNotFoundError):
        load_config(str(tmp_path / "missing.yaml"))
    scalar = tmp_path / "scalar.yaml"
    scalar.write_text("just a string\n")
    with pytest.raises(ValueError, match="mapping"):
        load_config(str(scalar))


def test_quality_preset_dict_still_parses():
    """The quality preset sets rerank, agentic, context_eval and pipeline
    fields: the port reads them all (none is dropped)."""
    import importlib.util

    from radiant_rag_tpu_torch.config import config_from_dict

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = config_from_dict(smoke.QUALITY_OPTIMIZED_PRESET)
    assert smoke.QUALITY_OPTIMIZED_PRESET["rerank"] == {"top_k": 10, "candidate_multiplier": 6}
    assert (cfg.rerank.top_k, cfg.rerank.candidate_multiplier) == (10, 6)
    assert cfg.agentic.max_critic_retries == 3 and cfg.context_eval.use_llm
    assert cfg.pipeline.use_expansion and cfg.pipeline.use_multihop
    assert cfg.retrieval.fused_top_k == 30 and cfg.embedding.dim == 128


@pytest.mark.parametrize("data", [
    {},
    {"embedding": {"preset": "none"}},
    {"embedding": {"preset": "trainable-small", "dim": 256, "max_seq_len": 128}},
    {"embedding": {"dim": 96}, "index": {"dim": 64}},
    {"embedding": {"weights_path": "/models/minilm"}},
    {"embedding": {"preset": "trainable-small", "weights_path": "/models/minilm"},
     "cross_encoder": {"weights_path": "/models/ce", "dtype": "float32"}},
    {"cross_encoder": {"num_layers": 2, "max_seq_len": 256}},
    {"embedding": {"preset": "mystery"}},
])
def test_embedding_preset_resolves_every_field_as_jax_load_config(data, tmp_path, monkeypatch):
    """Every embedding, cross-encoder, cache and index field as the JAX
    package's load_config resolves it from the same YAML."""
    import dataclasses

    yaml = pytest.importorskip("yaml")
    from radiant_rag_tpu import config as jcfg
    from radiant_rag_tpu_torch import config as tcfg

    for key in list(os.environ):
        if key.startswith("RADIANT_"):
            monkeypatch.delenv(key)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(data))
    ref, got = jcfg.load_config(str(path)), tcfg.config_from_dict(data)
    for section in ("embedding", "cross_encoder", "cache", "index"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(ref, section)), (section, data)


@pytest.mark.parametrize("section,key,value,reason", [
    ("cross_encoder", "model_name", "other", "neither package"),
])
def test_model_fields_without_a_behaviour_raise(section, key, value, reason):
    from radiant_rag_tpu_torch.config import config_from_dict

    with pytest.raises(NotImplementedError, match=reason):
        config_from_dict({section: {key: value}})


@pytest.mark.parametrize("section,key,value", [
    ("metrics", "prometheus_enabled", "true"),
    ("language", "enabled", True),
    ("pipeline", "use_web_search", True),
    ("web_search", "trigger_keywords", "breaking"),
    ("web_crawler", "max_depth", 3),
    ("github", "token", "secret"),
    ("embedding", "backend", "openai_compatible"),
    ("embedding", "backend", "transformers"),
    ("embedding", "model_name", "bge-small"),
    ("cross_encoder", "backend", "llm"),
])
def test_ported_fields_parse_equal_to_jax(tmp_path, monkeypatch, section, key, value):
    """Fields that raised until their layer was ported (the metrics
    exporter, the language phase, web search and the crawlers, the
    embedding and reranking backends): the port's section equals the JAX
    package's for the same file, with the value set. What each does is
    held against the JAX package in
    tests/test_torch_{observability,language,web,model_backends}.py."""
    import dataclasses

    yaml = pytest.importorskip("yaml")
    from radiant_rag_tpu import config as jcfg
    from radiant_rag_tpu_torch import config as tcfg

    for env in list(os.environ):
        if env.startswith("RADIANT_"):
            monkeypatch.delenv(env)
    data = {section: {key: value}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(data))
    ref, got = jcfg.load_config(str(path)), tcfg.config_from_dict(data)
    assert dataclasses.asdict(getattr(got, section)) == dataclasses.asdict(getattr(ref, section))
    assert getattr(getattr(got, section), key) != getattr(getattr(tcfg.AppConfig(), section), key)


@pytest.mark.parametrize("fields", [
    {"model_path": "/models/llama"}, {"device": "cuda"}, {"device": "cpu"},
    {"device": "auto", "model_path": "/m"}, {"backend": "local"},
])
def test_local_llm_fields_parse_as_jax_with_the_card_by_default(tmp_path, monkeypatch, fields):
    """llm.model_path and llm.device raised until the local backend was
    ported; they parse as the JAX package parses them, except that
    llm.device defaults to "cuda" where the JAX package's default is
    "cpu" (the port's entry points run on the card unless asked)."""
    import dataclasses

    yaml = pytest.importorskip("yaml")
    from radiant_rag_tpu import config as jcfg
    from radiant_rag_tpu_torch import config as tcfg

    for env in list(os.environ):
        if env.startswith("RADIANT_"):
            monkeypatch.delenv(env)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({"llm": fields}))
    want = dataclasses.asdict(jcfg.load_config(str(path)).llm)
    got = tcfg.config_from_dict({"llm": fields}).llm
    if "device" not in fields:
        assert want["device"] == "cpu" and got.device == "cuda"
        want["device"] = "cuda"
    assert dataclasses.asdict(got) == want


@pytest.mark.parametrize("data,env", [
    ({}, {}),
    ({"server": {"max_batch": 8, "pipeline_depth": 1}, "logging": {"level": "DEBUG"}},
     {"RADIANT_SERVER_MAX_BATCH": "64"}),
    ({"index": {"auto_persist": True}},
     {"RADIANT_INDEX_AUTO_PERSIST": "false", "RADIANT_INDEX_DATA_DIR": "/srv/idx",
      "RADIANT_BM25_INDEX_PATH": "/srv/bm25.json.gz", "RADIANT_LOGGING_COLOR": "0"}),
    ({"retrieval": {"fusion_weighting": "score"}},
     {"RADIANT_RETRIEVAL_CALIBRATION_PARAPHRASE_FRACTION": "0.25",
      "RADIANT_RETRIEVAL_CALIBRATION_SEEDS": "3", "RADIANT_CACHE_QUERY_CACHE_TTL_S": "5"}),
    ({"embedding": {"max_seq_len": 128}},
     {"RADIANT_EMBEDDING_DIM": "96", "RADIANT_INGESTION_CHILD_CHUNK_SIZE": "256",
      "RADIANT_SERVER_REQUEST_WORKERS": "0", "RADIANT_SERVER_MAX_WAIT_MS": "1.5"}),
    ({}, {"RADIANT_EMBEDDING_PRESET": "none", "RADIANT_INDEX_DIM": "384"}),
])
def test_sections_and_env_overrides_resolve_as_jax_load_config(data, env, tmp_path,
                                                               monkeypatch):
    """Every section the port reads, from the same YAML and the same
    RADIANT_<SECTION>_<FIELD> environment (env > file > defaults), equals
    the JAX package's load_config; an env field counts as set by the user
    for the embedding preset."""
    import dataclasses

    yaml = pytest.importorskip("yaml")
    from radiant_rag_tpu import config as jcfg
    from radiant_rag_tpu_torch import config as tcfg

    for key in list(os.environ):
        if key.startswith("RADIANT_"):
            monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(data))
    ref, got = jcfg.load_config(str(path)), tcfg.config_from_dict(data)
    for f in dataclasses.fields(got):
        assert dataclasses.asdict(getattr(got, f.name)) == \
            jax_section_as_the_port_reads_it(ref, f.name, data), (f.name, data, env)


def test_fields_this_slice_reads_no_longer_raise():
    """fusion_weighting, the calibration_* fields and the query cache's are
    read by the serving entry point; search_scope and retrieval_mode by the
    agentic path."""
    from radiant_rag_tpu_torch.config import config_from_dict

    cfg = config_from_dict({
        "retrieval": {"fusion_weighting": "equal", "calibration_probes": 64,
                      "calibration_paraphrase_fraction": 0.3, "calibration_seeds": 1,
                      "search_scope": "all", "retrieval_mode": "bm25"},
        "cache": {"query_cache_size": 10, "query_cache_ttl_s": 60}})
    r = cfg.retrieval
    assert (r.fusion_weighting, r.calibration_probes, r.calibration_paraphrase_fraction,
            r.calibration_seeds, r.search_scope, r.retrieval_mode) == \
        ("equal", 64, 0.3, 1, "all", "bm25")
    assert (cfg.cache.query_cache_size, cfg.cache.query_cache_ttl_s) == (10, 60.0)


@pytest.mark.parametrize("name", ["config.example.yaml", "config.quality-optimized.example.yaml",
                                  "config.memory-optimized.example.yaml"])
def test_example_configs_parse_equal_to_jax_on_every_section(name, monkeypatch):
    """No section is dropped: every section of the example files parses
    as the JAX package's load_config parses it, field for field (the quality
    preset's rerank, agentic, context_eval and pipeline included)."""
    import dataclasses

    yaml = pytest.importorskip("yaml")
    from radiant_rag_tpu import config as jcfg
    from radiant_rag_tpu_torch import config as tcfg

    for key in list(os.environ):
        if key.startswith("RADIANT_"):
            monkeypatch.delenv(key)
    data = yaml.safe_load((REPO / name).read_text())
    ref, got = jcfg.load_config(str(REPO / name)), tcfg.config_from_dict(data)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    assert len(dataclasses.fields(got)) == 33 and set(data) <= set(tcfg._SECTIONS)
    for f in dataclasses.fields(got):
        assert dataclasses.asdict(getattr(got, f.name)) == \
            jax_section_as_the_port_reads_it(ref, f.name, data), f.name
    if name == "config.example.yaml":
        assert set(data) == set(tcfg._SECTIONS) and got.mesh.data_axis == 1
    if "quality" in name:
        assert (got.rerank.top_k, got.agentic.max_critic_retries, got.context_eval.use_llm) == \
            (10, 3, True)


@pytest.mark.parametrize("section,key,value,reason", [
    ("web_search", "enabled", True, "neither package.*pipeline.use_web_search"),
    ("report", "default_format", "html", "neither package.*suffix"),
    ("mesh", "shard_corpus", True, "neither package"),
    ("mesh", "dtype_compute", "float32", "neither package"),
    ("agentic", "simple_query_max_words", 6, "neither package"),
    ("query", "max_rewrites", 1, "neither package"),
])
def test_agentic_fields_without_a_behaviour_raise(section, key, value, reason):
    from radiant_rag_tpu_torch.config import config_from_dict

    with pytest.raises(NotImplementedError, match=f"{section}.{key}.*{reason}"):
        config_from_dict({section: {key: value}})


def test_unknown_section_is_logged_not_served(caplog):
    from radiant_rag_tpu_torch.config import config_from_dict

    with caplog.at_level("WARNING"):
        cfg = config_from_dict({"rerank": {"top_k": 3}, "reranker": {"top_k": 9}})
    assert cfg.rerank.top_k == 3
    assert "unknown sections ignored: ['reranker']" in caplog.text
    cfg = config_from_dict({"web_search": {"blocked_domains": []},
                            "llm": {"backend": "mock", "temperature": "0.5"}})
    assert cfg.web_search.blocked_domains == () and cfg.llm.temperature == 0.5
