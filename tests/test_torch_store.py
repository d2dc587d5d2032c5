"""Parity of the port's store layer with the JAX package (CPU): doc ids,
TpuVectorStore / NumpyVectorStore writes and retrieval, the factory,
PersistentBM25Index and the standalone BM25 search, state saved by one
package and loaded by the other, and the configuration sections.

Tolerance: tests/_torch_parity.py (exact rows and ranks; scores rtol 1e-5 /
atol 1e-6). The binary cases use a rescore multiplier whose kc covers every
live row, so no stage-1 boundary tie can differ (tests/test_torch_binary.py
states that rule and tests it apart).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import yaml

from radiant_rag_tpu import config as jcfg
from radiant_rag_tpu.index.bm25 import BM25Index as JaxBM25
from radiant_rag_tpu.index.bm25 import PersistentBM25Index as JaxPersistentBM25
from radiant_rag_tpu.index.factory import create_vector_store as jax_create_vector_store
from radiant_rag_tpu.index.numpy_store import NumpyVectorStore as JaxNumpyStore
from radiant_rag_tpu.index.store import TpuVectorStore as JaxStore
from radiant_rag_tpu.utils.hashing import make_doc_id as jax_make_doc_id
from radiant_rag_tpu_torch import config as tcfg
from radiant_rag_tpu_torch.convert import store_from_jax_dir
from radiant_rag_tpu_torch.index.bm25 import BM25Index, PersistentBM25Index
from radiant_rag_tpu_torch.index.factory import create_vector_store
from radiant_rag_tpu_torch.index.numpy_store import NumpyVectorStore
from radiant_rag_tpu_torch.index.store import TpuVectorStore
from radiant_rag_tpu_torch.utils.hashing import make_doc_id

from _torch_parity import assert_rows_match

REPO = Path(__file__).resolve().parent.parent
D = 64
N = 150


def _docs(seed=0, n=N):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (n, 16)) % 500]
    metas = [{"source": f"doc{i // 3}.txt", "chunk_index": i % 3,
              "doc_level": ("leaf", "parent", "leaf")[i % 3],
              "language_code": ("en", "de", "")[i % 3 if i % 5 else 0]} for i in range(n)]
    docs = [(texts[i], metas[i], vecs[i]) for i in range(n)]
    docs.insert(20, docs[7])  # an in-batch duplicate
    docs.insert(40, ("a parent without an embedding", {"source": "p.txt"}, None))
    q = vecs[rng.integers(0, n, 9)] + 0.3 * rng.standard_normal((9, D)).astype(np.float32)
    return docs, q, [" ".join(texts[i].split()[:4]) for i in range(9)]


def _pair(precision="both", mult=16.0, store_fp32=True, **index_kw):
    """A JAX store and a port store over the same docs (kc covers all rows)."""
    kw = dict(dim=D, initial_capacity=256, store_fp32=store_fp32, **index_kw)
    qkw = dict(precision=precision, rescore_multiplier=mult)
    js = JaxStore(D, jcfg.IndexConfig(**kw), jcfg.QuantizationConfig(**qkw))
    ts = TpuVectorStore(D, tcfg.IndexConfig(**kw), tcfg.QuantizationConfig(**qkw), device="cpu")
    return js, ts


def _hits_as_rows(store, hits, k):
    """[[(doc, score)]] -> (rows (B, k), scores (B, k)), -1 / -1e30 padded."""
    rows = np.full((len(hits), k), -1, np.int64)
    scores = np.full((len(hits), k), -1e30, np.float32)
    for i, hs in enumerate(hits):
        for j, (doc, s) in enumerate(hs):
            rows[i, j] = store.row_of(doc.doc_id)
            scores[i, j] = s
    return rows, scores


def _assert_hits_match(js, jh, ts, th, k, what):
    jr, jsc = _hits_as_rows(js, jh, k)
    tr, tsc = _hits_as_rows(ts, th, k)
    assert_rows_match(jr, jsc, tr, tsc, what)
    for a, b in zip(jh, th):
        assert [d.doc_id for d, _ in a] == [d.doc_id for d, _ in b], what


def test_make_doc_id_is_byte_identical():
    cases = [("plain text", None), ("ünïcödé ☃", {"source": "s", "chunk_index": 3}),
             ("x", {"doc_level": "parent", "parent_id": None, "other": 1}),
             ("", {"source": Path("a/b"), "chunk_index": 0})]
    for content, meta in cases:
        assert make_doc_id(content, meta) == jax_make_doc_id(content, meta)


def test_upsert_batch_and_delete_match_jax():
    docs, _, _ = _docs(1)
    js, ts = _pair()
    ids_j, ids_t = js.upsert_batch(docs), ts.upsert_batch(docs)
    assert ids_j == ids_t and ids_t[20] == ids_t[7]
    assert ts.docstore.id_to_row == js.docstore.id_to_row
    assert ts.engine.count == js.engine.count == N  # the duplicate took no row
    for store in (js, ts):  # a re-upsert keeps its row; a delete frees it
        store.upsert_batch(docs[:5])
        assert store.delete_doc(ids_j[3]) and not store.delete_doc("missing")
    assert ts.docstore.id_to_row == js.docstore.id_to_row
    np.testing.assert_array_equal(ts.engine.valid.numpy(), np.asarray(js.engine.valid))
    np.testing.assert_array_equal(ts.engine.lang.numpy(), np.asarray(js.engine.lang))
    assert ts.lang_codes == js.lang_codes
    info_j, info_t = js.get_index_info(), ts.get_index_info()
    assert info_t == info_j
    assert ts.list_doc_ids_with_embeddings() == js.list_doc_ids_with_embeddings()


@pytest.mark.parametrize("precision", ["binary", "int8", "both"])
@pytest.mark.parametrize("store_fp32", [True, False], ids=["fp32", "fp32_free"])
def test_retrieve_by_embedding_batch_matches_jax(precision, store_fp32):
    docs, q, _ = _docs(2)
    js, ts = _pair(precision, store_fp32=store_fp32)
    ids = js.upsert_batch(docs)
    ts.upsert_batch(docs)
    for store in (js, ts):
        store.delete_doc(ids[11])
    assert js.default_search_mode == ts.default_search_mode
    for quantized in (None, True, False):
        for kw in ({}, {"min_similarity": 0.1}, {"language_filter": "de"},
                   {"doc_level_filter": "parent"}, {"language_filter": "xx"}):
            jh = js.retrieve_by_embedding_batch(q, 10, quantized=quantized, **kw)
            th = ts.retrieve_by_embedding_batch(q, 10, quantized=quantized, **kw)
            _assert_hits_match(js, jh, ts, th, 10, f"{precision} {quantized} {kw}")
    one_j = js.retrieve_by_embedding_quantized(q[0], 5)
    one_t = ts.retrieve_by_embedding_quantized(q[0], 5)
    _assert_hits_match(js, [one_j], ts, [one_t], 5, "single query")


def test_numpy_store_matches_jax():
    docs, q, _ = _docs(3)
    js, ts = JaxNumpyStore(D), NumpyVectorStore(D)
    ids = js.upsert_batch(docs)
    assert ts.upsert_batch(docs) == ids
    js.delete_doc(ids[2])
    ts.delete_doc(ids[2])
    for kw in ({}, {"language_filter": "en", "doc_level_filter": "leaf"}):
        _assert_hits_match(js, js.retrieve_by_embedding_batch(q, 10, **kw), ts,
                           ts.retrieve_by_embedding_batch(q, 10, **kw), 10, f"numpy {kw}")
    assert ts.get_index_info() == js.get_index_info()


@pytest.mark.parametrize("store_fp32", [True, False], ids=["fp32", "fp32_free"])
def test_saved_store_loads_in_the_other_package(tmp_path, store_fp32):
    docs, q, qt = _docs(4)
    js, ts = _pair("binary", store_fp32=store_fp32)
    ids = js.upsert_batch(docs)
    ts.upsert_batch(docs)
    for store in (js, ts):
        store.delete_doc(ids[9])
    js.save(str(tmp_path / "jax"))
    ts.save(str(tmp_path / "port"))
    cfg_j = jcfg.IndexConfig(dim=D, initial_capacity=256, store_fp32=store_fp32)
    cfg_t = tcfg.IndexConfig(dim=D, initial_capacity=256, store_fp32=store_fp32)
    qj = jcfg.QuantizationConfig(precision="binary", rescore_multiplier=16.0)
    qt_ = tcfg.QuantizationConfig(precision="binary", rescore_multiplier=16.0)
    t_from_j = store_from_jax_dir(str(tmp_path / "jax"), cfg_t, qt_, device="cpu")
    j_from_t = JaxStore.load(str(tmp_path / "port"), cfg_j, qj)
    j_from_j = JaxStore.load(str(tmp_path / "jax"), cfg_j, qj)
    assert t_from_j.docstore.id_to_row == j_from_j.docstore.id_to_row
    assert j_from_t.docstore.id_to_row == j_from_j.docstore.id_to_row
    for quantized in (None, False):
        ref = j_from_j.retrieve_by_embedding_batch(q, 10, quantized=quantized)
        for other in (t_from_j, j_from_t):
            got = other.retrieve_by_embedding_batch(q, 10, quantized=quantized)
            _assert_hits_match(j_from_j, ref, other, got, 10, f"loaded {quantized}")
    # BM25: each package's persisted file loads in the other
    jb = JaxPersistentBM25(j_from_j, path=str(tmp_path / "jax_bm25.json.gz"), sketch_dim=128)
    tb = PersistentBM25Index(t_from_j, path=str(tmp_path / "port_bm25.json.gz"),
                             sketch_dim=128, device="cpu")
    assert jb.build_from_store() == tb.build_from_store() == N - 1
    tb2 = PersistentBM25Index(t_from_j, path=str(tmp_path / "jax_bm25.json.gz"),
                              sketch_dim=128, device="cpu")
    jb2 = JaxPersistentBM25(j_from_j, path=str(tmp_path / "port_bm25.json.gz"), sketch_dim=128)
    ref = jb.search_batch(qt, 5)
    for other, store in ((tb, t_from_j), (tb2, t_from_j), (jb2, j_from_j)):
        _assert_hits_match(j_from_j, ref, store, other.search_batch(qt, 5), 5, "bm25 file")
    assert tb2.index.to_dict() == jb.index.to_dict()


def test_persistent_bm25_mutations_match_jax(tmp_path):
    docs, _, qt = _docs(5)
    js, ts = _pair()
    ids = js.upsert_batch(docs)
    ts.upsert_batch(docs)
    jb = JaxPersistentBM25(js, path=str(tmp_path / "j.json.gz"), auto_save_threshold=2,
                           persist_max_docs=100, sketch_dim=128)
    tb = PersistentBM25Index(ts, path=str(tmp_path / "t.json.gz"), auto_save_threshold=2,
                             persist_max_docs=100, sketch_dim=128, device="cpu")
    assert tb.index.num_docs == jb.index.num_docs == N  # auto-built on first use
    assert not (tmp_path / "t.json.gz").exists()  # N > persist_max_docs: skipped
    for b in (jb, tb):
        assert b.remove_document(ids[0]) and not b.add_document("missing", "x")
        assert b.add_document(ids[0], "w1 w2 w3 extra words")
    new = [("brand new words here", {"source": "n.txt"}, np.ones(D, np.float32))]
    js.upsert_batch(new)
    ts.upsert_batch(new)
    js.delete_doc(ids[5])
    ts.delete_doc(ids[5])
    assert tb.sync_with_store() == jb.sync_with_store() == (1, 1)
    assert tb.get_stats() == jb.get_stats()
    _assert_hits_match(js, jb.search_batch(qt + ["brand new"], 5), ts,
                       tb.search_batch(qt + ["brand new"], 5), 5, "after mutations")


@pytest.mark.parametrize("method", ["sketch", "pages", "auto"])
def test_bm25_standalone_search_matches_jax(method):
    docs, _, qt = _docs(6)
    texts = [d[0] for d in docs]
    jb, tb = JaxBM25(sketch_dim=128), BM25Index(sketch_dim=128, device="cpu")
    jb.bulk_build(list(range(len(texts))), texts)
    tb.bulk_build(list(range(len(texts))), texts)
    mask = np.ones(256, bool)
    mask[3:9] = False
    import jax.numpy as jnp
    import torch

    js, jr = jb.search_rows_batch(qt, 7, valid_mask=jnp.asarray(mask), method=method)
    ts, tr = tb.search_rows_batch(qt, 7, valid_mask=torch.from_numpy(mask), method=method)
    assert_rows_match(jr, js, tr, ts, method)
    s1, r1 = tb.search_rows(qt[0], 7)
    s2, r2 = jb.search_rows(qt[0], 7)
    assert_rows_match(r2[None], s2[None], r1[None], s1[None], "single")
    assert BM25Index.from_dict(jb.to_dict(), device="cpu").to_dict() == tb.to_dict()


def test_bm25_score_topk_matches_jax():
    import jax.numpy as jnp
    import torch
    from radiant_rag_tpu.ops import bm25 as jbm
    from radiant_rag_tpu_torch.ops import bm25 as tbm

    rng = np.random.default_rng(7)
    rows = rng.integers(-1, 300, (4, 50)).astype(np.int32)
    tfs = rng.integers(1, 4, (4, 50)).astype(np.float32)
    idfs = rng.random((4, 50)).astype(np.float32)
    dl = rng.integers(5, 40, 256).astype(np.float32)
    mask = rng.random(256) > 0.2
    args = (rows, tfs, idfs, dl, np.float32(dl.mean()), mask)
    js, jr = jbm.bm25_score_topk(*(jnp.asarray(a) for a in args), 8, 256)
    ts, tr = tbm.bm25_score_topk(*(torch.as_tensor(a) for a in args), 8, 256)
    assert_rows_match(np.asarray(jr), np.asarray(js), tr.numpy(), ts.numpy(), "score_topk")


def test_factory_backends_and_persisted_dim(tmp_path):
    base = {"index": {"data_dir": str(tmp_path / "idx"), "dim": D}}
    assert isinstance(create_vector_store(tcfg.config_from_dict(
        {**base, "index": {**base["index"], "backend": "numpy"}})), NumpyVectorStore)
    store = create_vector_store(tcfg.config_from_dict(base), device="cpu")
    assert isinstance(store, TpuVectorStore) and store.default_search_mode == "int8"
    docs, _, _ = _docs(8, n=10)
    store.upsert_batch(docs)
    store.save(str(tmp_path / "idx"))
    loaded = create_vector_store(tcfg.config_from_dict(base), device="cpu")
    assert loaded.count_documents() == store.count_documents()
    jloaded = jax_create_vector_store(jcfg.AppConfig(index=jcfg.IndexConfig(
        data_dir=str(tmp_path / "idx"), dim=D)))
    assert jloaded.count_documents() == loaded.count_documents()
    with pytest.raises(ValueError, match="dim=64"):
        create_vector_store(tcfg.config_from_dict(
            {"index": {"data_dir": str(tmp_path / "idx"), "dim": 128}}), device="cpu")
    sharded = create_vector_store(tcfg.config_from_dict(
        {"index": {**base["index"], "backend": "sharded"}}), device="cpu")
    assert type(sharded).__name__ == "ShardedVectorStore"
    assert sharded.count_documents() == store.count_documents()
    with pytest.raises(RuntimeError, match="CUDA"):  # the sharded mesh: every CUDA device
        create_vector_store(tcfg.config_from_dict({"index": {"backend": "sharded"}}))
    spill = TpuVectorStore(D, tcfg.IndexConfig(dim=D, docstore="spill",
                                               data_dir=str(tmp_path / "spill")), device="cpu")
    assert type(spill.docstore).__name__ == "SpillDocStore"
    graph = create_vector_store(tcfg.config_from_dict(
        {"index": {**base["index"], "use_graph": True, "graph_degree": 4}}), device="cpu")
    assert graph.count_documents() == store.count_documents()
    assert graph._default_mode() == "int8"  # flat until the build
    graph.build_graph()
    assert graph.engine.graph.built_rows == graph.engine.count and \
        graph.engine.graph.degree == 4 and graph._default_mode() == "graph"


PRESETS = ["config.example.yaml", "config.memory-optimized.example.yaml",
           "config.quality-optimized.example.yaml"]


@pytest.mark.parametrize("name", PRESETS)
def test_config_sections_match_jax_load_config(name):
    path = REPO / name
    ref = jcfg.load_config(str(path))
    with open(path) as fh:
        got = tcfg.config_from_dict(yaml.safe_load(fh))
    assert tcfg.load_config(str(path)) == got
    for section in ("index", "quantization", "bm25", "retrieval"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(ref, section)), section


def test_chip_smoke_preset_literal_is_the_shipped_file():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(REPO / "config.memory-optimized.example.yaml") as fh:
        assert smoke.MEMORY_OPTIMIZED_PRESET == yaml.safe_load(fh)


@pytest.mark.parametrize("section,key,value,reason", [
    ("index", "metric", "dot", "neither package"),
    ("index", "graph_ef_construction", 400, "neither package"),
    ("index", "growth_factor", 3.0, "neither package"),
    ("quantization", "int8_on_disk_only", "true", "neither package"),
    ("ingestion", "use_intelligent_chunking", "true", "neither package"),
    ("server", "port", 9000, "neither package"),
])
def test_config_refuses_settings_the_port_has_no_behaviour_for(section, key, value, reason):
    """The JAX package accepts these; the port would run another
    configuration than the file asks for, so it raises instead. Their
    defaults, as the shipped presets write them, pass."""
    with pytest.raises(NotImplementedError, match=reason):
        tcfg.config_from_dict({section: {key: value}})
    default = getattr(getattr(tcfg.AppConfig(), section), key)
    assert getattr(getattr(tcfg.config_from_dict({section: {key: default}}), section),
                   key) == default


@pytest.mark.parametrize("section,key,value,want", [
    ("language", "enabled", "true", True),
    ("pipeline", "use_web_search", "yes", True),
    ("metrics", "otel_enabled", True, True),
])
def test_config_serves_the_ported_settings_as_jax_does(tmp_path, section, key, value, want):
    """Settings that raised until their layer was ported (the language
    phase, web search, the OpenTelemetry exporter) parse, with the JAX
    package's coercion, into the value the JAX package serves."""
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({section: {key: value}}))
    ref = getattr(getattr(jcfg.load_config(str(path)), section), key)
    got = getattr(getattr(tcfg.config_from_dict({section: {key: value}}), section), key)
    assert got == ref == want


def test_config_validation_and_coercion_match_jax():
    data = {"quantization": {"rescore_multiplier": "6", "enabled": "yes"},
            "index": {"store_fp32": "false", "initial_capacity": "512"},
            "retrieval": {"fused_depth": "0"}, "bm25": {"nonsense": 1}}
    got = tcfg.config_from_dict(data)
    assert got.quantization.rescore_multiplier == 6.0 and got.quantization.enabled
    assert got.index.store_fp32 is False and got.index.initial_capacity == 512
    assert got.retrieval.fused_depth == 0
    for bad in ({"quantization": {"precision": "pq"}},
                {"quantization": {"rescore_multiplier": 0.5}}):
        with pytest.raises(ValueError):
            tcfg.config_from_dict(bad)
