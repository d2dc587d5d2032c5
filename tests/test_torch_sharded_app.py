"""The pod store (`index.backend: sharded`) through the port's product stack
against the JAX package's (CPU): the factory, the app's hybrid search with
the calibration carried to the pod, the HTTP handler with an append racing
a search, persistence, and the orchestrator's pod path on the scripted LLM
of tests/_torch_agentic_world.py. The counterparts of
tests/test_sharded_product.py and tests/test_parallel.py's orchestrator
case.

The JAX apps shard over the 8 virtual CPU devices of tests/conftest.py; the
port's config path takes the one CPU device (it never repeats a device;
`create_mesh` makes logical shards only when asked), and its orchestrator
case runs on 8 logical `cpu` shards. Sharding is exact in both, so the hits
compare at the tolerance of tests/_torch_parity.py. The corpora are smaller
than the binary stage-1 depth, so that stage keeps every row.
"""

import threading

import numpy as np
import pytest

from radiant_rag_tpu.parallel.mesh import create_mesh as jax_create_mesh
from radiant_rag_tpu.parallel.sharded_store import ShardedVectorStore as JaxPod
from radiant_rag_tpu.server import RagAPI as JaxAPI
from radiant_rag_tpu_torch import config as tcfg
from radiant_rag_tpu_torch.agents.base_agent import DeviceStageError
from radiant_rag_tpu_torch.index.factory import create_vector_store
from radiant_rag_tpu_torch.parallel.mesh import create_mesh, mesh_info
from radiant_rag_tpu_torch.parallel.sharded_store import ShardedVectorStore
from radiant_rag_tpu_torch.server import RagAPI

from _torch_agentic_world import BIG_DOCS, assert_runs_match, make_stacks, orchestrators
from _torch_app_world import QUERIES, assert_hits_match, make_apps, write_docs

SHARDED = {"index": {"backend": "sharded"}}


def test_factory_dispatches_sharded(tmp_path):
    cfg = tcfg.config_from_dict({"index": {"backend": "sharded", "dim": 32,
                                           "data_dir": str(tmp_path / "idx")}})
    store = create_vector_store(cfg, device="cpu")
    assert isinstance(store, ShardedVectorStore)
    assert mesh_info(store.mesh) == {"data": 1, "model": 1}  # the config's one CPU device
    assert store.source.engine.device.type == "cpu" and store.count_documents() == 0
    with pytest.raises(ValueError, match="needs 2 devices"):
        create_vector_store(tcfg.config_from_dict(
            {"index": {"backend": "sharded"}, "mesh": {"data_axis": 2}}), device="cpu")


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pods")
    docs = write_docs(tmp / "docs", n_files=6)
    japp, tapp = make_apps(tmp, **SHARDED)
    japp.ingest_documents([str(docs)])
    tapp.ingest_documents([str(docs)])
    return japp, tapp


def test_app_hybrid_search_over_sharded_backend_matches_jax(pods):
    """top_k 12: the dense mode's binary stage 1 (kc = 48) then keeps all
    45 rows, so no stage-1 tie can differ (tests/test_torch_binary.py)."""
    japp, tapp = pods
    assert tapp.store.source.engine.count <= 48
    assert isinstance(tapp.store, ShardedVectorStore) and tapp.store.can_hybrid
    assert tapp._fused_searcher() is None and japp._fused_searcher() is None
    assert tapp.store.count_documents() == japp.store.count_documents()
    for mode in ("hybrid", "dense", "bm25"):
        ref = japp.search_batch(QUERIES, mode=mode, top_k=12, use_cache=False)
        got = tapp.search_batch(QUERIES, mode=mode, top_k=12, use_cache=False)
        assert_hits_match(ref, got, mode)
        assert all(got), mode


def test_calibrated_fusion_reaches_pod_store_matches_jax(pods):
    japp, tapp = pods
    tapp.search("memory cache index", top_k=3, use_cache=False)
    japp.search("memory cache index", top_k=3, use_cache=False)
    hy, jhy = tapp.orchestrator._hybrid, japp.orchestrator._hybrid
    assert hy is not None and not tapp.orchestrator._hybrid_serves
    assert hy.last_calibration is not None and "skipped" not in hy.last_calibration
    assert hy.engine is tapp.store.source.engine
    assert (tapp.store._fusion_mode, hy.fusion_mode) == (jhy.fusion_mode,) * 2
    np.testing.assert_allclose(tapp.store._fusion_weights, hy.leg_weights, rtol=1e-6)
    np.testing.assert_allclose(hy.leg_weights, jhy.leg_weights, atol=1e-6)
    assert tapp.store._hybrid.fusion_mode == hy.fusion_mode


def test_serving_handler_with_concurrent_append(tmp_path):
    """One /search while a writer appends: the base keeps serving, and the
    appended doc is served from the delta segment with no re-shard, as in
    the JAX package."""
    docs = write_docs(tmp_path / "docs", n_files=3)
    japp, tapp = make_apps(tmp_path, **SHARDED)
    text = "fresh pod delta document about quantized scanning"
    results = {}
    for key, app, api_cls in (("j", japp, JaxAPI), ("t", tapp, RagAPI)):
        app.ingest_documents([str(docs)])
        api = api_cls(app, coalesce=False)
        errors = []

        def writer(app=app, errors=errors):
            try:
                emb = app.local_models.embed([text])[0]
                app.store.upsert_batch([(text, {"doc_level": "leaf"}, emb)])
            except Exception as exc:  # pragma: no cover (reported below)
                errors.append(exc)

        t = threading.Thread(target=writer)
        t.start()
        code, body = api.handle("POST", "/search", {"query": "wind turbine", "mode": "hybrid"})
        t.join()
        assert not errors and code == 200 and body["hits"]
        code, body = api.handle("POST", "/search",
                                {"query": "quantized scanning delta", "mode": "hybrid"})
        assert code == 200 and any(text in h["content"] for h in body["hits"])
        results[key] = body["hits"]
        assert api.handle("GET", "/stats", {})[0] == 200
        api.close()
    assert tapp.store.delta_size == japp.store.delta_size == 1
    assert [h["doc_id"] for h in results["t"]] == [h["doc_id"] for h in results["j"]]


def test_sharded_persistence_roundtrip(tmp_path):
    """auto-persist writes through to the source store; a fresh app over the
    same data_dir loads it and serves from the sharded base, as the JAX
    app over its own directory does."""
    docs = write_docs(tmp_path / "docs", n_files=2)
    japp, tapp = make_apps(tmp_path, **SHARDED)
    japp.ingest_documents([str(docs)])
    tapp.ingest_documents([str(docs)])
    j2, t2 = make_apps(tmp_path, **SHARDED)
    assert t2.store.count_documents() == tapp.store.count_documents() > 0
    assert t2.store._base_rows == t2.store.source.engine.count and t2.store.delta_size == 0
    ref = j2.search_batch(QUERIES[:4], top_k=3, use_cache=False)
    got = t2.search_batch(QUERIES[:4], top_k=3, use_cache=False)
    assert_hits_match(ref, got, "reloaded")


def test_clear_index_attaches_the_new_bm25_index(tmp_path):
    """clear_index rebuilds the BM25 index as a new object; the pod store
    is handed it (the JAX pod keeps the old one and rebases over it)."""
    docs = write_docs(tmp_path / "docs", n_files=2)
    _, tapp = make_apps(tmp_path, **SHARDED)
    tapp.ingest_documents([str(docs)])
    tapp.clear_index()
    assert tapp.store.count_documents() == 0 and tapp.store._hybrid is None
    assert tapp.store._bm25 is tapp.bm25_index.index
    tapp.ingest_documents([str(docs)])
    assert tapp.search_batch(["wind turbine"], top_k=3, use_cache=False)[0]


@pytest.fixture(scope="module")
def pod_stacks(tmp_path_factory):
    """The agentic world's stacks with each store wrapped in its package's
    pod store: the JAX one over 4 x 2 virtual devices, the port's over
    8 logical cpu shards."""
    stacks = make_stacks(tmp_path_factory.mktemp("pod_stacks"), BIG_DOCS)
    out = {}
    for key, pod in (("j", lambda s, b: JaxPod(jax_create_mesh(data=4, model=2), s,
                                               bm25_index=b)),
                     ("t", lambda s, b: ShardedVectorStore(create_mesh(4, 2,
                                                                       devices=["cpu"] * 8),
                                                           s, bm25_index=b))):
        cfg, store, bm25, models = stacks[key]
        out[key] = (cfg, pod(store, bm25.index), bm25, models)
    return out


@pytest.mark.parametrize("question", ["What is the mitochondria energy document about?",
                                      "Document about nucleus dna mechanisms in detail"])
def test_orchestrator_runs_on_sharded_store_matches_jax(pod_stacks, question):
    jo, to = orchestrators(pod_stacks)
    assert to._hybrid is not None and not to._hybrid_serves
    assert to._hybrid.engine is pod_stacks["t"][1].source.engine
    ref, got = jo.run(question), to.run(question)
    assert got.success and got.fused_docs and got.docs
    assert_runs_match(ref, got)
    assert to.store._fusion_mode == to._hybrid.fusion_mode == jo._hybrid.fusion_mode
    assert not to.rerank_calibration  # the auto-disable probes skip a pod store


def test_pod_calibration_failure_raises(pod_stacks):
    """The JAX package logs a failed pod calibration and serves equal
    weights; the port raises it out of run as a DeviceStageError."""

    class BrokenEmbed:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def embed(self, texts):
            if len(texts) >= 8:  # the calibration's probe batch
                raise RuntimeError("injected calibration failure")
            return self.inner.embed(texts)

    models = {k: BrokenEmbed(pod_stacks[k][3]) for k in "jt"}
    jo, to = orchestrators(pod_stacks, models=models)
    assert jo.run("What is the mitochondria energy document about?").success
    with pytest.raises(DeviceStageError, match="injected calibration failure"):
        to.run("What is the mitochondria energy document about?")
