"""The port's `RadiantTPU` against the JAX package's (CPU).

Both apps ingest the same documents through their own stores, BM25 indexes
and embedders (float32, the JAX weights carried across with
`convert.bert_params_from_jax`), then serve the same searches. Tolerance:
doc ids in the same order and scores within tests/_torch_parity.py's rtol
1e-5 / atol 1e-6 (a swap only of two docs whose reference scores are tied
within that); the fusion calibration that the first hybrid search runs
selects the same mode and weights (leg weights within 1e-6, MRRs equal).

The corpus holds fewer leaf rows than the stage-1 depth (kc = 4 x the auto
fused depth 60 = 240), so every stage 1, the binary one of the calibration
probes included, keeps every row (see tests/test_torch_calibration.py).
Mirrors `tests/test_app.py` for the retrieval half of the app.
"""

import dataclasses
import json

import numpy as np
import pytest

from radiant_rag_tpu.app import RadiantTPU as JaxApp
from radiant_rag_tpu.app import build_parser as jax_build_parser
from radiant_rag_tpu.ingestion.processor import DocumentProcessor as JaxProcessor
from radiant_rag_tpu_torch import app as tapp
from radiant_rag_tpu_torch.app import RadiantTPU, build_parser
from radiant_rag_tpu_torch.ingestion.processor import DocumentProcessor

from _torch_app_world import QUERIES, assert_hits_match, make_apps, write_docs


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("apps")
    docs = write_docs(tmp / "docs")
    japp, tapp_ = make_apps(tmp)
    jstats = japp.ingest_documents([str(docs)])
    tstats = tapp_.ingest_documents([str(docs)])
    return {"j": japp, "t": tapp_, "jstats": jstats, "tstats": tstats, "docs": docs}


def test_processor_matches_jax(apps):
    for kw in ({}, {"chunk_size": 300, "overlap": 40}):
        ref = JaxProcessor(**kw).process_paths([str(apps["docs"])])
        got = DocumentProcessor(**kw).process_paths([str(apps["docs"])])
        assert [(c.content, c.meta) for c in got] == [(c.content, c.meta) for c in ref]
    sources = {c.meta["source"].rsplit(".", 1)[-1] for c in got}
    assert sources == {"txt", "md", "html", "csv", "json", "py"}


def test_ingest_matches_jax(apps):
    jstats, tstats = dict(apps["jstats"]), dict(apps["tstats"])
    jstats.pop("duration_s"), tstats.pop("duration_s")
    assert tstats == jstats
    assert 150 <= tstats["chunks_ingested"] < 240 and tstats["parents"] > 0
    j, t = apps["j"], apps["t"]
    assert sorted(t.store.list_doc_ids()) == sorted(j.store.list_doc_ids())
    assert all(t.store.row_of(i) == j.store.row_of(i)
               for i in j.store.list_doc_ids_with_embeddings())
    parents = [d for d in t.store.docstore if d.doc_level == "parent"]
    leaves = [d for d in t.store.docstore if d.doc_level == "leaf"]
    assert parents and leaves and all(leaf.parent_id for leaf in leaves)
    assert not any(t.store.has_embedding(p.doc_id) for p in parents)


@pytest.mark.parametrize("mode", ["hybrid", "dense", "bm25"])
def test_search_batch_matches_jax(apps, mode):
    """search_batch, search and search_batch_async in each mode; the first
    hybrid call runs the fusion calibration, whose result must be the JAX
    package's."""
    j, t = apps["j"], apps["t"]
    ref = j.search_batch(QUERIES, mode=mode, top_k=7, use_cache=False)
    got = t.search_batch(QUERIES, mode=mode, top_k=7, use_cache=False)
    assert any(got)
    assert_hits_match(ref, got, f"search_batch {mode}")
    single = [t.search(q, mode=mode, top_k=7, use_cache=False) for q in QUERIES[:3]]
    assert_hits_match(ref[:3], single, f"search {mode}")
    complete = t.search_batch_async(QUERIES, mode=mode, top_k=7, use_cache=False)
    assert getattr(complete, "pipelined", False) == (mode == "hybrid")
    assert_hits_match(ref, complete(), f"search_batch_async {mode}")
    if mode == "hybrid":
        jh, th = j.orchestrator._hybrid, t.orchestrator._hybrid
        assert th.default_fused_depth == jh.default_fused_depth == 60
        assert th.last_calibration is not None and "skipped" not in th.last_calibration
        assert th.fusion_mode == jh.fusion_mode
        np.testing.assert_allclose(th.leg_weights, jh.leg_weights, rtol=0, atol=1e-6)
        for key in ("dense_mrr", "bm25_mrr", "select_mrr", "confirm_mrr", "n_probes",
                    "n_seeds", "pooled_near_ties", "probe_fused_mrr"):
            assert th.last_calibration[key] == jh.last_calibration[key], key
        assert not th.needs_calibration()


def test_query_cache_hits_and_invalidation(apps, tmp_path):
    t = apps["t"]
    t.query_cache.clear()
    h1 = t.search("solar", mode="bm25", top_k=3)
    hits_before = t.query_cache.stats()["hits"]
    h2 = t.search("solar", mode="bm25", top_k=3)
    assert h2 == h1 and h2 is not h1  # a copy of the cached list
    assert t.query_cache.stats()["hits"] == hits_before + 1
    b1 = t.search_batch(["solar", "laser light"], mode="bm25", top_k=3)
    assert t.query_cache.stats()["hits"] == hits_before + 2  # "solar" hit again
    assert [[d.doc_id for d, _ in h] for h in b1] == \
        [[d.doc_id for d, _ in h] for h in t.search_batch(["solar", "laser light"],
                                                          mode="bm25", top_k=3)]
    assert t.query_cache.stats()["size"] == 2
    (tmp_path / "new.txt").write_text("Fresh document about cache invalidation testing. " * 4)
    t.ingest_documents([str(tmp_path)])
    assert t.query_cache.stats()["size"] == 0  # ingest invalidates


def test_warmup_buckets_match_jax(apps):
    j, t = apps["j"], apps["t"]
    assert set(t.warmup(max_batch=8, modes=("hybrid", "dense"))) == \
        set(j.warmup(max_batch=8, modes=("hybrid", "dense"))) == \
        {f"{m}/b{b}" for m in ("hybrid", "dense") for b in (1, 4, 8)}
    full = t.warmup(max_batch=1, modes=("hybrid",), full_ladder=True)
    assert set(full) == set(j.warmup(max_batch=1, modes=("hybrid",), full_ladder=True))
    assert {"hybrid/score/b1", "hybrid/confidence/b1", "ingest_embed/b64"} <= set(full)
    assert all(s >= 0 for s in full.values())
    bare = RadiantTPU.__new__(RadiantTPU)

    class EmptyStore:
        def count_documents(self):
            return 0

    bare.store = EmptyStore()
    assert bare.warmup() == {}


def test_health_and_stats_keys_match_jax(apps):
    j, t = apps["j"], apps["t"]
    health = t.check_health()
    assert health == {"store": True, "bm25": True, "models": True, "llm": False, "ok": True}
    assert set(health) == set(j.check_health())
    stats, jstats = t.get_stats(), j.get_stats()
    assert set(stats) == set(jstats) - {"llm", "agents"}
    for key in ("index", "bm25"):
        assert set(stats[key]) == set(jstats[key])
    n = len(t.store.list_doc_ids_with_embeddings())
    assert stats["index"]["num_embedded"] == stats["bm25"]["num_docs"] == n > 0
    assert set(stats["caches"]) == {"query", "embedding"}


def test_deferred_methods_name_their_roadmap_item(apps):
    t = apps["t"]
    for call, item in ((lambda: t.query("q"), "item 11"), (lambda: t.query_raw("q"), "item 11"),
                       (lambda: t.query_stream("q"), "item 11"),
                       (lambda: t.simple_query("q"), "item 11"),
                       (lambda: t.start_conversation(), "item 11"),
                       (lambda: t.ingest_urls(["http://localhost/"]), "item 11"),
                       (lambda: t.ingest_github("https://localhost/r"), "item 11"),
                       (lambda: t.train(steps=1), "item 12"),
                       (lambda: t.orchestrator.run("q"), "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    assert t.orchestrator.get_agent_stats() == []
    assert t._chunk_markdown("# A\n\nx\n\n# B\n\ny") == \
        JaxApp._chunk_markdown("# A\n\nx\n\n# B\n\ny")


def test_calibration_failure_raises(apps, monkeypatch):
    """No fallback around calibration: the JAX package logs a failure and
    serves equal weights; the port raises it to the caller."""
    t = apps["t"]
    hy = t.orchestrator._hybrid
    saved = (hy._calibrated_at, hy.last_calibration, hy.fusion_mode, hy.leg_weights)

    def broken(texts):
        raise RuntimeError("embedder failed")

    monkeypatch.setattr(t.local_models, "embed", broken)
    hy.invalidate_calibration()
    try:
        with pytest.raises(RuntimeError, match="embedder failed"):
            t.search_batch(["solar"], mode="hybrid", use_cache=False)
    finally:
        hy._calibrated_at, hy.last_calibration, hy.fusion_mode, hy.leg_weights = saved


def test_save_restart_clear_and_rebuild(tmp_path):
    """Ingest in one app; a fresh app over the same config sees the corpus;
    rebuild_bm25 and clear keep the fused path on the live index and
    engine (after a clear the JAX package's searcher keeps the old engine:
    ROADMAP section C)."""
    _, t1 = make_apps(tmp_path)
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "x.txt").write_text("Volcanoes erupt molten lava from deep underground chambers. " * 5)
    t1.ingest_documents([str(docs)])
    n = t1.store.count_documents()
    assert n > 0 and (tmp_path / "t" / "idx" / "manifest.json").is_file()
    t2 = RadiantTPU(t1.config, local_models=t1.local_models, device="cpu")  # a restart
    assert t2.store.count_documents() == n
    hits = t2.search("volcanoes lava", mode="bm25", top_k=3)
    assert hits and "lava" in hits[0][0].content
    assert t2.rebuild_bm25_index() == len(t2.store.list_doc_ids_with_embeddings())
    t2.query_cache.clear()
    hits = t2.search("volcanoes lava", mode="hybrid", top_k=3)
    assert hits and "lava" in hits[0][0].content
    assert t2.orchestrator._hybrid.bm25 is t2.bm25_index.index
    t2.save_index(str(tmp_path / "saved"))
    from radiant_rag_tpu_torch.index.store import TpuVectorStore

    assert TpuVectorStore.load(str(tmp_path / "saved"), device="cpu").count_documents() == n
    t2.clear_index()
    assert t2.store.count_documents() == 0
    assert t2.search("volcanoes lava", mode="hybrid", top_k=3) == []
    (docs / "y.txt").write_text("Glaciers carve valleys with slow moving ice over centuries. " * 5)
    (docs / "x.txt").unlink()
    t2.ingest_documents([str(docs)])
    hits = t2.search("glaciers ice valleys", mode="hybrid", top_k=3)
    assert hits and all("lava" not in d.content for d, _ in hits)
    assert t2.orchestrator._hybrid.engine is t2.store.engine
    t3 = RadiantTPU(t1.config, local_models=t1.local_models, device="cpu")
    assert t3.store.count_documents() == t2.store.count_documents()  # the clear persisted


def test_numpy_backend_fuses_on_the_host_like_jax(tmp_path):
    """A store without an engine: hybrid is per-leg retrieval plus the RRF
    agent's arithmetic on the host, as in the JAX package."""
    docs = write_docs(tmp_path / "docs", n_files=4)
    japp, t = make_apps(tmp_path, index={"backend": "numpy"})
    japp.ingest_documents([str(docs)])
    t.ingest_documents([str(docs)])
    assert t.orchestrator._hybrid is None
    ref = japp.search_batch(QUERIES[:6], mode="hybrid", top_k=5, use_cache=False)
    got = t.search_batch(QUERIES[:6], mode="hybrid", top_k=5, use_cache=False)
    assert_hits_match(ref, got, "numpy backend hybrid")


def test_cli_parser_matches_jax():
    jp, tp = jax_build_parser(), build_parser()
    jsub = next(a for a in jp._actions if a.dest == "command").choices
    tsub = next(a for a in tp._actions if a.dest == "command").choices
    assert set(tsub) == set(jsub)
    for name in jsub:
        assert {a.dest for a in tsub[name]._actions} == {a.dest for a in jsub[name]._actions}
    args = tp.parse_args(["search", "x", "--mode", "bm25", "--top-k", "3"])
    assert args.mode == "bm25" and args.top_k == 3
    assert tp.parse_args(["serve", "--warmup", "16"]).warmup == 16


def test_cli_main_on_env_overrides(tmp_path, monkeypatch, capsys):
    """main() without --config builds the defaults plus the RADIANT_* env
    overrides (no YAML); the not-ported subcommands raise naming their item."""
    monkeypatch.setenv("RADIANT_INDEX_DATA_DIR", str(tmp_path / "idx"))
    monkeypatch.setenv("RADIANT_BM25_INDEX_PATH", str(tmp_path / "bm25.json.gz"))
    monkeypatch.setenv("RADIANT_EMBEDDING_CHECKPOINT_DIR", "")
    monkeypatch.setenv("RADIANT_EMBEDDING_BATCH_SIZE", "16")
    monkeypatch.setenv("RADIANT_LOGGING_COLOR", "false")
    made = []

    def create_app(config):
        made.append(config)
        return RadiantTPU(config, device="cpu")

    monkeypatch.setattr(tapp, "create_app", create_app)
    docs = write_docs(tmp_path / "docs", n_files=2)
    assert tapp.main(["ingest", str(docs)]) == 0
    assert json.loads(capsys.readouterr().out)["chunks_ingested"] > 0
    cfg = made[0]
    assert cfg.index.data_dir == str(tmp_path / "idx") and cfg.embedding.batch_size == 16
    assert cfg.embedding.dim == 128  # the trainable-small preset, as with no file
    assert tapp.main(["search", "laser light", "--mode", "bm25", "--top-k", "2"]) == 0
    hits = json.loads(capsys.readouterr().out)
    assert len(hits) == 2 and {"doc_id", "score", "source", "content"} <= set(hits[0])
    assert tapp.main(["health"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"]
    assert tapp.main(["stats"]) == 0
    assert json.loads(capsys.readouterr().out)["index"]["num_embedded"] > 0
    assert tapp.main(["rebuild-bm25"]) == 0
    assert "BM25 index rebuilt" in capsys.readouterr().out
    assert tapp.main(["clear"]) == 0
    assert tapp.main(["warmup"]) == 1  # nothing to warm
    for argv, item in ((["query", "q"], "item 11"), (["train"], "item 12"),
                       (["ingest-urls", "http://localhost/"], "item 11"), (["tui"], "item 11"),
                       (["search", "x", "--save", "r.md"], "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            tapp.main(argv)
    assert dataclasses.asdict(made[-1]) == dataclasses.asdict(cfg)
