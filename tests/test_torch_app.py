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
import inspect
import io
import json

import numpy as np
import pytest

from radiant_rag_tpu.app import RadiantTPU as JaxApp
from radiant_rag_tpu.app import build_parser as jax_build_parser
from radiant_rag_tpu.ingestion.processor import DocumentProcessor as JaxProcessor
from radiant_rag_tpu_torch import app as tapp
from radiant_rag_tpu_torch.app import RadiantTPU, build_parser
from radiant_rag_tpu_torch.ingestion.processor import DocumentProcessor

from _torch_agentic_world import Responder, assert_runs_match
from _torch_app_world import QUERIES, assert_hits_match, make_apps, write_docs


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("apps")
    docs = write_docs(tmp / "docs")
    japp, tapp_ = make_apps(tmp, responder=Responder())
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
    assert health == {"store": True, "bm25": True, "models": True, "llm": True, "ok": True}
    assert health == j.check_health()
    stats, jstats = t.get_stats(), j.get_stats()
    assert set(stats) == set(jstats)
    assert set(stats["llm"]) == set(jstats["llm"]) == {"calls", "errors"}
    for key in ("index", "bm25"):
        assert set(stats[key]) == set(jstats[key])
    n = len(t.store.list_doc_ids_with_embeddings())
    assert stats["index"]["num_embedded"] == stats["bm25"]["num_docs"] == n > 0
    assert set(stats["caches"]) == {"query", "embedding"}


def test_deferred_methods_name_their_roadmap_item(apps):
    """The crawled ingests, deferred until their crawlers were ported, now
    answer as the JAX app's: a URL the crawler refuses (not http) and a URL
    that is not GitHub's ingest nothing, with the same statistics (the
    crawls themselves: tests/test_torch_web.py)."""
    j, t = apps["j"], apps["t"]
    for call in (lambda app: app.ingest_urls(["ftp://localhost/"]),
                 lambda app: app.ingest_github("https://localhost/r")):
        got, ref = call(t), call(j)
        got.pop("duration_s"), ref.pop("duration_s")
        assert got == ref and got["chunks_ingested"] == 0
    # train is ported (tests/test_torch_train_data.py drives it): the JAX signature
    assert inspect.signature(type(t).train).parameters == \
        inspect.signature(JaxApp.train).parameters
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
    overrides (no YAML); the subcommands that raised until ui/ and the
    crawlers were ported run as the JAX CLI's do."""
    monkeypatch.setenv("RADIANT_INDEX_DATA_DIR", str(tmp_path / "idx"))
    monkeypatch.setenv("RADIANT_BM25_INDEX_PATH", str(tmp_path / "bm25.json.gz"))
    monkeypatch.setenv("RADIANT_EMBEDDING_CHECKPOINT_DIR", "")
    monkeypatch.setenv("RADIANT_EMBEDDING_BATCH_SIZE", "16")
    monkeypatch.setenv("RADIANT_LOGGING_COLOR", "false")
    monkeypatch.setenv("RADIANT_LLM_BACKEND", "mock")
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
    saved = tmp_path / "search.md"
    assert tapp.main(["search", "laser light", "--mode", "bm25", "--top-k", "2",
                      "--save", str(saved)]) == 0
    assert f"search report saved to {saved}" in capsys.readouterr().out
    text = saved.read_text()
    assert text.startswith("# Search report") and "\n2. [" in text and "\n3. [" not in text
    assert tapp.main(["health"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"]
    assert tapp.main(["stats"]) == 0
    assert json.loads(capsys.readouterr().out)["index"]["num_embedded"] > 0
    assert tapp.main(["rebuild-bm25"]) == 0
    assert "BM25 index rebuilt" in capsys.readouterr().out
    assert tapp.main(["clear"]) == 0
    assert tapp.main(["warmup"]) == 1  # nothing to warm
    report = tmp_path / "r.json"
    assert tapp.main(["query", "what is a laser", "--report", str(report)]) == 0
    assert f"report saved to {report}" in capsys.readouterr().out
    assert json.loads(report.read_text())["query"] == "what is a laser"
    assert tapp.main(["ingest-urls", "ftp://localhost/"]) == 0
    assert json.loads(capsys.readouterr().out)["pages_crawled"] == 0
    monkeypatch.setattr("sys.stdin", io.StringIO("\n"))  # an empty line leaves the TUI
    assert tapp.main(["tui"]) == 0
    assert dataclasses.asdict(made[-1]) == dataclasses.asdict(cfg)


# ---------------------------------------------------------------- the agentic path
QUESTION = "Explain how solar panel energy reaches the battery grid through the current"


@pytest.fixture(scope="module")
def qapps(tmp_path_factory):
    """Both apps over the same corpus, which no test changes."""
    tmp = tmp_path_factory.mktemp("qapps")
    docs = write_docs(tmp / "docs", n_files=12)
    japp, tapp_ = make_apps(tmp, responder=Responder())
    japp.ingest_documents([str(docs)])
    tapp_.ingest_documents([str(docs)])
    return {"j": japp, "t": tapp_}


def test_query_matches_jax_and_is_cached(qapps):
    j, t = qapps["j"], qapps["t"]
    for app in (j, t):
        app.query_cache.clear()
    ref, got = j.query(QUESTION), t.query(QUESTION)
    assert_runs_match(ref, got)
    assert got.success and got.docs and got.citations
    assert t.query(QUESTION) is got  # served from the query cache
    assert t.query(QUESTION, use_cache=False) is not got
    raw = t.query_raw(QUESTION)
    assert raw == got.to_dict() and json.dumps(raw)
    assert set(raw) == set(j.query_raw(QUESTION))
    stats = t.get_stats()
    assert stats["runs"]["runs"] >= 2 and stats["llm"]["calls"] > 0
    assert [a["name"] for a in stats["agents"]] == [a["name"] for a in j.get_stats()["agents"]]


def _strip(events):
    """Events without the run's timings and ids."""
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items() if k not in ("duration_ms", "run_id", "metrics")}
        if ev["event"] == "result":
            ev["citations"] = {k: v for k, v in ev["citations"].items() if k != "audit_id"}
        out.append(ev)
    return out


def test_query_stream_events_match_jax(qapps):
    j, t = qapps["j"], qapps["t"]
    for app in (j, t):
        app.query_cache.clear()
    ref = list(j.query_stream(QUESTION + " today"))
    got = list(t.query_stream(QUESTION + " today"))
    assert _strip(got) == _strip(ref)
    kinds = [e["event"] for e in got]
    assert kinds[0] == "step_start" and kinds[-1] == "result" and "token" in kinds
    assert "error" not in kinds and kinds.count("result") == 1
    steps = [e["step"] for e in got if e["event"] == "step_end"]
    assert [e["step"] for e in got if e["event"] == "step_start"] == steps
    assert "".join(e["text"] for e in got if e["event"] == "token") == \
        "Mitochondria produce ATP, the cell's energy currency [DOC 1]."
    cached = list(t.query_stream(QUESTION + " today"))
    assert [e["event"] for e in cached] == ["result"] and cached[0]["cached"]


def test_conversations_match_jax(qapps):
    """A conversation's second turn carries the first into synthesis; each
    package reads the other's conversation file."""
    j, t = qapps["j"], qapps["t"]
    out = {}
    for key, app in (("j", j), ("t", t)):
        cid = app.start_conversation()
        first = app.query("How does the wind turbine feed power to the grid and battery?",
                          conversation_id=cid)
        calls0 = len(app.llm.backend.calls)
        second = app.query("And what does the battery store for the grid voltage later?",
                           conversation_id=cid)
        synth = [c for c in app.llm.backend.calls[calls0:]
                 if c[-1]["content"].startswith("Context:")][0]
        out[key] = (cid, first, second, synth)
    assert_runs_match(out["j"][1], out["t"][1])
    assert_runs_match(out["j"][2], out["t"][2])
    synth = out["t"][3]
    assert synth == out["j"][3]
    assert synth[1] == {"role": "user", "content": out["t"][1].query}
    assert synth[2] == {"role": "assistant", "content": out["t"][1].answer}
    from radiant_rag_tpu.utils.conversation import ConversationStore as JaxStore
    from radiant_rag_tpu_torch.utils.conversation import ConversationStore

    cross = ConversationStore(j.config.conversation.data_dir).load(out["j"][0])
    back = JaxStore(t.config.conversation.data_dir).load(out["t"][0])
    assert [tt.query for tt in cross.turns] == [tt.query for tt in back.turns] == \
        [out["t"][1].query, out["t"][2].query]


def test_simple_query_matches_jax(qapps):
    j, t = qapps["j"], qapps["t"]
    assert t.simple_query("laser light crystal") == j.simple_query("laser light crystal")
    assert j.llm.backend.calls[-1] == t.llm.backend.calls[-1]


def test_query_device_failure_raises(qapps, monkeypatch):
    """A failing cross-encoder: the JAX app answers from the incoming order,
    the port's query raises (ROADMAP: card failures raise)."""
    t = qapps["t"]

    def broken(*a, **kw):
        raise RuntimeError("cross-encoder lost")

    monkeypatch.setattr(t.local_models, "rerank", broken)
    from radiant_rag_tpu_torch.agents.base_agent import DeviceStageError

    with pytest.raises(DeviceStageError, match="cross-encoder lost"):
        t.query("Explain how the laser mirror filters the photon signal noise", use_cache=False)
    events = list(t.query_stream("Explain how the laser mirror filters the photon noise now"))
    assert events[-1]["event"] == "error" and "cross-encoder lost" in events[-1]["error"]
    assert not [e for e in events if e["event"] == "result"]


def test_cli_query_simple_query_and_interactive(qapps, tmp_path, monkeypatch, capsys):
    t = qapps["t"]
    monkeypatch.setattr(tapp, "create_app", lambda config: t)
    assert tapp.main(["query", QUESTION, "--conversation", ""]) == 0
    out = capsys.readouterr().out
    # the JAX CLI's display of the result (served from the query cache)
    from radiant_rag_tpu_torch.ui.display import display_answer

    display_answer(t.query(QUESTION))
    assert out == capsys.readouterr().out and "Mitochondria produce ATP" in out
    assert tapp.main(["simple-query", "laser light"]) == 0
    assert capsys.readouterr().out.strip() == \
        "Mitochondria produce ATP, the cell's energy currency [DOC 1]."
    lines = iter(["How does the wind turbine feed power to the grid today?", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert tapp.main(["interactive"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("radiant-tpu-torch interactive mode") and "Mitochondria" in out
