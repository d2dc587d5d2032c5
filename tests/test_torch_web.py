"""The port's web layer against the JAX package's (CPU): the web and GitHub
crawlers, web search, the crawled ingests, their server routes and CLI.

Every crawl runs over both packages with the same inputs: injected fetchers
(the cases of tests/test_ingestion.py) and a real `http.server` on
127.0.0.1:0 serving a small generated site and a GitHub look-alike (the
`API` / `RAW` hosts of both crawlers pointed at it); the results must match
page for page and chunk for chunk, and the ingested pages must come back
from both apps' searches alike (tests/_torch_app_world.py's tolerance).
Web search mirrors tests/test_agents3.py and tests/test_orchestrator.py's
empty-index fallback. The crawler routes hold the device lock for their
ingest's device work only: a slow site does not stall /search.
"""

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from radiant_rag_tpu.agents.base import new_agent_context as jax_ctx
from radiant_rag_tpu.agents.web_search import WebSearchAgent as JaxWebSearch
from radiant_rag_tpu.ingestion import github_crawler as jgh
from radiant_rag_tpu.ingestion import web_crawler as jwc
from radiant_rag_tpu.llm.backends import MockLLMBackend as JaxMock
from radiant_rag_tpu.llm.client import LLMClient as JaxClient
from radiant_rag_tpu.server import RagAPI as JaxRagAPI
from radiant_rag_tpu_torch import app as tapp_mod
from radiant_rag_tpu_torch.agents.base import new_agent_context
from radiant_rag_tpu_torch.agents.web_search import WebSearchAgent
from radiant_rag_tpu_torch.ingestion import github_crawler as tgh
from radiant_rag_tpu_torch.ingestion import web_crawler as twc
from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
from radiant_rag_tpu_torch.llm.client import LLMClient
from radiant_rag_tpu_torch.server import RagAPI

from _torch_agentic_world import GOOD_CRITIQUE, replace_sections
from _torch_app_world import assert_hits_match, make_apps, write_docs

N_PAGES = 12
SLOW_S = 1.0  # the slow page's delay


def phrase(i):
    return f"zebra{i} quokka{i} lantern{i}"


def site_pages():
    """path -> (body, content type): a root linking to 4 sections, each
    linking to 2 pages (depth 2), and a slow page no link reaches."""
    pages = {}
    kids = {0: list(range(1, 5))}
    for s in range(1, 5):
        kids[s] = [4 + 2 * s - 1, 4 + 2 * s]
    for i in range(N_PAGES + 1):
        links = "".join(f'<a href="/p{c}.html">page {c}</a> ' for c in kids.get(i, []))
        body = (f"<html><head><title>Page {i}</title><style>p{{}}</style></head><body>"
                f"<p>Page {i} tells of the {phrase(i)} in the valley.</p>"
                f"<p>It has {i} paragraphs of notes.</p>{links}"
                "<script>var x = 1;</script></body></html>")
        pages["/" if i == 0 else f"/p{i}.html"] = (body.encode(), "text/html; charset=utf-8")
    pages["/notes.txt"] = (f"plain notes of the {phrase(99)}".encode(), "text/plain")
    pages["/slow.html"] = (f"<html><body>slow {phrase(77)}</body></html>".encode(), "text/html")
    return pages


GH_FILES = {
    "README.md": "# Tools\n\nThe orrery tool ranks the planets.\n\n## Use\n\nRun it daily.\n",
    "src/rank.py": "def rank(scores):\n    \"\"\"Rank the orrery scores.\"\"\"\n"
                   "    return sorted(scores)\n\n\nclass Orrery:\n    def spin(self):\n"
                   "        return 1\n",
    "docs/notes.txt": "Notes about the astrolabe and the sextant.",
    "img/logo.png": "not text",
}


def github_pages():
    tree = {"tree": [{"path": p, "type": "blob"} for p in GH_FILES] +
            [{"path": "src", "type": "tree"}]}
    pages = {"/repos/o/r": (json.dumps({"default_branch": "main"}).encode(), "application/json"),
             "/repos/o/r/git/trees/main?recursive=1": (json.dumps(tree).encode(),
                                                        "application/json")}
    for path, text in GH_FILES.items():
        pages[f"/o/r/main/{path}"] = (text.encode(), "text/plain")
    return pages


@pytest.fixture(scope="module")
def site():
    pages = {**site_pages(), **github_pages()}
    hits = []

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            hits.append(self.path)
            if self.path == "/slow.html":
                time.sleep(SLOW_S)
            if self.path not in pages:
                self.send_error(404)
                return
            body, ctype = pages[self.path]
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield {"root": f"http://127.0.0.1:{server.server_address[1]}", "hits": hits}
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


@pytest.fixture
def github_on_site(site, monkeypatch):
    for mod in (jgh, tgh):
        monkeypatch.setattr(mod.GitHubCrawler, "API", site["root"])
        monkeypatch.setattr(mod.GitHubCrawler, "RAW", site["root"])
    return site


def _crawls(results):
    return [dataclasses.asdict(r) for r in results]


# ---------------------------------------------------------------- crawlers
@pytest.mark.parametrize("url,base", [
    ("HTTP://Example.COM:80/path#frag", ""), ("https://a.com:443/", ""),
    ("https://a.com:8443/x", ""), ("ftp://a.com/x", ""), ("/rel", "https://a.com/dir/"),
    ("sub/page?q=1#x", "http://b.org/a/"), ("http://[::1", ""), ("http:///nohost", ""),
])
def test_normalize_url_matches_jax(url, base):
    assert twc.normalize_url(url, base=base) == jwc.normalize_url(url, base=base)


def test_extract_links_and_fake_fetcher_crawls_match_jax():
    html = '<a href="/one">1</a> <a href="https://other.com/two#x">2</a> <A HREF=\'ftp://x\'>'
    assert twc.extract_links(html, "https://base.com/s") == \
        jwc.extract_links(html, "https://base.com/s")
    pages = {
        "https://site.com/": '<html><body>root <a href="/a">a</a><a href="/b">b</a>'
                             '<a href="https://other.com/x">ext</a></body></html>',
        "https://site.com/a": "<html><body>page a content here</body></html>",
        "https://site.com/b": "<html><body>page b content here</body></html>",
    }

    def fetcher(url):
        return pages.get(url, ""), "text/html"

    for kw in ({"max_depth": 1, "max_pages": 10}, {"max_depth": 0}, {"max_pages": 2},
               {"same_domain_only": False}, {"exclude_patterns": ("/b$",)},
               {"include_patterns": ("/a$", "site.com/$")}):
        got = twc.WebCrawler(rate_limit_delay_s=0, fetcher=fetcher, **kw).crawl(
            "https://site.com/")
        ref = jwc.WebCrawler(rate_limit_delay_s=0, fetcher=fetcher, **kw).crawl(
            "https://site.com/")
        assert _crawls(got) == _crawls(ref), kw
    single = twc.WebCrawler(fetcher=lambda u: ("<html><title>T</title><body>hello world"
                                               "</body></html>", "text/html")).crawl_single(
        "https://x.com/page")
    assert (single.text, single.title, single["url"], single.get("nope", 7)) == \
        ("hello world", "T", "https://x.com/page", 7)


def test_crawl_over_loopback_matches_jax(site):
    for kw in ({"max_depth": 2, "max_pages": 50}, {"max_depth": 1, "max_pages": 3}):
        got = twc.WebCrawler(rate_limit_delay_s=0, **kw).crawl(site["root"] + "/")
        ref = jwc.WebCrawler(rate_limit_delay_s=0, **kw).crawl(site["root"] + "/")
        assert _crawls(got) == _crawls(ref)
    got = twc.WebCrawler(rate_limit_delay_s=0).crawl(site["root"] + "/")
    assert len(got) == N_PAGES + 1 and {r.depth for r in got} == {0, 1, 2}
    assert all(phrase(int(r.title.split()[1])) in r.text for r in got)
    for path in ("/notes.txt", "/missing.html"):
        got = twc.WebCrawler(rate_limit_delay_s=0).crawl_single(site["root"] + path)
        ref = jwc.WebCrawler(rate_limit_delay_s=0).crawl_single(site["root"] + path)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert "404" in got.error and got.text == ""


def test_github_crawls_match_jax(github_on_site):
    for url in ("https://github.com/o/r", "https://github.com/o/r/tree/main",
                "https://github.com/o/r/blob/main/README.md", "https://gitlab.com/o/r",
                "https://github.com/o/missing"):
        assert tgh.parse_github_url(url) == jgh.parse_github_url(url)
        assert tgh.is_github_url(url) == jgh.is_github_url(url)
        for kw in ({}, {"max_files": 1}, {"include_extensions": (".py",)}):
            got = tgh.GitHubCrawler(**kw).crawl(url)
            ref = jgh.GitHubCrawler(**kw).crawl(url)
            assert [dataclasses.asdict(f) for f in got] == [dataclasses.asdict(f) for f in ref]
    files = tgh.GitHubCrawler().crawl("https://github.com/o/r")
    assert [f.path for f in files] == ["README.md", "src/rank.py", "docs/notes.txt"]
    assert files[1].content == GH_FILES["src/rank.py"]

    def fetcher(url):  # tests/test_ingestion.py's fake
        if url.endswith("/repos/o/r"):
            return json.dumps({"default_branch": "dev"}).encode()
        if "git/trees" in url:
            return json.dumps({"tree": [{"path": "README.md", "type": "blob"},
                                        {"path": "x.png", "type": "blob"}]}).encode()
        return b"file content of " + url.encode()

    got = tgh.GitHubCrawler(fetcher=fetcher).crawl("https://github.com/o/r")
    ref = jgh.GitHubCrawler(fetcher=fetcher).crawl("https://github.com/o/r")
    assert [dataclasses.asdict(f) for f in got] == [dataclasses.asdict(f) for f in ref]


# ---------------------------------------------------------------- the crawled ingests
@pytest.fixture(scope="module")
def apps(tmp_path_factory, site):
    """Both apps over one small corpus, web search on (the app builds no
    crawler), equal leg weights (no fusion calibration to run) and no
    delay between fetches."""
    tmp = tmp_path_factory.mktemp("webapps")
    japp, tapp = make_apps(tmp, responder=_web_responder([site["root"] + "/p4.html"],
                                                         plan_web=True),
                           pipeline={"use_web_search": True},
                           retrieval={"fusion_weighting": "equal"},
                           web_crawler={"rate_limit_delay_s": 0.0})
    docs = write_docs(tmp / "docs", n_files=3)
    japp.ingest_documents([str(docs)])
    tapp.ingest_documents([str(docs)])
    return {"j": japp, "t": tapp}


def _no_duration(stats):
    return {k: v for k, v in stats.items() if k != "duration_s"}


def test_ingest_urls_and_github_match_jax(apps, github_on_site):
    j, t = apps["j"], apps["t"]
    root = github_on_site["root"] + "/"
    got, ref = t.ingest_urls([root]), j.ingest_urls([root])
    assert _no_duration(got) == _no_duration(ref) and got["pages_crawled"] == N_PAGES + 1
    got, ref = t.ingest_github("https://github.com/o/r"), j.ingest_github("https://github.com/o/r")
    assert _no_duration(got) == _no_duration(ref) and got["files_fetched"] == 3
    assert sorted(t.store.list_doc_ids()) == sorted(j.store.list_doc_ids())
    for doc_id in t.store.list_doc_ids():
        a, b = t.store.get_doc(doc_id), j.store.get_doc(doc_id)
        assert (a.content, a.meta) == (b.content, b.meta)
    # each page's whole text as its query: rank 1 on both legs
    pages = sorted(twc.WebCrawler(rate_limit_delay_s=0).crawl(root), key=lambda r: r.url)
    queries = [r.text for r in pages] + ["orrery planets", "astrolabe sextant"]
    for mode in ("hybrid", "bm25"):
        assert_hits_match(j.search_batch(queries, mode=mode, top_k=5, use_cache=False),
                          t.search_batch(queries, mode=mode, top_k=5, use_cache=False), mode)
    hits = t.search_batch(queries, mode="hybrid", top_k=5, use_cache=False)
    for r, top in zip(pages, hits):
        assert top[0][0].content == r.text and top[0][0].meta["source"] == r.url
    bm = t.search_batch(queries[-2:], mode="bm25", top_k=1, use_cache=False)
    assert "orrery" in bm[0][0][0].content and "astrolabe" in bm[1][0][0].content


def test_crawler_routes_hold_the_lock_for_the_ingest_only(apps, site):
    """/ingest/urls over a page that takes SLOW_S to fetch, beside /search:
    the search answers while the fetch is in flight, and the ingest's
    embed, upsert and BM25 sync (`_ingest_chunks`) run under the device
    lock, never overlapping a coalescer batch."""
    t = apps["t"]
    api = RagAPI(t)
    spans, owned = [], []
    ingest, dispatch = t._ingest_chunks, t._dispatch_fused

    def timed(kind, fn):
        def wrapper(*a, **kw):
            owned.append((kind, t.device_lock._is_owned()))
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans.append((kind, t0, time.perf_counter()))
        return wrapper

    t._ingest_chunks = timed("ingest", ingest)
    t._dispatch_fused = timed("search", dispatch)
    out = {}
    try:
        worker = threading.Thread(target=lambda: out.setdefault(
            "ingest", api.handle("POST", "/ingest/urls", {"urls": [site["root"] + "/slow.html"]})))
        t0 = time.perf_counter()
        worker.start()
        while "/slow.html" not in site["hits"]:
            time.sleep(0.01)
        status, body = api.handle("POST", "/search", {"query": "valley notes", "top_k": 3})
        searched = time.perf_counter() - t0
        worker.join(timeout=30)
        status_i, body_i = out["ingest"]
        status2, body2 = api.handle("POST", "/search", {"query": phrase(77), "top_k": 3})
    finally:
        del t._ingest_chunks, t._dispatch_fused
        api.close()
    assert status == 200 and body["hits"] and searched < SLOW_S, searched
    assert status_i == 200 and body_i["pages_crawled"] == 1 and body_i["chunks_ingested"] > 0
    assert status2 == 200 and phrase(77) in body2["hits"][0]["content"]
    assert ("ingest", True) in owned and all(held for _kind, held in owned)
    ing = [(a, b) for kind, a, b in spans if kind == "ingest"]
    for kind, a, b in spans:
        if kind == "search":
            assert all(b <= s or a >= e for s, e in ing), spans


def test_crawler_routes_match_jax(apps, github_on_site):
    j, t = apps["j"], apps["t"]
    root = github_on_site["root"]
    apis = {"j": JaxRagAPI(j), "t": RagAPI(t)}
    try:
        for path, body in (("/ingest/urls", {"urls": [root + "/p3.html", root + "/notes.txt"]}),
                           ("/ingest/github",
                            {"url": "https://github.com/o/r/blob/main/docs/notes.txt"})):
            (sj, rj), (st, rt) = (apis[k].handle("POST", path, body) for k in "jt")
            assert sj == st == 200 and _no_duration(rj) == _no_duration(rt), (rj, rt)
    finally:
        for api in apis.values():
            api.close()


def test_cli_ingest_urls_and_github(tmp_path, monkeypatch, capsys, github_on_site):
    monkeypatch.setenv("RADIANT_INDEX_DATA_DIR", str(tmp_path / "idx"))
    monkeypatch.setenv("RADIANT_BM25_INDEX_PATH", str(tmp_path / "bm25.json.gz"))
    monkeypatch.setenv("RADIANT_EMBEDDING_CHECKPOINT_DIR", "")
    monkeypatch.setenv("RADIANT_EMBEDDING_PRESET", "none")
    monkeypatch.setenv("RADIANT_INDEX_DIM", "32")
    for key, value in (("DIM", "32"), ("NUM_LAYERS", "1"), ("NUM_HEADS", "2"),
                       ("HIDDEN_DIM", "64"), ("VOCAB_SIZE", "500")):
        monkeypatch.setenv(f"RADIANT_EMBEDDING_{key}", value)
    monkeypatch.setenv("RADIANT_WEB_CRAWLER_RATE_LIMIT_DELAY_S", "0")
    monkeypatch.setenv("RADIANT_WEB_CRAWLER_MAX_DEPTH", "1")
    monkeypatch.setattr(tapp_mod, "create_app",
                        lambda config: tapp_mod.RadiantTPU(config, device="cpu"))
    assert tapp_mod.main(["ingest-urls", github_on_site["root"] + "/"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["pages_crawled"] == 5 and stats["chunks_ingested"] >= 5
    assert tapp_mod.main(["ingest-github", "https://github.com/o/r"]) == 0
    assert json.loads(capsys.readouterr().out)["files_fetched"] == 3


# ---------------------------------------------------------------- web search
def _agents(script=None, crawler=None, **kw):
    return (JaxWebSearch(JaxClient(backend=JaxMock(script=script or {}, default="[]")),
                         crawler=crawler, **kw),
            WebSearchAgent(LLMClient(backend=MockLLMBackend(script=script or {}, default="[]")),
                           crawler=crawler, **kw))


def test_web_search_triggers_and_blocks_as_jax():
    ja, ta = _agents(blocked_domains=("Evil.com",), trigger_keywords=("latest", "today"))
    for q, plan in (("what is the latest news on X", {}), ("explain photosynthesis", {}),
                    ("explain photosynthesis", {"use_web_search": True})):
        jc, tc = jax_ctx(q), new_agent_context(q)
        jc.plan, tc.plan = dict(plan), dict(plan)
        assert ta.should_trigger(tc) == ja.should_trigger(jc)
    for url in ("https://evil.com/x", "https://sub.evil.com/x", "https://notevil.com/x",
                "not a url"):
        assert ta.is_blocked(url) == ja.is_blocked(url)
    assert ta.is_blocked("https://sub.evil.com/x") and not ta.is_blocked("https://notevil.com/")


def test_web_search_fetch_cache_and_failures_as_jax(site):
    root = site["root"]
    script = {"Suggest up to": json.dumps([root + "/p1.html", "ftp://bad", root + "/missing",
                                           "https://blocked.org/x", root + "/p2.html"])}
    crawler = twc.WebCrawler(rate_limit_delay_s=0)
    ja, ta = _agents(script=script, crawler=crawler, blocked_domains=("blocked.org",),
                     max_urls=4)
    q = "latest today news"
    ref, got = ja.execute(jax_ctx(q)), ta.execute(new_agent_context(q))
    assert [(d.doc_id, d.content, d.meta, s) for d, s in got] == \
        [(d.doc_id, d.content, d.meta, s) for d, s in ref]
    assert [s for _, s in got] == [0.9, 0.75] and got[0][0].meta["web"] is True
    before = len(site["hits"])
    ctx = new_agent_context(q)
    assert ta.execute(ctx) == got and ctx.web_docs == got  # the TTL cache: no fetch
    assert len(site["hits"]) == before
    ctx = new_agent_context(q)
    ta.cache_ttl_s = 0.0  # expired: fetched again
    ta.execute(ctx)
    assert len(site["hits"]) > before
    # no crawler: a warning and no docs, as in the JAX package
    ja, ta = _agents(script=script)
    jc, tc = jax_ctx(q), new_agent_context(q)
    assert ta.execute(tc) == ja.execute(jc) == []
    assert tc.warnings == jc.warnings == ["web search unavailable: no crawler configured"]


def _web_responder(urls, plan_web=False):
    def respond(messages):
        last = messages[-1]["content"]
        if "public web page URLs" in last:
            return json.dumps(urls)
        if "query-planning agent" in last:
            from _torch_agentic_world import plan

            return plan(use_web_search=plan_web)
        if "Evaluate this answer" in last:
            return GOOD_CRITIQUE
        if "atomic factual claims" in last or "Match each answer" in last:
            return "[]"
        if "Context:" in last and "Question:" in last:
            return "Mitochondria produce ATP [DOC 1]."
        return "[]"
    return respond


def _orchestrators(apps, responder, empty=False, tmp=None, **sections):
    from radiant_rag_tpu.index.bm25 import PersistentBM25Index as JaxBM25
    from radiant_rag_tpu.index.store import TpuVectorStore as JaxStore
    from radiant_rag_tpu.orchestrator import RAGOrchestrator as JaxOrchestrator
    from radiant_rag_tpu_torch.index.bm25 import PersistentBM25Index
    from radiant_rag_tpu_torch.index.store import TpuVectorStore
    from radiant_rag_tpu_torch.orchestrator import RAGOrchestrator

    out = []
    for key, make, client, mock in (("j", JaxOrchestrator, JaxClient, JaxMock),
                                    ("t", RAGOrchestrator, LLMClient, MockLLMBackend)):
        app = apps[key]
        cfg, store, bm25, models = app.config, app.store, app.bm25_index, app.local_models
        if empty:
            if key == "j":
                store = JaxStore(dim=cfg.index.dim, index_config=cfg.index)
                bm25 = JaxBM25(store, path=str(tmp / "j.json.gz"))
            else:
                store = TpuVectorStore(dim=cfg.index.dim, index_config=cfg.index, device="cpu")
                bm25 = PersistentBM25Index(store, path=str(tmp / "t.json.gz"), device="cpu")
        cfg = replace_sections(cfg, **{"strategy_memory": {"enabled": False}, **sections})
        out.append(make(cfg, store, bm25, models, client(backend=mock(responder=responder)),
                        web_crawler=twc.WebCrawler(rate_limit_delay_s=0)
                        if key == "t" else jwc.WebCrawler(rate_limit_delay_s=0)))
    return out


def _docs(hits):
    return [(d.doc_id, round(s, 6)) for d, s in hits]


def test_web_fallback_on_empty_index_matches_jax(apps, site, tmp_path):
    """tests/test_orchestrator.py's case: nothing indexed, so the fetched
    pages are the context."""
    root = site["root"]
    jo, to = _orchestrators(apps, _web_responder([root + "/p5.html"]), empty=True,
                            tmp=tmp_path, pipeline={"use_web_search": True,
                                                    "use_context_eval": False})
    q = "What produces ATP in cells today?"
    ref, got = jo.run(q), to.run(q)
    assert _docs(got.web_docs) == _docs(ref.web_docs) and got.web_docs
    assert _docs(got.fused_docs) == _docs(ref.fused_docs) == _docs(got.web_docs)
    assert got.answer == ref.answer and "ATP" in got.answer
    assert phrase(5) in got.web_docs[0][0].content
    assert [s["name"] for s in to.get_agent_stats()] == [s["name"] for s in jo.get_agent_stats()]
    assert len(to.get_agent_stats()) == 15


def test_planned_web_search_fuses_as_jax(apps, site):
    root = site["root"]
    jo, to = _orchestrators(apps, _web_responder([root + "/p6.html", root + "/p7.html"],
                                                 plan_web=True),
                            pipeline={"use_web_search": True})
    q = "How do mitochondria make the energy of the cell"
    ref, got = jo.run(q), to.run(q)
    assert _docs(got.web_docs) == _docs(ref.web_docs) and len(got.web_docs) == 2
    assert [d.doc_id for d, _ in got.fused_docs] == [d.doc_id for d, _ in ref.fused_docs]
    for (a, sa), (b, sb) in zip(got.fused_docs, ref.fused_docs):
        assert sa == pytest.approx(sb, rel=1e-5, abs=1e-6)
    assert {d.doc_id for d, _ in got.web_docs} <= {d.doc_id for d, _ in got.fused_docs}
    assert [d.doc_id for d, _ in got.reranked_docs] == [d.doc_id for d, _ in ref.reranked_docs]
    assert got.answer == ref.answer


def test_app_without_a_crawler_warns_as_jax(apps, site):
    """The JAX app builds its orchestrator without a crawler, so web search
    through the app (`pipeline.use_web_search`) warns and fetches nothing;
    the port keeps that."""
    japp, tapp = apps["j"], apps["t"]
    before = len(site["hits"])
    q = "What do the documents say about laser light and wind turbines?"
    ref, got = japp.query(q, use_cache=False), tapp.query(q, use_cache=False)
    warning = "web search unavailable: no crawler configured"
    assert warning in got.warnings and warning in ref.warnings and got.web_docs == []
    assert tapp.orchestrator.web_search.crawler is None and tapp.orchestrator.web_search.enabled
    assert len(site["hits"]) == before
