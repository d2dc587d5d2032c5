"""The port's HTTP serving layer against the JAX package's (CPU).

`RagAPI.handle` of both packages over the apps of tests/_torch_app_world.py
(/search single through the coalescer, and the `queries` batch API, in the
three modes: doc ids in the same order, scores within tests/_torch_parity.py's
tolerance), the error paths, coalescing, the pipelined seam and the latency
percentiles, and one real HTTP server on 127.0.0.1:0. The coalescer unit
tests of tests/test_server.py run over both packages' `RequestCoalescer`.
Mirrors the search parts of `tests/test_server.py`.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from radiant_rag_tpu.server import RagAPI as JaxRagAPI
from radiant_rag_tpu.utils.batching import RequestCoalescer as JaxCoalescer
from radiant_rag_tpu_torch.server import RagAPI, make_server
from radiant_rag_tpu_torch.utils.batching import RequestCoalescer

from _torch_agentic_world import Responder, assert_runs_match
from _torch_app_world import QUERIES, assert_hits_match, make_apps, write_docs

COALESCERS = {"jax": JaxCoalescer, "torch": RequestCoalescer}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("srv")
    docs = write_docs(tmp / "docs", n_files=12)
    japp, tapp = make_apps(tmp)
    japp.ingest_documents([str(docs)])
    tapp.ingest_documents([str(docs)])
    server = make_server(tapp, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    apis = {"j": JaxRagAPI(japp), "t": RagAPI(tapp)}
    yield {"j": japp, "t": tapp, "port": server.server_address[1], "api": apis}
    server.shutdown()
    server.server_close()
    server.api.close()
    for api in apis.values():
        api.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _req(port, method, path, body=None, raw=None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


class _Doc:
    def __init__(self, hit):
        self.doc_id = hit["doc_id"]


def _as_hits(hit_dicts):
    return [(_Doc(h), h["score"]) for h in hit_dicts]


@pytest.mark.parametrize("mode", ["hybrid", "dense", "bm25"])
def test_search_matches_jax(served, mode):
    """/search single (through each package's coalescer) and batch API."""
    ref, got = [], []
    for q in QUERIES:
        body = {"query": q, "mode": mode, "top_k": 6}
        (js, jb), (ts, tb) = (served["api"][k].handle("POST", "/search", body) for k in "jt")
        assert js == ts == 200
        ref.append(_as_hits(jb["hits"]))
        got.append(_as_hits(tb["hits"]))
    assert any(got)
    assert_hits_match(ref, got, f"/search {mode}")
    body = {"queries": QUERIES, "mode": mode, "top_k": 6}
    (js, jb), (ts, tb) = (served["api"][k].handle("POST", "/search", body) for k in "jt")
    assert js == ts == 200
    assert_hits_match([_as_hits(h) for h in jb["hits_batch"]],
                      [_as_hits(h) for h in tb["hits_batch"]], f"/search batch {mode}")
    assert_hits_match(ref, [_as_hits(h) for h in tb["hits_batch"]], f"single vs batch {mode}")
    hit = tb["hits_batch"][0][0]
    assert set(hit) == {"doc_id", "score", "source", "content", "meta"}


def test_http_round_trip(served):
    port = served["port"]
    status, body = _req(port, "GET", "/health")
    assert status == 200 and body["ok"] and body["llm"] is True  # the mock LLM answers
    status, body = _req(port, "POST", "/search",
                        {"query": "laser light crystal", "mode": "bm25", "top_k": 3})
    assert status == 200 and body["hits"] and "laser" in body["hits"][0]["content"].lower()
    status, body = _req(port, "POST", "/search", {"queries": ["wind turbine", "memory cache"],
                                                  "top_k": 2})
    assert status == 200 and len(body["hits_batch"]) == 2
    status, body = _req(port, "GET", "/stats")
    assert status == 200 and body["index"]["num_embedded"] > 0
    assert {"requests", "batches", "max_batch", "pipelined"} <= set(body["serving"])
    assert _req(port, "POST", "/search", raw=b"{not json")[0] == 400
    assert _req(port, "POST", "/search", raw=b"[1, 2]")[0] == 400
    status, body = _req(port, "POST", "/ingest/urls", {"urls": ["http://localhost/"]})
    assert status == 500 and "item 11" in body["error"]


def test_error_paths_match_jax(served):
    cases = [("POST", "/search", {}, 400), ("POST", "/search", {"queries": ["ok", ""]}, 400),
             ("POST", "/search", {"query": "x", "mode": "nope"}, 400),
             ("POST", "/query", {}, 400), ("POST", "/nope", {}, 404), ("GET", "/nope", {}, 404),
             ("POST", "/ingest/documents", {}, 400), ("POST", "/ingest/urls", {}, 400),
             ("POST", "/ingest/github", {}, 400), ("POST", "/simple_query", {}, 400)]
    for method, path, body, code in cases:
        for k in "jt":
            status, out = served["api"][k].handle(method, path, body)
            assert status == code, (k, method, path, out)
    status, body = served["api"]["t"].handle("POST", "/search", {"query": "x", "mode": "nope"})
    assert "mode" in body["error"]


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/ingest/urls", {"urls": ["http://localhost/"]}),
    ("POST", "/ingest/github", {"url": "https://localhost/repo"}),
])
def test_deferred_routes_answer_500_with_the_reason(served, method, path, body):
    status, out = served["api"]["t"].handle(method, path, body)
    assert status == 500 and out["error"].startswith("NotImplementedError")
    assert "ROADMAP queue A item 11 (rest)" in out["error"]


def test_handler_exception_to_500(served):
    api = RagAPI(served["t"], coalesce=False)

    class Boom:
        config = served["t"].config

        def __getattr__(self, name):
            raise RuntimeError("kaput")

    api.app = Boom()
    status, body = api.handle("POST", "/search", {"query": "x"})
    assert status == 500 and "kaput" in body["error"]


def test_ingest_documents_route(served, tmp_path):
    (tmp_path / "new.txt").write_text("Quasars shine across the early universe. " * 4)
    t = served["t"]
    n = t.store.count_documents()
    status, out = served["api"]["t"].handle("POST", "/ingest/documents",
                                            {"paths": [str(tmp_path)]})
    assert status == 200 and out["chunks_ingested"] == 1
    assert t.store.count_documents() == n + 2  # a parent and its leaf


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_request_coalescer_unit(impl):
    batches = []

    def run_batch(key, items):
        batches.append((key, list(items)))
        if key == "bad":
            raise ValueError("boom")
        return [f"{key}:{i}" for i in items]

    c = COALESCERS[impl](run_batch, max_batch=8, max_wait_ms=30.0)
    barrier = threading.Barrier(6)
    results, errors = {}, {}

    def worker(key, item):
        barrier.wait()
        try:
            results[(key, item)] = c.submit(key, item, timeout=10.0)
        except Exception as exc:
            errors[(key, item)] = exc

    threads = [threading.Thread(target=worker, args=("a", i)) for i in range(4)]
    threads += [threading.Thread(target=worker, args=("b", 9)),
                threading.Thread(target=worker, args=("bad", 0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for i in range(4):  # per-item results routed, keys never mixed
        assert results[("a", i)] == f"a:{i}"
    assert results[("b", 9)] == "b:9"
    assert isinstance(errors[("bad", 0)], ValueError)
    for _key, items in batches:
        assert len(set(items)) == len(items)
    assert c.stats["requests"] == 6
    assert c.stats["max_batch"] >= 2  # the 4 "a" submits coalesced
    c.stop()
    with pytest.raises(RuntimeError):
        c.submit("a", 1)


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_request_coalescer_pipelined_unit(impl):
    """Two-phase run_batch_async: up to pipeline_depth batches in flight,
    results and errors routed to their callers, only completes that declare
    the device seam counted as pipelined."""
    dispatched, completed = [], []

    def run_async(key, items):
        dispatched.append((key, list(items)))
        if key == "bad-dispatch":
            raise ValueError("dispatch boom")

        def complete():
            time.sleep(0.02)  # the device->host copy
            completed.append(key)
            if key == "bad-complete":
                raise ValueError("complete boom")
            return [f"{key}:{i}" for i in items]

        if key != "sync-fallback":
            complete.pipelined = True
        return complete

    c = COALESCERS[impl](lambda k, it: [], max_batch=8, max_wait_ms=5.0,
                         run_batch_async=run_async, pipeline_depth=2)
    results, errors = {}, {}

    def worker(key, item):
        try:
            results[(key, item)] = c.submit(key, item, timeout=10.0)
        except Exception as exc:
            errors[(key, item)] = exc

    threads = [threading.Thread(target=worker, args=(k, i))
               for k in ("a", "b", "c", "bad-dispatch", "bad-complete", "sync-fallback")
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for k in ("a", "b", "c", "sync-fallback"):
        for i in range(2):
            assert results[(k, i)] == f"{k}:{i}"
    assert isinstance(errors[("bad-dispatch", 0)], ValueError)
    assert isinstance(errors[("bad-complete", 1)], ValueError)
    assert 3 <= c.stats["pipelined"] < c.stats["batches"]
    c.stop()


def test_concurrent_searches_coalesce_into_one_batch(served):
    app = served["t"]
    calls = []
    orig = app.search_batch_async

    def spy(queries, mode="hybrid", top_k=10, use_cache=True):
        calls.append(len(queries))
        return orig(queries, mode=mode, top_k=top_k, use_cache=use_cache)

    app.search_batch_async = spy
    api = RagAPI(app, max_wait_ms=60.0)
    try:
        n = 8
        barrier = threading.Barrier(n)
        out = [None] * n

        def worker(i):
            barrier.wait()
            out[i] = api.handle("POST", "/search", {"query": f"kernel thread token {i}",
                                                    "mode": "hybrid", "top_k": 3})

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for status, body in out:
            assert status == 200 and body["hits"]
        assert api._coalescer.stats["max_batch"] >= 2 and max(calls) >= 2
        assert api._coalescer.stats["pipelined"] >= 1  # hybrid takes the device seam
    finally:
        api.close()
        del app.search_batch_async


def test_search_batch_async_matches_sync(served):
    app = served["t"]
    queries = ["laser light crystal", "signal noise", "wind turbine power"]
    sync = app.search_batch(list(queries), mode="hybrid", top_k=5, use_cache=False)
    complete = app.search_batch_async(list(queries), mode="hybrid", top_k=5, use_cache=False)
    assert complete.pipelined
    pipelined = complete()
    assert any(sync)
    assert [[(d.doc_id, s) for d, s in h] for h in pipelined] == \
        [[(d.doc_id, s) for d, s in h] for h in sync]


def test_stats_search_latency_percentiles(served):
    port = served["port"]
    for _ in range(3):
        _req(port, "POST", "/search", {"query": "memory cache", "top_k": 2})
    status, body = _req(port, "GET", "/stats")
    assert status == 200
    lat = body["search_latency_ms"]
    assert lat["count"] >= 3 and lat["window"] >= 3
    assert 0 <= lat["p50"] <= lat["p90"] <= lat["p99"]


# ---------------------------------------------------------------- the agentic routes
QUESTION = "Explain how the laser mirror and crystal turn photon light into a signal"


@pytest.fixture(scope="module")
def qserved(tmp_path_factory):
    """Both packages' APIs over apps with the same corpus (no test changes
    it) and the scripted LLM, and the port's real server."""
    tmp = tmp_path_factory.mktemp("qsrv")
    docs = write_docs(tmp / "docs", n_files=8)
    japp, tapp = make_apps(tmp, responder=Responder())
    japp.ingest_documents([str(docs)])
    tapp.ingest_documents([str(docs)])
    server = make_server(tapp, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    apis = {"j": JaxRagAPI(japp, coalesce=False), "t": RagAPI(tapp, coalesce=False)}
    yield {"j": japp, "t": tapp, "port": server.server_address[1], "api": apis}
    server.shutdown()
    server.server_close()
    server.api.close()
    thread.join(timeout=10)


class _Result:
    """A /query body as the fields assert_runs_match reads."""

    def __init__(self, body):
        self.__dict__.update(body)


def test_query_route_matches_jax(qserved):
    (js, jb), (ts, tb) = (qserved["api"][k].handle("POST", "/query", {"question": QUESTION})
                          for k in "jt")
    assert js == ts == 200 and tb["success"] and not tb["degraded"]
    for key in ("answer", "plan", "effective_queries", "retry_count", "confidence",
                "low_confidence", "num_docs", "fact_verification", "degraded"):
        assert tb[key] == jb[key], key
    assert {k: v for k, v in tb["citations"].items() if k != "audit_id"} == \
        {k: v for k, v in jb["citations"].items() if k != "audit_id"}
    assert set(tb) == set(jb)
    (js, jb), (ts, tb) = (qserved["api"][k].handle("POST", "/simple_query",
                                                   {"question": "laser mirror"}) for k in "jt")
    assert js == ts == 200 and tb == jb


def test_conversations_route(qserved):
    port = qserved["port"]
    status, body = _req(port, "POST", "/conversations", {})
    assert status == 200 and len(body["conversation_id"]) == 16
    cid = body["conversation_id"]
    first = _req(port, "POST", "/query", {"question": QUESTION, "conversation_id": cid})[1]
    t = qserved["t"]
    n = len(t.llm.backend.calls)
    second = _req(port, "POST", "/query", {"question": "And how does the lens filter the noise "
                                                       "from that signal afterwards?",
                                           "conversation_id": cid})[1]
    synth = [c for c in t.llm.backend.calls[n:] if c[-1]["content"].startswith("Context:")][0]
    assert synth[1:3] == [{"role": "user", "content": QUESTION},
                          {"role": "assistant", "content": first["answer"]}]
    assert second["success"] and [tt.query for tt in t.conversations.get(cid).turns] == \
        [QUESTION, second["query"]]


def _sse(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/query/stream",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        assert resp.headers["Connection"] == "close"
        raw = resp.read().decode()
    assert raw.endswith("\n\n")
    return [json.loads(chunk[len("data: "):]) for chunk in raw.split("\n\n") if chunk]


def test_query_stream_route_is_server_sent_events(qserved):
    events = _sse(qserved["port"], {"question": QUESTION + " now"})
    kinds = [e["event"] for e in events]
    assert kinds[0] == "step_start" and kinds[-1] == "result" and kinds.count("result") == 1
    assert "token" in kinds and "error" not in kinds
    starts = [e["step"] for e in events if e["event"] == "step_start"]
    assert starts == [e["step"] for e in events if e["event"] == "step_end"]
    assert {"planning", "retrieval", "post_retrieval", "generation", "critique"} <= set(starts)
    assert events[-1]["success"] and events[-1]["answer"]
    assert _req(qserved["port"], "POST", "/query/stream", {})[0] == 400
    # the JAX RagAPI.handle has no /query/stream (its SSE lives in the handler)
    assert qserved["api"]["t"].handle("POST", "/query/stream", {"question": "x"})[0] == \
        qserved["api"]["j"].handle("POST", "/query/stream", {"question": "x"})[0] == 404


def test_query_routes_report_a_device_failure(qserved, monkeypatch):
    """A failing embed on the card: /query answers 500 with the reason and
    /query/stream ends in an error event; nothing degrades silently."""
    t = qserved["t"]

    def broken(*a, **kw):
        raise RuntimeError("embedder lost")

    monkeypatch.setattr(t.local_models, "embed_device", broken)
    monkeypatch.setattr(t.local_models, "embed", broken)
    question = "Explain how a kernel thread scores every token in a batch of queries"
    status, body = _req(qserved["port"], "POST", "/query", {"question": question})
    assert status == 500 and body["error"].startswith("DeviceStageError")
    assert "embedder lost" in body["error"]
    events = _sse(qserved["port"], {"question": question + " again"})
    assert events[-1]["event"] == "error" and "embedder lost" in events[-1]["error"]
    assert "result" not in [e["event"] for e in events]


def test_query_takes_the_device_lock_per_stage(qserved):
    """While a /query waits on a slow LLM, /search runs: the run holds the
    device lock only inside its device stages."""
    t = qserved["t"]
    api = RagAPI(t, coalesce=False)
    assert api._lock is t.device_lock is t.orchestrator.device_stage.lock
    gate, entered = threading.Event(), threading.Event()
    backend = t.llm.backend
    responder = backend.responder

    def slow(messages):
        if messages[-1]["content"].startswith("Context:"):
            entered.set()
            assert gate.wait(30)
        return responder(messages)

    backend.responder = slow
    try:
        worker = threading.Thread(target=lambda: api.handle(
            "POST", "/query", {"question": "Explain how memory cache and the index serve "
                                           "every vector query search"}))
        worker.start()
        assert entered.wait(30)
        assert t.device_lock.acquire(blocking=False)  # no other thread holds it
        t.device_lock.release()
        status, body = api.handle("POST", "/search", {"query": "laser", "mode": "hybrid"})
        assert status == 200 and body["hits"]
    finally:
        gate.set()
        worker.join(30)
        backend.responder = responder
        api.close()
