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
    assert status == 200 and body["ok"] and body["llm"] is False
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
    ("POST", "/query", {"question": "what do lasers emit?"}),
    ("POST", "/query/stream", {"question": "what do lasers emit?"}),
    ("POST", "/simple_query", {"question": "what do lasers emit?"}),
    ("POST", "/ingest/urls", {"urls": ["http://localhost/"]}),
    ("POST", "/ingest/github", {"url": "https://localhost/repo"}),
    ("POST", "/conversations", {}),
])
def test_deferred_routes_answer_500_with_the_reason(served, method, path, body):
    status, out = served["api"]["t"].handle(method, path, body)
    assert status == 500 and out["error"].startswith("NotImplementedError")
    assert "ROADMAP queue A item 11" in out["error"]


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
