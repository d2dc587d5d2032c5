"""HTTP serving layer: a JSON API over the application facade.

The port's counterpart of `radiant_rag_tpu/server.py`. Endpoints:

  GET  /health            component health (503 when degraded)
  GET  /stats             index and serving statistics, /search latency percentiles
  POST /search            {"query": str, "mode"?: "hybrid|dense|bm25", "top_k"?: int}
                          or {"queries": [str], ...}: one batch, "hits_batch" back
  POST /query             {"question": str, "conversation_id"?: str}: the agentic
                          pipeline's result and answer
  POST /query/stream      the same as Server-Sent Events: step_start / step_end,
                          token, then one result (or error) event; the connection
                          closes at the end of the stream
  POST /simple_query      {"question": str}: the minimal RAG path
  POST /conversations     a new conversation id
  POST /ingest/documents  {"paths": [str], "recursive"?: bool}
  POST /ingest/urls       {"urls": [str]}: a breadth-first crawl of each, ingested
  POST /ingest/github     {"url": str}: a GitHub repository's files, ingested

Implementation: stdlib ThreadingHTTPServer. Device work is serialized
through the app's `device_lock` (`RagAPI._lock`): the search batches,
/health's embedding, and each device stage of a /query run, which takes it
per stage, never across an LLM call, so a slow LLM does not stall /search.
The three ingest routes leave the lock to the app, which holds it only for
the ingest's device work (the embed, upsert and BM25 sync): reading files
and the crawl's network I/O run outside it, so a slow disk or site does
not stall /search either (the JAX routes hold the lock across the whole
ingest, crawl included). /search scales past the lock by cross-request coalescing
(`utils/batching.py`): concurrent searches with the same (mode, top_k)
merge into one batch, and with `server.pipeline_depth` > 1 the coalescer
dispatches a batch under the lock and resolves it outside, so one batch's
device->host copy overlaps the next batch's dispatch. A coalescer thread
dispatches on its current CUDA stream, the default stream, as every other
thread of the process does.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from contextlib import nullcontext
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from radiant_rag_tpu_torch.utils.batching import RequestCoalescer

logger = logging.getLogger(__name__)

_SEARCH_MODES = ("hybrid", "dense", "bm25")


def hit_dicts(hits):
    """/search's JSON records of (doc, score) hits."""
    return [{"doc_id": d.doc_id, "score": s, "source": d.source, "content": d.content[:1000],
             "meta": d.meta} for d, s in hits]


class RagAPI:
    """Transport-independent request handlers (unit-testable)."""

    def __init__(self, app, coalesce: Optional[bool] = None, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None) -> None:
        self.app = app
        self._lock = app.device_lock  # shared with the app's pipeline runs
        # per-request /search wall-time ring for /stats latency percentiles
        self._lat = collections.deque(maxlen=4096)
        self._lat_lock = threading.Lock()
        self._lat_count = 0
        scfg = app.config.server
        if coalesce is None:
            coalesce = scfg.coalesce
        # bounded host-path concurrency: at most request_workers connection
        # threads in their parse / serialize sections at once, so
        # oversubscribed clients queue instead of time-slicing the
        # interpreter lock; waits in the coalescer or on the device lock
        # hold no slot
        workers = scfg.request_workers
        self.work_gate = threading.BoundedSemaphore(workers) if workers > 0 else None
        self._coalescer: Optional[RequestCoalescer] = None
        if coalesce:
            depth = scfg.pipeline_depth
            self._coalescer = RequestCoalescer(
                self._run_search_batch,
                max_batch=max_batch if max_batch is not None else scfg.max_batch,
                max_wait_ms=max_wait_ms if max_wait_ms is not None else scfg.max_wait_ms,
                name="search",
                run_batch_async=self._dispatch_search_batch if depth > 1 else None,
                pipeline_depth=depth)

    def _run_search_batch(self, key, queries):
        mode, top_k = key
        with self._lock:
            return self.app.search_batch(list(queries), mode=mode, top_k=top_k)

    def _dispatch_search_batch(self, key, queries):
        """Dispatch under the device lock; the returned complete() waits for
        the copy without holding it (the docstore's reads take its own)."""
        mode, top_k = key
        with self._lock:
            return self.app.search_batch_async(list(queries), mode=mode, top_k=top_k)

    def close(self) -> None:
        if self._coalescer is not None:
            self._coalescer.stop()
            self._coalescer = None

    def stream_query(self, question: str, conversation_id: str = ""):
        """The event dicts of /query/stream; the run takes the device lock
        per device stage (module doc)."""
        yield from self.app.query_stream(question, conversation_id)

    def _record(self, seconds: float, count: int) -> None:
        with self._lat_lock:
            self._lat.append(seconds)
            self._lat_count += count

    def latency_ms(self) -> Optional[Dict[str, float]]:
        """p50 / p90 / p99 of the recent /search requests' wall times (a
        batch-API request counts as its per-query share)."""
        with self._lat_lock:
            lat = sorted(self._lat)
            total = self._lat_count
        if not lat:
            return None

        def pick(q):
            return round(lat[min(len(lat) - 1, int(q * len(lat)))] * 1000, 1)

        return {"count": total, "window": len(lat), "p50": pick(0.50), "p90": pick(0.90),
                "p99": pick(0.99)}

    def handle(self, method: str, path: str, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        try:
            return self._handle(method, path, body)
        except Exception as exc:  # the server keeps serving; the caller gets the reason
            logger.exception("request failed: %s %s", method, path)
            return 500, {"error": f"{type(exc).__name__}: {exc}"}

    def _handle(self, method: str, path: str, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        if method == "GET" and path == "/health":
            health = self.app.check_health()  # its embed takes the device lock
            return (200 if health.get("ok") else 503), health
        if method == "GET" and path == "/stats":
            stats = dict(self.app.get_stats())
            if self._coalescer is not None:
                stats["serving"] = dict(self._coalescer.stats)
            lat = self.latency_ms()
            if lat is not None:
                stats["search_latency_ms"] = lat
            return 200, stats
        if method == "POST" and path == "/search":
            return self._search(body)
        if method == "POST" and path == "/query":
            question = body.get("question", "")
            if not question:
                return 400, {"error": "missing 'question'"}
            result = self.app.query(question, conversation_id=body.get("conversation_id", ""))
            return 200, result.to_dict() | {"answer": result.answer}
        if method == "POST" and path == "/simple_query":
            question = body.get("question", "")
            if not question:
                return 400, {"error": "missing 'question'"}
            return 200, {"answer": self.app.simple_query(question)}
        if method == "POST" and path == "/ingest/documents":
            paths = body.get("paths") or []
            if not paths:
                return 400, {"error": "missing 'paths'"}
            return 200, self.app.ingest_documents(  # the lock: its ingest only
                paths, recursive=bool(body.get("recursive", True)))
        if method == "POST" and path == "/ingest/urls":
            urls = body.get("urls") or []
            if not urls:
                return 400, {"error": "missing 'urls'"}
            return 200, self.app.ingest_urls(urls)  # the lock: its ingest only
        if method == "POST" and path == "/ingest/github":
            url = body.get("url", "")
            if not url:
                return 400, {"error": "missing 'url'"}
            return 200, self.app.ingest_github(url)  # the lock: its ingest only
        if method == "POST" and path == "/conversations":
            return 200, {"conversation_id": self.app.start_conversation()}
        return 404, {"error": f"unknown endpoint {method} {path}"}

    def _search(self, body: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        query = body.get("query", "")
        queries = body.get("queries")
        if not query and not queries:
            return 400, {"error": "missing 'query' (or 'queries')"}
        mode = body.get("mode", "hybrid")
        if mode not in _SEARCH_MODES:
            return 400, {"error": f"mode must be one of {_SEARCH_MODES}"}
        top_k = int(body.get("top_k", 10))
        if queries:
            # the batch API: one request = one batch of N queries
            if not isinstance(queries, list) or \
                    not all(isinstance(q, str) and q for q in queries):
                return 400, {"error": "'queries' must be a list of non-empty strings"}
            t0 = time.perf_counter()
            with self._lock:
                batched = self.app.search_batch(list(queries), mode=mode, top_k=top_k)
            self._record((time.perf_counter() - t0) / len(queries), len(queries))
            return 200, {"hits_batch": [hit_dicts(h) for h in batched]}
        t0 = time.perf_counter()
        if self._coalescer is not None:
            hits = self._coalescer.submit((mode, top_k), query, timeout=120.0)
        else:
            with self._lock:
                hits = self.app.search(query, mode=mode, top_k=top_k)
        self._record(time.perf_counter() - t0, 1)
        return 200, {"hits": hit_dicts(hits)}


def make_server(app, host: str = "0.0.0.0", port: int = 8080) -> ThreadingHTTPServer:
    api = RagAPI(app)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response carries Content-Length, so a
        # client reuses its connection
        protocol_version = "HTTP/1.1"

        def _respond(self, method: str) -> None:
            # parse and serialize run under the bounded work gate;
            # api.handle's waits (coalescer, device lock) run outside it
            gate = api.work_gate if api.work_gate is not None else nullcontext()
            # the socket read and write stay outside the gate: a slow
            # client must not hold a slot
            length = int(self.headers.get("Content-Length", 0) or 0)
            raw = self.rfile.read(length) if length else b""
            with gate:
                try:
                    body = json.loads(raw) if raw else {}
                except json.JSONDecodeError:
                    body = None
            if not isinstance(body, dict):
                status, payload = 400, {"error": "invalid JSON body"}
            else:
                status, payload = api.handle(method, self.path.rstrip("/") or "/", body)
            with gate:
                data = json.dumps(payload, default=str).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            self._respond("GET")

        def do_POST(self):  # noqa: N802
            if (self.path.rstrip("/") or "/") == "/query/stream":
                self._stream_query()
                return
            self._respond("POST")

        def _stream_query(self) -> None:
            length = int(self.headers.get("Content-Length", 0) or 0)
            try:
                body = json.loads(self.rfile.read(length)) if length else {}
            except json.JSONDecodeError:
                body = None
            question = body.get("question", "") if isinstance(body, dict) else ""
            if not question:
                data = json.dumps({"error": "missing 'question'"}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            # an unbounded body: under HTTP/1.1 the client sees its end by
            # the connection's close, so this response opts out of keep-alive
            self.send_header("Connection", "close")
            self.close_connection = True
            self.end_headers()
            try:
                for event in api.stream_query(question, body.get("conversation_id", "")):
                    self.wfile.write(f"data: {json.dumps(event, default=str)}\n\n".encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                logger.info("stream client disconnected")

        def log_message(self, fmt, *args):  # route through logging
            logger.info("%s %s", self.address_string(), fmt % args)

    server = ThreadingHTTPServer((host, port), Handler)
    server.api = api  # type: ignore[attr-defined]  (tests, clean close)
    return server


def serve(app, host: str = "0.0.0.0", port: int = 8080) -> None:
    server = make_server(app, host, port)
    logger.info("serving on %s:%d", host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.api.close()  # type: ignore[attr-defined]
