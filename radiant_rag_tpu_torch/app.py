"""RadiantTPU: the application facade and CLI of the port.

The port's counterpart of `radiant_rag_tpu/app.py`, under the same name so
each method has its counterpart: ingestion (files or chunks -> hierarchical
parent / leaf chunks -> embed on the device -> upsert -> BM25 sync), the
query cache, `search` / `search_batch` / `search_batch_async` in the hybrid,
dense and bm25 modes, `warmup`, the admin calls, the crawled ingests
(`ingest_urls`: a breadth-first web crawl; `ingest_github`: a repository's
files with code-aware chunking), and the agentic query path:
`query` (cached), `query_raw`, `query_stream` (progress, token and result
events), `simple_query` and conversations, and `train` (fine-tune the
embedder on the corpus, then hot-swap it). Hybrid search is the fused
`HybridSearcher.search_rows` over the store's engine, fed by the query
embeddings on the device (`embed_queries_device` -> `_qdev`), at the
calibrated fusion (`fusion_weighting: auto`). Over a sharded pod store
(`index.backend: sharded`) hybrid search is the store's own
`search_hybrid` (per-shard kernels, merged legs, the delta segment), with
the calibration over the source engine carried to it first.

Card work is serialized by one lock, `device_lock`, which the server's
search batches, /health's embed and every device stage of a pipeline run
take; a run holds it only for its device stages, never across an LLM call,
`train` for each mining search, each step and the swap, and every ingest
(`ingest_documents`, `ingest_chunks`, the crawled ingests) only for its
embed, upsert and BM25 sync (`_ingest_chunks`): reading and parsing files
and the crawl itself (slow network I/O) run outside it, so they never
stall the server's searches.
As in the JAX package, the app's orchestrator has no web crawler:
`pipeline.use_web_search` through the app warns "web search unavailable:
no crawler configured" (give `RAGOrchestrator` a `WebCrawler` to fetch).

The CLI (`main`) prints answers and search hits through `ui/display.py`
(stats and health as JSON), saves reports
(`query --report`, `search --save`, ui/reports.py) and runs the terminal
UI (`tui`, ui/tui.py).

`RadiantTPU(device=None)` runs on CUDA and raises without a card; tests
pass device="cpu". `train` runs on `create_mesh()` (every visible CUDA
device on 'data', as the JAX app trains on its default mesh), or on the
1 x 1 mesh of a device the app was built on by name.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import re
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from radiant_rag_tpu_torch import resolve_device
from radiant_rag_tpu_torch.config import AppConfig, config_from_dict, load_config
from radiant_rag_tpu_torch.index.bm25 import PersistentBM25Index
from radiant_rag_tpu_torch.index.factory import create_vector_store
from radiant_rag_tpu_torch.index.hybrid import embed_queries_device, resolve_fused_depth
from radiant_rag_tpu_torch.ingestion.processor import (
    ChunkSplitter, DocumentProcessor, IngestedChunk,
)
from radiant_rag_tpu_torch.llm.client import LLMClient
from radiant_rag_tpu_torch.orchestrator import (
    PipelineResult, RAGOrchestrator, SimplifiedOrchestrator,
)
from radiant_rag_tpu_torch.utils.cache import QueryCache
from radiant_rag_tpu_torch.utils.conversation import ConversationManager
from radiant_rag_tpu_torch.utils.logging import setup_logging
from radiant_rag_tpu_torch.utils.metrics import MetricsCollector

logger = logging.getLogger(__name__)

Hits = List[Tuple[Any, float]]


class RadiantTPU:
    """The application facade."""

    def __init__(self, config: Optional[AppConfig] = None, llm: Optional[LLMClient] = None,
                 local_models=None, store=None, device=None) -> None:
        # the JAX package also enables its persistent compilation cache here;
        # the port's kernels are built once per checkout (`_build.py`) and
        # PyTorch eager compiles nothing per shape, so there is no counterpart
        self.config = config or config_from_dict({})
        self.device = resolve_device(device)
        self._named_device = device is not None  # train's mesh (module doc)
        self.device_lock = threading.RLock()  # module doc
        self.store = store if store is not None else create_vector_store(self.config,
                                                                         self.device)
        self.llm = llm or LLMClient(self.config.llm)
        if local_models is None:
            from radiant_rag_tpu_torch.models.registry import LocalNLPModels

            local_models = LocalNLPModels(self.config, device=self.device)
        self.local_models = local_models
        self.bm25_index = PersistentBM25Index.from_config(self.store, self.config.bm25,
                                                          device=self.device)
        self._attach_bm25()
        conv = self.config.conversation
        self.conversations = ConversationManager(
            max_turns=conv.max_turns, data_dir=conv.data_dir, ttl_s=conv.ttl_s,
        ) if conv.enabled else None
        self.metrics_collector = MetricsCollector()
        self.query_cache = QueryCache(self.config.cache.query_cache_size,
                                      self.config.cache.query_cache_ttl_s)
        ing = self.config.ingestion
        self.processor = DocumentProcessor(chunk_size=ing.max_parent_chars // 10,
                                           overlap=ing.chunk_overlap,
                                           pdf_strategy=ing.pdf_strategy)
        self.orchestrator = RAGOrchestrator(
            self.config, self.store, self.bm25_index, self.local_models, self.llm,
            conversation_manager=self.conversations,
            metrics_collector=self.metrics_collector, device_lock=self.device_lock)
        self._simple = SimplifiedOrchestrator(self.store, self.local_models, self.llm,
                                              device_lock=self.device_lock)

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def ingest_documents(self, paths: Sequence[str], recursive: bool = True) -> Dict[str, Any]:
        """Parse -> hierarchical chunks -> embed (device) -> upsert -> BM25
        sync; the device lock is held for the ingest only (module doc)."""
        t0 = time.time()
        chunks = self.processor.process_paths(paths, recursive=recursive)
        with self.device_lock:
            return self._ingest_chunks(chunks, t0)

    def ingest_chunks(self, chunks: Sequence[IngestedChunk]) -> Dict[str, Any]:
        with self.device_lock:
            return self._ingest_chunks(list(chunks), time.time())

    def _ingest_chunks(self, chunks: List[IngestedChunk], t0: float) -> Dict[str, Any]:
        cfg = self.config.ingestion
        parents = 0
        children: List[Tuple[str, Dict[str, Any]]] = []
        if cfg.hierarchical:
            splitter = ChunkSplitter(cfg.child_chunk_size, cfg.chunk_overlap)
            parent_docs: List[Tuple[str, Dict[str, Any]]] = []
            for chunk in chunks:
                pmeta = {**chunk.meta, "doc_level": "parent"}
                parent_id = self.store.make_doc_id(chunk.content, pmeta)
                parent_docs.append((chunk.content, pmeta))
                for j, piece in enumerate(splitter.split(chunk.content)):
                    children.append((piece, {**chunk.meta, "doc_level": "leaf",
                                             "parent_id": parent_id, "chunk_index": j}))
            self.store.upsert_doc_only_batch(parent_docs)
            parents = len(parent_docs)
        else:
            children = [(c.content, {**c.meta, "doc_level": "leaf"}) for c in chunks]

        # pre-size the index for the whole load: one growth, not one per doubling
        if hasattr(self.store, "reserve"):
            self.store.reserve(len(children))
        n = 0
        bs = max(cfg.upsert_batch_size, 1)
        for start in range(0, len(children), bs):
            batch = children[start:start + bs]
            embeddings = self.local_models.embed([c for c, _m in batch])
            self.store.upsert_batch([(content, meta, embeddings[i])
                                     for i, (content, meta) in enumerate(batch)])
            n += len(batch)

        added, removed = self.bm25_index.sync_with_store()
        self.query_cache.clear()  # the index changed; cached answers are stale
        self._auto_persist("index auto-persist")
        return {"chunks_ingested": n, "parents": parents, "bm25_added": added,
                "bm25_removed": removed, "duration_s": round(time.time() - t0, 2)}

    def _auto_persist(self, what: str) -> None:
        """Save the store under index.data_dir when index.auto_persist is on.
        A failed write is logged and serving goes on, as in the JAX package."""
        if self.config.index.auto_persist and hasattr(self.store, "save"):
            try:
                self.store.save(self.config.index.data_dir)
            except OSError as exc:
                logger.warning("%s failed: %s", what, exc)

    def ingest_urls(self, urls: Sequence[str]) -> Dict[str, Any]:
        """Crawl each URL breadth-first (the `web_crawler` section), split
        each page into chunks and ingest them; the device lock is held for
        the ingest only (module doc)."""
        from radiant_rag_tpu_torch.ingestion.web_crawler import WebCrawler

        wc = self.config.web_crawler
        crawler = WebCrawler(
            max_depth=wc.max_depth, max_pages=wc.max_pages,
            same_domain_only=wc.same_domain_only,
            rate_limit_delay_s=wc.rate_limit_delay_s, timeout_s=wc.timeout_s,
            include_patterns=wc.include_patterns, exclude_patterns=wc.exclude_patterns,
        )
        chunks: List[IngestedChunk] = []
        pages = 0
        for url in urls:
            for result in crawler.crawl(url):
                pages += 1
                for j, piece in enumerate(self.processor.splitter.split(result.text)):
                    chunks.append(IngestedChunk(
                        content=piece,
                        meta={"source": result.url, "title": result.title,
                              "chunk_index": j}))
        with self.device_lock:
            stats = self._ingest_chunks(chunks, time.time())
        stats["pages_crawled"] = pages
        return stats

    def ingest_github(self, url: str) -> Dict[str, Any]:
        """Crawl a GitHub repository (the `github` section) and ingest its
        files: code through the code chunker, markdown by section, other
        text by the splitter; the device lock is held for the ingest only."""
        from radiant_rag_tpu_torch.ingestion.code_chunker import CodeChunker, detect_language
        from radiant_rag_tpu_torch.ingestion.github_crawler import GitHubCrawler

        gh = self.config.github
        crawler = GitHubCrawler(token=gh.token, max_files=gh.max_files,
                                include_extensions=gh.include_extensions)
        files = crawler.crawl(url)
        code_chunker = CodeChunker()
        chunks: List[IngestedChunk] = []
        for f in files:
            lang = detect_language(f.path)
            if lang:
                for c in code_chunker.chunk_text(f.content, lang, source=f.path):
                    chunks.append(IngestedChunk(content=c.to_indexable_text(),
                                                meta={"source": f.url, **c.meta()}))
            elif f.path.lower().endswith((".md", ".markdown")):
                for j, piece in enumerate(self._chunk_markdown(f.content)):
                    chunks.append(IngestedChunk(content=piece,
                                                meta={"source": f.url, "chunk_index": j}))
            else:
                for j, piece in enumerate(self.processor.splitter.split(f.content)):
                    chunks.append(IngestedChunk(content=piece,
                                                meta={"source": f.url, "chunk_index": j}))
        with self.device_lock:
            stats = self._ingest_chunks(chunks, time.time())
        stats["files_fetched"] = len(files)
        return stats

    @staticmethod
    def _chunk_markdown(text: str, max_chars: int = 3000) -> List[str]:
        """Header-section + paragraph-merge markdown chunking."""
        sections = re.split(r"(?m)(?=^#{1,6}\s)", text)
        out: List[str] = []
        for section in sections:
            section = section.strip()
            if not section:
                continue
            if len(section) <= max_chars:
                if out and len(out[-1]) + len(section) < max_chars // 2:
                    out[-1] += "\n\n" + section
                else:
                    out.append(section)
            else:
                paras = section.split("\n\n")
                cur = ""
                for p in paras:
                    if len(cur) + len(p) + 2 > max_chars and cur:
                        out.append(cur)
                        cur = p
                    else:
                        cur = f"{cur}\n\n{p}" if cur else p
                if cur:
                    out.append(cur)
        return out

    # ------------------------------------------------------------------
    # querying
    # ------------------------------------------------------------------
    def query(self, question: str, conversation_id: str = "", use_cache: bool = True,
              progress: Optional[Any] = None) -> PipelineResult:
        """The full agentic query. A repeated question outside a
        conversation is served from the query cache. `progress(event,
        step_name, info)` observes the phase boundaries live."""
        if use_cache and not conversation_id:
            cached = self.query_cache.get("query", question)
            if cached is not None:
                return cached
        history = []
        if conversation_id and self.conversations is not None:
            history = self.conversations.get_history_for_synthesis(conversation_id)
        result = self.orchestrator.run(question, conversation_id=conversation_id,
                                       conversation_history=history, progress=progress)
        if use_cache and not conversation_id and result.success and not result.low_confidence:
            self.query_cache.put("query", question, result)
        return result

    def query_raw(self, question: str) -> Dict[str, Any]:
        return self.query(question).to_dict()

    def query_stream(self, question: str, conversation_id: str = ""):
        """A streaming query: yields progress events as the phases run, the
        answer's tokens, then the result (/query/stream). Events:
          {"event": "step_start" | "step_end", "step": str, ...info}
          {"event": "token", "text": str}
          {"event": "result", ...PipelineResult.to_dict(), "answer": str}
          {"event": "error", "error": str}  (the run raised; the last event)
        A cache hit yields the result alone."""
        cached = self.query_cache.get("query", question) if not conversation_id else None
        if cached is not None:
            yield {"event": "result", "cached": True, **cached.to_dict(),
                   "answer": cached.answer}
            return
        events: "queue.Queue" = queue.Queue()

        def progress(event, step, info):
            events.put({"event": event, "step": step, **info})

        history = []
        if conversation_id and self.conversations is not None:
            history = self.conversations.get_history_for_synthesis(conversation_id)

        def runner():
            try:
                result = self.orchestrator.run(
                    question, conversation_id=conversation_id, conversation_history=history,
                    progress=progress,
                    token_sink=lambda chunk: events.put({"event": "token", "text": chunk}))
                if not conversation_id and result.success and not result.low_confidence:
                    self.query_cache.put("query", question, result)
                events.put({"event": "result", **result.to_dict(), "answer": result.answer})
            except Exception as exc:  # the stream's last event
                events.put({"event": "error", "error": f"{type(exc).__name__}: {exc}"})
            finally:
                events.put(None)

        worker = threading.Thread(target=runner, daemon=True)
        worker.start()
        while True:
            item = events.get()
            if item is None:
                break
            yield item
        worker.join(timeout=5.0)

    def simple_query(self, question: str) -> str:
        """The minimal RAG path: retrieve, then one LLM call."""
        return self._simple.run(question)

    def start_conversation(self) -> str:
        if self.conversations is None:
            raise RuntimeError("conversations disabled in config")
        return self.conversations.start_conversation()

    def train(self, steps: int = 100, batch_size: int = 32, learning_rate: float = 2e-5,
              checkpoint_dir: str = "", hard_negatives: int = 2,
              auto: bool = False) -> Dict[str, Any]:
        """Fine-tune the embedder on the indexed corpus and make the result
        live. It trains on `create_mesh()`, every visible CUDA device on
        'data' (the batch rounded up to a multiple of them), or on the
        1 x 1 mesh of the device the app was built on by name: BM25-mined
        hard negatives from the app's index, warmup + cosine LR
        (`parallel/data.train_embedder`), a checkpoint in checkpoint_dir
        (default embedding.checkpoint_dir), which a fresh process
        restores, then the serving encoder's params
        swapped (its embedding cache cleared), the query cache cleared and
        the fusion calibration invalidated, all under the device lock.
        The stored corpus keeps the vectors of the old encoder until it is
        ingested again, as in the JAX package.

        auto=True is the measured recipe of the JAX package: a 12k-step
        ceiling with accuracy-plateau stopping (min 5000 steps, window
        2500, eps 0.005), batch >= 256, lr 1e-4, >= 2 hard negatives and
        `paraphrase_augment` on the queries."""
        from radiant_rag_tpu_torch.parallel.data import paraphrase_augment, train_embedder

        if auto:
            steps = max(steps, 12000)
            batch_size = max(batch_size, 256)
            learning_rate = 1e-4
            hard_negatives = max(hard_negatives, 2)
        metrics, params = train_embedder(
            self.store, self.config.embedding,
            device=self.device if self._named_device else None, steps=steps,
            batch_size=batch_size, learning_rate=learning_rate,
            checkpoint_dir=checkpoint_dir or self.config.embedding.checkpoint_dir,
            bm25=self.bm25_index.index if hard_negatives > 0 else None,
            hard_negatives=hard_negatives, return_params=True,
            query_augment=paraphrase_augment if auto else None, auto_stop=auto,
            device_lock=self.device_lock,
            **({"min_steps": 5000, "plateau_window": 2500, "plateau_eps": 0.005}
               if auto else {}))
        with self.device_lock:
            self.local_models.embedder.set_params(params)
            self.query_cache.clear()  # its results embedded with the old encoder
            self.orchestrator.invalidate_fusion_calibration()
        return metrics

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------
    def warmup(self, max_batch: int = 256, top_k: int = 10,
               modes: Sequence[str] = ("hybrid",), full_ladder: bool = False,
               progress=None) -> Dict[str, float]:
        """Run every serving bucket once before taking traffic: each query
        bucket the coalescer can round a batch up to (1, then 4 .. max_batch),
        in each mode, small ones first, so no live request pays a first
        call (the allocator's growth, library handles, host caches).
        full_ladder also runs both fusion variants of the fused searcher
        with device and host queries, and the ingest embed batch.
        max_batch <= 0 resolves to the hybrid gate's largest bucket.
        Returns seconds per stage."""
        if self.store.count_documents() == 0:
            return {}
        engine = getattr(self.store, "engine", None)
        if max_batch <= 0:
            searcher = self._fused_searcher()
            if searcher is not None:
                max_batch = searcher.max_query_bucket()
            else:
                max_batch = engine.max_query_bucket() if engine is not None else 256
        if engine is not None:
            buckets = [1] + [b for b in engine.QUERY_BUCKETS if 4 <= b <= max_batch]
        else:
            buckets = [b for b in (1, 32, max_batch) if b <= max(max_batch, 1)]
        timings: Dict[str, float] = {}

        def done(stage: str, t0: float) -> None:
            timings[stage] = round(time.time() - t0, 2)
            if progress is not None:
                progress(stage, timings[stage])

        probe = "warmup probe query"
        for mode in modes:
            for b in dict.fromkeys(buckets):  # dedup, keep order
                t0 = time.time()
                self.search_batch([probe] * b, mode=mode, top_k=top_k, use_cache=False)
                done(f"{mode}/b{b}", t0)
        if full_ladder and "hybrid" in modes:
            searcher = self._fused_searcher()
            if searcher is not None:
                import numpy as np

                e1 = np.asarray(self.local_models.embed([probe]), np.float32)
                dmode = self.store._default_mode()
                for b in dict.fromkeys(buckets):
                    texts = [probe] * b
                    embs = np.repeat(e1, b, axis=0)
                    qdev = embed_queries_device(self.local_models, searcher.engine, texts)
                    for fv in ("confidence", "score"):
                        t0 = time.time()
                        if qdev is not None:
                            searcher.search_rows(None, texts, dense_k=top_k, bm25_k=top_k,
                                                 fused_k=top_k, rrf_k=self.config.retrieval.rrf_k,
                                                 mode=dmode, fusion=fv, _qdev=qdev)
                        searcher.search_rows(embs, texts, dense_k=top_k, bm25_k=top_k,
                                             fused_k=top_k, rrf_k=self.config.retrieval.rrf_k,
                                             mode=dmode, fusion=fv)
                        done(f"hybrid/{fv}/b{b}", t0)
        emb = getattr(self.local_models, "embedder", None)
        if full_ladder and emb is not None and hasattr(emb, "_compute"):
            bs = self.config.embedding.batch_size
            t0 = time.time()
            emb._compute([f"{probe} {i}" for i in range(bs)])
            done(f"ingest_embed/b{bs}", t0)
        logger.info("warmup ran %s", timings)
        return timings

    def search(self, query: str, mode: str = "hybrid", top_k: int = 10,
               use_cache: bool = True) -> Hits:
        """Retrieval only."""
        if use_cache:
            cached = self.query_cache.get("search", query, mode=mode, top_k=top_k)
            if cached is not None:
                return list(cached)  # a copy: the cached list stays as it was
        hits = self._search_uncached(query, mode, top_k)
        if use_cache:
            self.query_cache.put("search", query, hits, mode=mode, top_k=top_k)
        return hits

    def _cache_scan(self, queries: List[str], mode: str, top_k: int,
                    use_cache: bool) -> Tuple[List[Any], List[int]]:
        """Pre-fill results from the query cache; returns (out, miss idxs)."""
        out: List[Any] = [None] * len(queries)
        if not use_cache:
            return out, list(range(len(queries)))
        miss: List[int] = []
        for i, q in enumerate(queries):
            cached = self.query_cache.get("search", q, mode=mode, top_k=top_k)
            if cached is not None:
                out[i] = list(cached)
            else:
                miss.append(i)
        return out, miss

    def _cache_fill(self, queries: List[str], out: List[Any], miss: List[int],
                    resolved: List[Any], mode: str, top_k: int, use_cache: bool) -> None:
        for j, i in enumerate(miss):
            out[i] = resolved[j]
            if use_cache:
                self.query_cache.put("search", queries[i], resolved[j], mode=mode, top_k=top_k)

    def search_batch(self, queries: List[str], mode: str = "hybrid", top_k: int = 10,
                     use_cache: bool = True) -> List[Hits]:
        """Batched retrieval: one device pass for the whole batch (the
        serving layer coalesces concurrent requests into this)."""
        out, miss = self._cache_scan(queries, mode, top_k, use_cache)
        if miss:
            res = self._search_uncached_batch([queries[i] for i in miss], mode, top_k)
            self._cache_fill(queries, out, miss, res, mode, top_k, use_cache)
        return out

    def _search_uncached(self, query: str, mode: str, top_k: int) -> Hits:
        return self._search_uncached_batch([query], mode, top_k)[0]

    def _attach_bm25(self) -> None:
        """A sharded pod store's base is built over the BM25 index, which
        exists only after the factory ran: hand it (again after a rebuild
        replaced it) to the store."""
        if hasattr(self.store, "attach_bm25"):
            self.store.attach_bm25(self.bm25_index.index)

    def _fused_searcher(self):
        """The fused hybrid searcher, refreshed for serving: the live BM25
        index and store engine, and calibrated when due (None when no
        engine backs the store, it is empty, or the searcher only
        calibrates a pod store)."""
        orch = self.orchestrator
        if orch._hybrid is None or not orch._hybrid_serves or \
                self.store.count_documents() == 0:
            return None
        return orch.refresh_fused_searcher()

    def _dispatch_fused(self, searcher, queries: List[str], top_k: int, fetch: bool = True):
        """Embed the batch on the device, padded to the engine's bucket, and
        hand it to the fused search without a host round trip."""
        embs = None
        qdev = embed_queries_device(self.local_models, searcher.engine, queries)
        if qdev is None:
            embs = self.local_models.embed(queries)
        return searcher.search_rows(
            embs, list(queries), dense_k=top_k, bm25_k=top_k, fused_k=top_k,
            rrf_k=self.config.retrieval.rrf_k, mode=self.store._default_mode(),
            rescore_multiplier=self.config.quantization.rescore_multiplier,
            fusion=self.config.retrieval.fusion_weighting, fetch=fetch, _qdev=qdev)

    def _resolve_fused_rows(self, res, n_queries: int) -> List[Hits]:
        return self.orchestrator.fused_runs(*res["fused"])[:n_queries]

    def search_batch_async(self, queries: List[str], mode: str = "hybrid", top_k: int = 10,
                           use_cache: bool = True):
        """Two-phase search_batch: queue the device work now and return a
        complete() that waits for and resolves the results, so the serving
        coalescer can dispatch the next batch meanwhile. Modes without a
        device seam complete synchronously."""
        searcher = self._fused_searcher() if mode == "hybrid" else None
        if searcher is None:
            res = self.search_batch(queries, mode=mode, top_k=top_k, use_cache=use_cache)
            return lambda: res
        out, miss = self._cache_scan(queries, mode, top_k, use_cache)
        if not miss:
            return lambda: out
        miss_q = [queries[i] for i in miss]
        _, unpack = self._dispatch_fused(searcher, miss_q, top_k, fetch=False)

        def complete() -> List[Hits]:
            resolved = self._resolve_fused_rows(unpack(), len(miss_q))
            self._cache_fill(queries, out, miss, resolved, mode, top_k, use_cache)
            return out

        complete.pipelined = True  # a real device seam (the coalescer's stats)
        return complete

    def _search_uncached_batch(self, queries: List[str], mode: str, top_k: int) -> List[Hits]:
        if mode == "dense":
            embs = self.local_models.embed(queries)
            return self.store.retrieve_by_embedding_batch(embs, top_k=top_k)
        if mode == "bm25":
            return self.bm25_index.search_batch(queries, top_k=top_k)
        # hybrid: the fused path where an engine backs the store, else
        # per-leg retrieval fused on the host
        searcher = self._fused_searcher()
        if searcher is not None:
            res = self._dispatch_fused(searcher, queries, top_k)
            return self._resolve_fused_rows(res, len(queries))
        if getattr(self.store, "can_hybrid", False):
            # the pod path: the calibration over the source engine installs
            # its mode and weights on the pod store first
            self.orchestrator.calibrate_pod_fusion()
            embs = self.local_models.embed(queries)
            return self.store.search_hybrid(
                embs, queries, top_k=top_k, fused_k=top_k, rrf_k=self.config.retrieval.rrf_k,
                fused_depth=resolve_fused_depth(self.config.retrieval))
        embs = self.local_models.embed(queries)
        dense = self.store.retrieve_by_embedding_batch(embs, top_k=top_k)
        sparse = self.bm25_index.search_batch(queries, top_k=top_k)
        return [self.orchestrator.fusion.fuse([dense[i], sparse[i]], top_k=top_k)
                for i in range(len(queries))]

    # ------------------------------------------------------------------
    # admin
    # ------------------------------------------------------------------
    def rebuild_bm25_index(self) -> int:
        n = self.bm25_index.build_from_store()
        self._attach_bm25()  # a pod store shards its base again
        return n

    def clear_index(self) -> None:
        self.store.drop_index()
        self.bm25_index.build_from_store()
        self._attach_bm25()
        self.bm25_index.save()
        self.query_cache.clear()
        # persist the cleared state: else the saved index resurrects every
        # cleared doc at the next start
        self._auto_persist("persisting the cleared index")

    def save_index(self, directory: str = "") -> None:
        d = directory or self.config.index.data_dir
        if hasattr(self.store, "save"):
            self.store.save(d)
        self.bm25_index.save()

    def check_health(self) -> Dict[str, Any]:
        """Each component's health; `ok` when the store, BM25 and the models
        answer (the LLM does not count, as in the JAX package). The models'
        embed takes the device lock; the LLM ping does not."""
        health = {"store": False, "bm25": False, "models": False, "llm": False}

        def models():
            with self.device_lock:
                return self.local_models.embed_single("health check").shape[0] > 0

        probes = {"store": self.store.ping,
                  "bm25": lambda: self.bm25_index.get_stats() is not None,
                  "models": models, "llm": self.llm.backend.ping}
        for name, probe in probes.items():
            try:  # a health check reports a failing component, it does not raise
                health[name] = bool(probe())
            except Exception:  # noqa: BLE001
                logger.exception("health check: %s failed", name)
        health["ok"] = all(v for k, v in health.items() if k != "llm")
        return health

    def get_stats(self) -> Dict[str, Any]:
        """Index, BM25, LLM, cache, run and agent statistics."""
        emb = getattr(self.local_models, "embedder", None)
        return {
            "index": self.store.get_index_info(),
            "bm25": self.bm25_index.get_stats(),
            "llm": self.llm.stats(),
            "caches": {"query": self.query_cache.stats(),
                       "embedding": emb.cache.stats() if emb is not None else {}},
            "runs": self.metrics_collector.summary(),
            "agents": self.orchestrator.get_agent_stats(),
        }


def create_app(config: Optional[AppConfig] = None, **kwargs: Any) -> RadiantTPU:
    return RadiantTPU(config=config, **kwargs)


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="radiant-tpu-torch", description="agentic RAG framework, PyTorch / CUDA port")
    parser.add_argument("--config", default="",
                        help="path to YAML config (default: the defaults and the "
                             "RADIANT_<SECTION>_<FIELD> environment overrides)")
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="command")

    p = sub.add_parser("ingest", help="ingest documents")
    p.add_argument("paths", nargs="+")
    p.add_argument("--no-recursive", action="store_true")

    p = sub.add_parser("ingest-urls", help="crawl and ingest web pages")
    p.add_argument("urls", nargs="+")

    p = sub.add_parser("ingest-github", help="ingest a GitHub repository")
    p.add_argument("url")

    p = sub.add_parser("query", help="run the full agentic pipeline")
    p.add_argument("question")
    p.add_argument("--conversation", default="")
    p.add_argument("--report", default="", help="save report to file (.md/.html/.json/.txt)")

    p = sub.add_parser("search", help="retrieval only")
    p.add_argument("query")
    p.add_argument("--mode", choices=["hybrid", "dense", "bm25"], default="hybrid")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--save", default="", help="save a search report to file")

    p = sub.add_parser("simple-query", help="minimal RAG (no agents)")
    p.add_argument("question")

    p = sub.add_parser("train", help="fine-tune the embedder on the indexed corpus "
                       "(every visible card on the data axis)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--checkpoint-dir", default="",
                   help="output directory (default: embedding.checkpoint_dir)")
    p.add_argument("--hard-negatives", type=int, default=2, metavar="H",
                   help="BM25-mined hard negatives per query (0 disables)")
    p.add_argument("--auto", action="store_true",
                   help="the measured recipe: 12k-step ceiling with accuracy-plateau "
                        "stopping, hard negatives, paraphrase query augmentation")

    p = sub.add_parser("serve", help="HTTP JSON API server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--warmup", type=int, default=-1, metavar="MAX_BATCH",
                   help="run the search buckets up to this batch size before serving "
                        "(default: server.max_batch; 0 disables)")

    p = sub.add_parser("warmup", help="run every serving bucket once")
    p.add_argument("--max-batch", type=int, default=0,
                   help="top bucket (default: the hybrid gate's largest for the corpus)")
    p.add_argument("--modes", default="hybrid", help="comma-separated search modes")

    sub.add_parser("interactive", help="interactive query loop")
    sub.add_parser("stats", help="index and pipeline statistics")
    sub.add_parser("health", help="component health check")
    sub.add_parser("clear", help="drop the index")
    sub.add_parser("rebuild-bm25", help="rebuild the BM25 index from the store")
    sub.add_parser("tui", help="terminal UI")
    return parser


def _print_json(obj: Any) -> None:
    print(json.dumps(obj, indent=2, default=str))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.command:
        build_parser().print_help()
        return 1
    config = load_config(args.config) if args.config else config_from_dict({})
    setup_logging("DEBUG" if args.verbose else config.logging.level,
                  file=config.logging.file, color=config.logging.color)
    app = create_app(config)
    from radiant_rag_tpu_torch.ui.display import display_answer, display_search_results

    if args.command == "ingest":
        _print_json(app.ingest_documents(args.paths, recursive=not args.no_recursive))
    elif args.command == "ingest-urls":
        _print_json(app.ingest_urls(args.urls))
    elif args.command == "ingest-github":
        _print_json(app.ingest_github(args.url))
    elif args.command == "search":
        hits = app.search(args.query, mode=args.mode, top_k=args.top_k)
        display_search_results(args.query, hits)
        if args.save:
            from radiant_rag_tpu_torch.ui.reports import save_search_report

            save_search_report(args.query, hits, args.save)
            print(f"search report saved to {args.save}")
    elif args.command == "query":
        result = app.query(args.question, conversation_id=args.conversation)
        display_answer(result)
        if args.report:
            from radiant_rag_tpu_torch.ui.reports import QueryReport

            QueryReport.from_pipeline_result(result).save(args.report)
            print(f"report saved to {args.report}")
    elif args.command == "simple-query":
        print(app.simple_query(args.question))
    elif args.command == "interactive":
        print("radiant-tpu-torch interactive mode: an empty line exits")
        cid = app.start_conversation() if app.conversations is not None else ""
        while True:
            try:
                question = input("query> ").strip()
            except (EOFError, KeyboardInterrupt):
                break
            if not question:
                break
            display_answer(app.query(question, conversation_id=cid))
    elif args.command == "serve":
        from radiant_rag_tpu_torch.server import serve

        warm_to = config.server.max_batch if args.warmup < 0 else args.warmup
        if warm_to > 0 and app.store.count_documents() > 0:
            print(f"warming search buckets up to batch {warm_to}...", flush=True)
            print(app.warmup(max_batch=warm_to), flush=True)
        serve(app, host=args.host, port=args.port)
    elif args.command == "warmup":
        n = app.store.count_documents()
        if n == 0:
            print("nothing to warm: index is empty")
            return 1
        print(f"running the serving bucket ladder over {n} docs...", flush=True)
        timings = app.warmup(
            max_batch=args.max_batch, full_ladder=True,
            modes=[m.strip() for m in args.modes.split(",") if m.strip()],
            progress=lambda stage, s: print(f"  {stage}: {s:.1f}s", flush=True))
        print(f"done: {len(timings)} stages in {sum(timings.values()):.1f}s")
    elif args.command == "train":
        metrics = app.train(steps=args.steps, batch_size=args.batch_size, learning_rate=args.lr,
                            checkpoint_dir=args.checkpoint_dir,
                            hard_negatives=args.hard_negatives, auto=args.auto)
        print(json.dumps(metrics))
    elif args.command == "stats":
        _print_json(app.get_stats())
    elif args.command == "health":
        health = app.check_health()
        _print_json(health)
        return 0 if health["ok"] else 2
    elif args.command == "clear":
        app.clear_index()
        print("index cleared")
    elif args.command == "rebuild-bm25":
        print(f"BM25 index rebuilt: {app.rebuild_bm25_index()} docs")
    elif args.command == "tui":
        from radiant_rag_tpu_torch.ui.tui import run_tui

        run_tui(app)
    return 0


if __name__ == "__main__":
    sys.exit(main())
