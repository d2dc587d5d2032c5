"""Web search agent: LLM-suggested URLs fetched with the crawler.

The port's copy of `radiant_rag_tpu/agents/web_search.py`: it triggers on
the plan's `use_web_search` flag or a keyword of the query; the LLM
suggests up to `max_urls` URLs (no search-engine API), blocked domains are
dropped, the pages are fetched with the web crawler
(`ingestion/web_crawler.py`) and wrapped as `StoredDoc`s scored 0.9, 0.75,
... (at least 0.1); results are cached per query for `cache_ttl_s`. The
orchestrator fuses them into the retrieval (or serves them alone when the
retrieval found nothing). Host work and LLM calls only: a fetch that fails
is logged and skipped, an LLM failure degrades to no web docs.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from radiant_rag_tpu_torch.agents.base import AgentContext, DocScore
from radiant_rag_tpu_torch.agents.base_agent import AgentCategory, LLMAgent
from radiant_rag_tpu_torch.index.doc import StoredDoc


class WebSearchAgent(LLMAgent):
    name = "web_search"
    category = AgentCategory.RETRIEVAL

    def __init__(self, llm, crawler=None, max_urls: int = 3,
                 cache_ttl_s: float = 3600.0,
                 blocked_domains: Tuple[str, ...] = (),
                 trigger_keywords: Tuple[str, ...] = ("latest", "news", "today", "current", "recent"),
                 enabled: bool = True) -> None:
        super().__init__(llm, enabled=enabled)
        self.crawler = crawler
        self.max_urls = max_urls
        self.cache_ttl_s = cache_ttl_s
        self.blocked_domains = tuple(d.lower() for d in blocked_domains)
        self.trigger_keywords = trigger_keywords
        self._cache: Dict[str, Tuple[float, List[DocScore]]] = {}

    def should_trigger(self, ctx: AgentContext) -> bool:
        """Plan flag or keyword trigger (reference `web_search.py:68-80`)."""
        if ctx.plan.get("use_web_search"):
            return True
        q = ctx.query.lower()
        return any(kw in q for kw in self.trigger_keywords)

    def is_blocked(self, url: str) -> bool:
        host = (urlparse(url).hostname or "").lower()
        return any(host == d or host.endswith("." + d) for d in self.blocked_domains)

    def suggest_urls(self, query: str) -> List[str]:
        """Direct mode: LLM proposes likely URLs (reference `:82-150`)."""
        arr = self._chat_json([{
            "role": "user",
            "content": (
                f"Suggest up to {self.max_urls} specific public web page URLs "
                "likely to answer this query (documentation, wikis, official "
                "pages). Return ONLY a JSON array of URL strings.\n\n"
                f"Query: {query}"
            ),
        }], expect=list)
        urls = []
        for u in arr or []:
            u = str(u).strip()
            if u.startswith(("http://", "https://")) and not self.is_blocked(u):
                urls.append(u)
        return urls[: self.max_urls]

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> List[DocScore]:
        if not kwargs.get("force") and not self.should_trigger(ctx):
            ctx.web_docs = []
            return []
        cached = self._cache.get(ctx.query)
        if cached and time.time() - cached[0] < self.cache_ttl_s:
            ctx.web_docs = cached[1]
            return cached[1]
        if self.crawler is None:
            ctx.add_warning("web search unavailable: no crawler configured")
            ctx.web_docs = []
            return []
        urls = self.suggest_urls(ctx.query)
        docs: List[DocScore] = []
        score = 0.9  # descending scores (reference `:152-280`)
        for url in urls:
            try:
                result = self.crawler.crawl_single(url)
            except Exception as exc:
                self.log.warning("fetch failed for %s: %s", url, exc)
                continue
            if not result or not result.get("text"):
                continue
            doc = StoredDoc(
                doc_id=f"web:{url}",
                content=result["text"][:20000],
                meta={"source": url, "doc_level": "leaf", "web": True,
                      "title": result.get("title", "")},
            )
            docs.append((doc, score))
            score = max(0.1, score - 0.15)
        self._cache[ctx.query] = (time.time(), docs)
        ctx.web_docs = docs
        return docs

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> List[DocScore]:
        ctx.web_docs = []
        return []
