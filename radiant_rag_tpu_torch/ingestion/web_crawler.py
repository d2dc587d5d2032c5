"""Web crawler: breadth-first to depth and page limits, URL normalization
and filtering.

The port's copy of `radiant_rag_tpu/ingestion/web_crawler.py`: a BFS crawl
to `max_depth` / `max_pages`, same-domain and include / exclude regex
filters, URL normalization (relative links resolved, fragment dropped, host
lower-cased, default port dropped), a rate-limit delay between fetches, and
`crawl_single` (the web-search agent's fetch). It fetches with `urllib`
through an injectable `fetcher(url) -> (html, content_type)`, and strips
pages with the processor's `html_to_text`. Host work only.
"""

from __future__ import annotations

import logging
import re
import time
import urllib.error
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple
from urllib.parse import urljoin, urlparse, urlunparse

from radiant_rag_tpu_torch.ingestion.processor import html_to_text

logger = logging.getLogger(__name__)

_LINK_RX = re.compile(r"""<a[^>]+href=["']([^"']+)["']""", re.I)
_DEFAULT_PORTS = {"http": 80, "https": 443}
USER_AGENT = "radiant-tpu-crawler/0.1"


def normalize_url(url: str, base: str = "") -> Optional[str]:
    """Resolve relative, strip fragments, lowercase host, drop default ports
    (reference `web_crawler.py:121-173`)."""
    if base:
        url = urljoin(base, url)
    try:
        p = urlparse(url)
    except ValueError:
        return None
    if p.scheme not in ("http", "https"):
        return None
    host = (p.hostname or "").lower()
    if not host:
        return None
    port = p.port
    netloc = host if port is None or port == _DEFAULT_PORTS.get(p.scheme) else f"{host}:{port}"
    path = p.path or "/"
    return urlunparse((p.scheme, netloc, path, p.params, p.query, ""))


def extract_links(html: str, base_url: str) -> List[str]:
    out = []
    for href in _LINK_RX.findall(html):
        norm = normalize_url(href.strip(), base=base_url)
        if norm:
            out.append(norm)
    return out


@dataclass
class CrawlResult:
    url: str
    title: str = ""
    text: str = ""
    depth: int = 0
    links: List[str] = field(default_factory=list)
    error: str = ""

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def __getitem__(self, key: str):
        return getattr(self, key)


class WebCrawler:
    def __init__(
        self,
        max_depth: int = 2,
        max_pages: int = 50,
        same_domain_only: bool = True,
        rate_limit_delay_s: float = 0.5,
        timeout_s: float = 20.0,
        include_patterns: Tuple[str, ...] = (),
        exclude_patterns: Tuple[str, ...] = (),
        fetcher=None,  # injectable for tests (url -> (html, content_type))
    ) -> None:
        self.max_depth = max_depth
        self.max_pages = max_pages
        self.same_domain_only = same_domain_only
        self.rate_limit_delay_s = rate_limit_delay_s
        self.timeout_s = timeout_s
        self.include = [re.compile(p) for p in include_patterns]
        self.exclude = [re.compile(p) for p in exclude_patterns]
        self._fetcher = fetcher
        self._last_fetch = 0.0

    # -- fetching ----------------------------------------------------------
    def _fetch(self, url: str) -> Tuple[str, str]:
        if self._fetcher is not None:
            return self._fetcher(url)
        wait = self.rate_limit_delay_s - (time.time() - self._last_fetch)
        if wait > 0:
            time.sleep(wait)
        self._last_fetch = time.time()
        req = urllib.request.Request(url, headers={"User-Agent": USER_AGENT})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            ctype = resp.headers.get("Content-Type", "")
            body = resp.read(5 * 1024 * 1024)
        return body.decode("utf-8", errors="replace"), ctype

    def _allowed(self, url: str, root_host: str) -> bool:
        host = (urlparse(url).hostname or "").lower()
        if self.same_domain_only and host != root_host:
            return False
        if self.include and not any(rx.search(url) for rx in self.include):
            return False
        if any(rx.search(url) for rx in self.exclude):
            return False
        return True

    # -- entry points ------------------------------------------------------
    def crawl_single(self, url: str) -> Optional[CrawlResult]:
        norm = normalize_url(url)
        if norm is None:
            return None
        try:
            html, ctype = self._fetch(norm)
        except Exception as exc:
            logger.warning("fetch failed %s: %s", norm, exc)
            return CrawlResult(url=norm, error=str(exc))
        if "html" in ctype or html.lstrip()[:1] == "<":
            text, title = html_to_text(html)
            links = extract_links(html, norm)
        else:
            text, title, links = html, "", []
        return CrawlResult(url=norm, title=title, text=text, links=links)

    def crawl(self, start_url: str) -> List[CrawlResult]:
        """BFS crawl (reference `web_crawler.py:215-603`)."""
        start = normalize_url(start_url)
        if start is None:
            return []
        root_host = (urlparse(start).hostname or "").lower()
        seen: Set[str] = {start}
        queue: deque = deque([(start, 0)])
        results: List[CrawlResult] = []
        while queue and len(results) < self.max_pages:
            url, depth = queue.popleft()
            result = self.crawl_single(url)
            if result is None:
                continue
            result.depth = depth
            if not result.error and result.text:
                results.append(result)
            if depth < self.max_depth:
                for link in result.links:
                    if link not in seen and self._allowed(link, root_host):
                        seen.add(link)
                        queue.append((link, depth + 1))
        return results
