"""GitHub repository crawler.

The port's copy of `radiant_rag_tpu/ingestion/github_crawler.py`: GitHub
URL detection and parsing (a repository, a tree or a blob), the repository's
file list from the git trees API (token support, an extension filter and a
`max_files` cap), and raw-content fetching. It fetches with `urllib`
through an injectable `fetcher(url) -> bytes`; the class attributes `API`
and `RAW` name the two hosts. Host work only.
"""

from __future__ import annotations

import json
import logging
import re
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_GH_URL_RX = re.compile(
    r"https?://github\.com/(?P<owner>[\w.\-]+)/(?P<repo>[\w.\-]+)"
    r"(?:/(?:tree|blob)/(?P<ref>[\w.\-/]+?))?/?$"
)
_GH_FILE_RX = re.compile(
    r"https?://github\.com/(?P<owner>[\w.\-]+)/(?P<repo>[\w.\-]+)"
    r"/blob/(?P<ref>[\w.\-]+)/(?P<path>.+)$"
)


def is_github_url(url: str) -> bool:
    return bool(_GH_URL_RX.match(url) or _GH_FILE_RX.match(url))


def parse_github_url(url: str) -> Optional[Dict[str, str]]:
    m = _GH_FILE_RX.match(url)
    if m:
        return {**m.groupdict(), "kind": "file"}
    m = _GH_URL_RX.match(url)
    if m:
        d = m.groupdict()
        return {"owner": d["owner"], "repo": d["repo"],
                "ref": d.get("ref") or "", "path": "", "kind": "repo"}
    return None


@dataclass
class GitHubFile:
    path: str
    content: str
    url: str


class GitHubCrawler:
    API = "https://api.github.com"
    RAW = "https://raw.githubusercontent.com"

    def __init__(self, token: str = "", max_files: int = 200,
                 include_extensions: Tuple[str, ...] = (".md", ".py", ".txt", ".rst"),
                 timeout_s: float = 20.0, fetcher=None) -> None:
        self.token = token
        self.max_files = max_files
        self.include_extensions = tuple(include_extensions)
        self.timeout_s = timeout_s
        self._fetcher = fetcher  # injectable: url -> bytes

    def _get(self, url: str) -> bytes:
        if self._fetcher is not None:
            return self._fetcher(url)
        headers = {"User-Agent": "radiant-tpu-crawler/0.1"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read(10 * 1024 * 1024)

    def _default_ref(self, owner: str, repo: str) -> str:
        try:
            info = json.loads(self._get(f"{self.API}/repos/{owner}/{repo}"))
            return info.get("default_branch", "main")
        except Exception:
            return "main"

    def list_tree(self, owner: str, repo: str, ref: str) -> List[str]:
        """Repo file listing via the git trees API (reference `:368-477`)."""
        data = json.loads(self._get(
            f"{self.API}/repos/{owner}/{repo}/git/trees/{ref}?recursive=1"))
        paths = [item["path"] for item in data.get("tree", [])
                 if item.get("type") == "blob"]
        wanted = [p for p in paths
                  if any(p.lower().endswith(e) for e in self.include_extensions)]
        return wanted[: self.max_files]

    def fetch_file(self, owner: str, repo: str, ref: str, path: str) -> Optional[GitHubFile]:
        url = f"{self.RAW}/{owner}/{repo}/{ref}/{path}"
        try:
            content = self._get(url).decode("utf-8", errors="replace")
            return GitHubFile(path=path, content=content, url=url)
        except Exception as exc:
            logger.warning("github fetch failed %s: %s", url, exc)
            return None

    def crawl(self, url: str) -> List[GitHubFile]:
        parsed = parse_github_url(url)
        if parsed is None:
            logger.warning("not a GitHub URL: %s", url)
            return []
        owner, repo = parsed["owner"], parsed["repo"]
        ref = parsed["ref"] or self._default_ref(owner, repo)
        if parsed["kind"] == "file":
            f = self.fetch_file(owner, repo, ref, parsed["path"])
            return [f] if f else []
        try:
            paths = self.list_tree(owner, repo, ref)
        except Exception as exc:
            logger.warning("github tree listing failed: %s", exc)
            return []
        out = []
        for path in paths:
            f = self.fetch_file(owner, repo, ref, path)
            if f is not None:
                out.append(f)
        return out
