"""True-LRU embedding cache and TTL query cache.

The port's own copies of `EmbeddingCache` and `QueryCache` from
`radiant_rag_tpu/utils/cache.py`: a SHA-256-keyed text -> embedding LRU with
batch get/put and hit-rate stats, and an LRU of query-level results with a
time to live, keyed on (operation, query, sorted kwargs); both behind an
explicit lock.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class EmbeddingCache:
    """LRU text -> embedding cache keyed by SHA-256 of the text."""

    def __init__(self, max_size: int = 10000) -> None:
        self.max_size = max_size
        self._data: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(text: str) -> str:
        return hashlib.sha256(text.encode("utf-8", errors="replace")).hexdigest()

    def get(self, text: str) -> Optional[np.ndarray]:
        k = self._key(text)
        with self._lock:
            if k in self._data:
                self._data.move_to_end(k)
                self.hits += 1
                return self._data[k]
            self.misses += 1
            return None

    def put(self, text: str, embedding: np.ndarray) -> None:
        k = self._key(text)
        with self._lock:
            self._data[k] = np.asarray(embedding)
            self._data.move_to_end(k)
            while len(self._data) > self.max_size:
                self._data.popitem(last=False)

    def get_batch(self, texts: Sequence[str]) -> Tuple[Dict[int, np.ndarray], List[int]]:
        """Return ({index: cached embedding}, [missing indices])."""
        found: Dict[int, np.ndarray] = {}
        missing: List[int] = []
        for i, t in enumerate(texts):
            e = self.get(t)
            if e is None:
                missing.append(i)
            else:
                found[i] = e
        return found, missing

    def put_batch(self, texts: Sequence[str], embeddings: np.ndarray) -> None:
        for t, e in zip(texts, embeddings):
            self.put(t, e)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {
            "size": len(self._data),
            "max_size": self.max_size,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
        }

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


class QueryCache:
    """LRU cache of query-level results with TTL, keyed on
    (operation, query, sorted kwargs)."""

    def __init__(self, max_size: int = 1000, ttl_s: float = 3600.0) -> None:
        self.max_size = max_size
        self.ttl_s = ttl_s
        self._data: "OrderedDict[str, Tuple[float, Any]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(operation: str, query: str, **kwargs: Any) -> str:
        payload = json.dumps([operation, query, sorted(kwargs.items())], default=str)
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()

    def get(self, operation: str, query: str, **kwargs: Any) -> Optional[Any]:
        k = self._key(operation, query, **kwargs)
        with self._lock:
            item = self._data.get(k)
            if item is None:
                self.misses += 1
                return None
            ts, value = item
            if time.time() - ts > self.ttl_s:
                del self._data[k]
                self.misses += 1
                return None
            self._data.move_to_end(k)
            self.hits += 1
            return value

    def put(self, operation: str, query: str, value: Any, **kwargs: Any) -> None:
        k = self._key(operation, query, **kwargs)
        with self._lock:
            self._data[k] = (time.time(), value)
            self._data.move_to_end(k)
            while len(self._data) > self.max_size:
                self._data.popitem(last=False)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {
            "size": len(self._data),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
        }

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
