"""True-LRU embedding cache.

The port's own copy of `EmbeddingCache` from `radiant_rag_tpu/utils/cache.py`:
SHA-256-keyed text -> embedding LRU with batch get/put and hit-rate stats,
behind an explicit lock. `QueryCache` comes with the host layers (ROADMAP
queue A item 11).
"""

from __future__ import annotations

import hashlib
import threading
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
