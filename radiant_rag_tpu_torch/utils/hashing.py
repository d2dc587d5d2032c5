"""Content-hash doc ids and stable 32-bit term hashing (FNV-1a).

The port's own copy of `radiant_rag_tpu/utils/hashing.py`: doc ids must be
byte-identical (a store saved by either package is loaded by the other),
and the BM25 sketch's term bins and signs depend on `stable_hash32` bit for
bit.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional

_ID_META_KEYS = ("source", "doc_level", "parent_id", "chunk_index")


def make_doc_id(content: str, meta: Optional[Dict[str, Any]] = None) -> str:
    """Deterministic SHA-256 doc id from content + stable meta subset."""
    h = hashlib.sha256()
    h.update(content.encode("utf-8", errors="replace"))
    if meta:
        stable = {k: meta[k] for k in _ID_META_KEYS if k in meta and meta[k] is not None}
        if stable:
            h.update(json.dumps(stable, sort_keys=True, default=str).encode("utf-8"))
    return h.hexdigest()


def stable_hash32(text: str, seed: int = 0) -> int:
    """Fast stable 32-bit hash (FNV-1a) for token -> bucket mapping."""
    h = (0x811C9DC5 ^ seed) & 0xFFFFFFFF
    for b in text.encode("utf-8", errors="replace"):
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h
