"""Stable 32-bit term hashing (FNV-1a).

The port's own copy of `radiant_rag_tpu/utils/hashing.stable_hash32`: the
BM25 sketch's term bins and signs depend on it bit for bit.
"""

from __future__ import annotations


def stable_hash32(text: str, seed: int = 0) -> int:
    """Fast stable 32-bit hash (FNV-1a) for token -> bucket mapping."""
    h = (0x811C9DC5 ^ seed) & 0xFFFFFFFF
    for b in text.encode("utf-8", errors="replace"):
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h
