"""Tokenisation as the configuration states it, written out plainly.

  hash tokenizer   lowercase, runs of [a-z0-9] or single other non-space
                   characters, each word -> reserved + FNV-1a(word) % span
                   (span = vocab - reserved, reserved = min(999, max(103,
                   vocab // 4))); [CLS] = 101, [SEP] = 102, [PAD] = 0
  BM25 analyser    lowercase runs of [a-z0-9] longer than one character
  sketch hashing   bin = FNV-1a(term) % S, sign = +1 if FNV-1a("s!" + term)
                   is odd else -1
"""

from __future__ import annotations

import re
from typing import List, Sequence

CLS_ID, SEP_ID, PAD_ID = 101, 102, 0
_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.I)
_TERM_RE = re.compile(r"[a-z0-9]+")


def fnv1a32(text: str) -> int:
    h = 0x811C9DC5
    for byte in text.encode("utf-8", errors="replace"):
        h ^= byte
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def hash_ids(text: str, vocab_size: int) -> List[int]:
    reserved = min(999, max(103, vocab_size // 4))
    span = vocab_size - reserved
    return [reserved + fnv1a32(w) % span for w in _WORD_RE.findall(text.lower())]


def bm25_terms(text: str) -> List[str]:
    return [t for t in _TERM_RE.findall(text.lower()) if len(t) > 1]


def single_token_words(words: Sequence[str]) -> bool:
    """True when each vocabulary word is exactly one term of the BM25
    analyser and one word of the hash tokenizer, so a text of these words
    joined by spaces tokenises to its words."""
    return all(bm25_terms(w) == [w.lower()] and len(_WORD_RE.findall(w)) == 1 for w in words)


def sketch_bin(term: str, dim: int) -> int:
    return fnv1a32(term) % dim


def sketch_sign(term: str) -> int:
    return 1 if fnv1a32("s!" + term) & 1 else -1
