"""Intelligent chunking: document-type detection and LLM split points with
rule-based fallbacks.

The port's copy of `radiant_rag_tpu/agents/chunking.py`: regex detection of
code / markdown / prose, LLM-proposed split offsets for documents past
`llm_threshold` characters (kept only when the chunks cover 90% of the
text), and the rule-based split otherwise (prose by sentence, markdown by
header, code by def / class). `IntelligentDocumentProcessor`
(`ingestion/processor.py`) routes sections through it. A library class, as
in the JAX package: `ingestion.use_intelligent_chunking` is read by neither
package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, List, Optional

_CODE_RX = re.compile(r"^\s*(def |class |import |function |#include|public |private )", re.M)
_MD_RX = re.compile(r"^#{1,6}\s+\S", re.M)
_SENTENCE_RX = re.compile(r"(?<=[.!?])\s+")


@dataclass
class Chunk:
    content: str
    index: int
    doc_type: str


class IntelligentChunkingAgent:
    def __init__(self, llm=None, target_chunk_size: int = 1500,
                 llm_threshold: int = 3000, max_chunk_size: int = 4000) -> None:
        self.llm = llm
        self.target_chunk_size = target_chunk_size
        self.llm_threshold = llm_threshold
        self.max_chunk_size = max_chunk_size

    # -- type detection ----------------------------------------------------
    @staticmethod
    def detect_doc_type(text: str) -> str:
        """code | markdown | prose (reference `chunking.py:57-71,166-175`)."""
        lines = text.splitlines() or [""]
        code_hits = len(_CODE_RX.findall(text))
        if code_hits >= max(2, len(lines) // 20):
            return "code"
        if len(_MD_RX.findall(text)) >= 2:
            return "markdown"
        return "prose"

    # -- chunking ----------------------------------------------------------
    def chunk(self, text: str) -> List[Chunk]:
        doc_type = self.detect_doc_type(text)
        if self.llm is not None and len(text) > self.llm_threshold:
            chunks = self._llm_chunk(text, doc_type)
            if chunks and self.validate_coverage(text, chunks):
                return chunks
        return self._rule_chunk(text, doc_type)

    def _llm_chunk(self, text: str, doc_type: str) -> Optional[List[Chunk]]:
        """LLM proposes semantic split points as character offsets
        (reference `chunking.py:176-305`)."""
        try:
            arr = self.llm.chat_json([{
                "role": "user",
                "content": (
                    "Propose character offsets at which to split this document "
                    "into semantically coherent chunks of roughly "
                    f"{self.target_chunk_size} characters. Return ONLY a JSON "
                    "array of integers (ascending offsets, excluding 0 and the "
                    f"end).\n\nDocument ({len(text)} chars):\n{text[:12000]}"
                ),
            }], expect=list)
        except Exception:
            return None
        if not arr:
            return None
        offsets = sorted({int(o) for o in arr if isinstance(o, (int, float))
                          and 0 < int(o) < len(text)})
        if not offsets:
            return None
        bounds = [0] + offsets + [len(text)]
        chunks = []
        for i in range(len(bounds) - 1):
            piece = text[bounds[i] : bounds[i + 1]].strip()
            if piece:
                chunks.append(Chunk(content=piece, index=len(chunks), doc_type=doc_type))
        return chunks

    def _rule_chunk(self, text: str, doc_type: str) -> List[Chunk]:
        """Structure-aware fallback (reference `chunking.py:306-520`)."""
        if doc_type == "markdown":
            pieces = self._split_markdown(text)
        elif doc_type == "code":
            pieces = self._split_code(text)
        else:
            pieces = self._split_prose(text)
        return [Chunk(content=p, index=i, doc_type=doc_type)
                for i, p in enumerate(pieces) if p.strip()]

    def _split_prose(self, text: str) -> List[str]:
        sentences = _SENTENCE_RX.split(text)
        out, cur = [], ""
        for s in sentences:
            if len(cur) + len(s) + 1 > self.target_chunk_size and cur:
                out.append(cur)
                cur = s
            else:
                cur = f"{cur} {s}".strip()
            while len(cur) > self.max_chunk_size:
                out.append(cur[: self.max_chunk_size])
                cur = cur[self.max_chunk_size :]
        if cur:
            out.append(cur)
        return out

    def _split_markdown(self, text: str) -> List[str]:
        parts = re.split(r"(?m)(?=^#{1,6}\s)", text)
        out: List[str] = []
        for part in parts:
            if not part.strip():
                continue
            if len(part) > self.max_chunk_size:
                out.extend(self._split_prose(part))
            else:
                out.append(part.strip())
        # merge tiny neighbors
        merged: List[str] = []
        for p in out:
            if merged and len(merged[-1]) + len(p) < self.target_chunk_size // 2:
                merged[-1] = merged[-1] + "\n\n" + p
            else:
                merged.append(p)
        return merged

    def _split_code(self, text: str) -> List[str]:
        parts = re.split(r"(?m)(?=^(?:def |class |function ))", text)
        out: List[str] = []
        cur = ""
        for part in parts:
            if len(cur) + len(part) > self.target_chunk_size and cur:
                out.append(cur)
                cur = part
            else:
                cur += part
        if cur.strip():
            out.append(cur)
        return out

    # -- validation --------------------------------------------------------
    @staticmethod
    def validate_coverage(text: str, chunks: List[Chunk], min_ratio: float = 0.9) -> bool:
        """Chunked content must cover most of the source (reference
        `chunking.py:541-`)."""
        covered = sum(len(c.content) for c in chunks)
        return covered >= min_ratio * len(text.strip())
