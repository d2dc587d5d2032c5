"""Citation tracking: match answer claims to source docs, insert markers,
build bibliography + audit log.

Capability parity with reference `agents/citation.py:175-774` (plain class):
`SourceDocument` extraction with citation keys, LLM claim->source matching
with a regex fallback, five citation styles (INLINE/FOOTNOTE/ACADEMIC/
HYPERLINK/ENTERPRISE), `CitedAnswer` with bibliography and an audit id.

The port's copy of `radiant_rag_tpu/agents/citation.py`, unchanged.
"""

from __future__ import annotations

import enum
import logging
import re
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from radiant_rag_tpu_torch.agents.base import DocScore

logger = logging.getLogger(__name__)


class CitationStyle(enum.Enum):
    INLINE = "inline"  # [1]
    FOOTNOTE = "footnote"  # [^1]
    ACADEMIC = "academic"  # (Author, source)
    HYPERLINK = "hyperlink"  # [1](url)
    ENTERPRISE = "enterprise"  # [DOC-1]


@dataclass
class SourceDocument:
    key: str  # "1", "2", ...
    doc_id: str
    source: str
    snippet: str


@dataclass
class CitationMatch:
    claim: str
    source_keys: List[str]
    confidence: float


@dataclass
class CitedAnswer:
    text: str
    sources: List[SourceDocument] = field(default_factory=list)
    matches: List[CitationMatch] = field(default_factory=list)
    bibliography: str = ""
    audit_id: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "audit_id": self.audit_id,
            "num_sources": len(self.sources),
            "num_matches": len(self.matches),
            "bibliography": self.bibliography,
        }


class CitationTrackingAgent:
    def __init__(self, llm, style: str = "inline", min_confidence: float = 0.3,
                 include_bibliography: bool = True) -> None:
        self.llm = llm
        self.style = CitationStyle(style)
        self.min_confidence = min_confidence
        self.include_bibliography = include_bibliography

    # -- sources -----------------------------------------------------------
    def extract_sources(self, docs: List[DocScore]) -> List[SourceDocument]:
        out = []
        for i, (doc, _score) in enumerate(docs, start=1):
            out.append(SourceDocument(
                key=str(i), doc_id=doc.doc_id,
                source=doc.source or f"document {i}",
                snippet=doc.content[:300],
            ))
        return out

    # -- matching ----------------------------------------------------------
    def match_claims(self, answer: str, sources: List[SourceDocument]) -> List[CitationMatch]:
        """LLM sentence->source matching with regex fallback
        (reference `citation.py:328-505`)."""
        sentences = [s.strip() for s in re.split(r"(?<=[.!?])\s+", answer) if len(s.strip()) > 20]
        if not sentences or not sources:
            return []
        listing = "\n".join(f"[{s.key}] ({s.source}) {s.snippet[:200]}" for s in sources)
        numbered = "\n".join(f"{i+1}. {s}" for i, s in enumerate(sentences))
        arr = self.llm.chat_json([{
            "role": "user",
            "content": (
                "Match each answer sentence to the source document(s) that support "
                "it. Return a JSON array (same order as sentences) of objects "
                '{"sources": [keys as strings], "confidence": float 0-1}. Use an '
                "empty sources list when nothing supports the sentence.\n\n"
                f"Sources:\n{listing}\n\nSentences:\n{numbered}"
            ),
        }], expect=list)
        matches: List[CitationMatch] = []
        if arr and len(arr) == len(sentences):
            valid_keys = {s.key for s in sources}
            for sent, item in zip(sentences, arr):
                if not isinstance(item, dict):
                    continue
                keys = [str(k) for k in item.get("sources", []) if str(k) in valid_keys]
                try:
                    conf = float(item.get("confidence", 0.0))
                except (TypeError, ValueError):
                    conf = 0.0
                if keys and conf >= self.min_confidence:
                    matches.append(CitationMatch(claim=sent, source_keys=keys, confidence=conf))
            return matches
        return self._regex_fallback(sentences, sources)

    def _regex_fallback(self, sentences: List[str], sources: List[SourceDocument]) -> List[CitationMatch]:
        """Token-overlap matching (reference `citation.py:440-505`)."""
        matches = []
        for sent in sentences:
            words = set(re.findall(r"[a-z0-9]{4,}", sent.lower()))
            if not words:
                continue
            best_key, best_overlap = None, 0.0
            for src in sources:
                src_words = set(re.findall(r"[a-z0-9]{4,}", src.snippet.lower()))
                if not src_words:
                    continue
                overlap = len(words & src_words) / len(words)
                if overlap > best_overlap:
                    best_key, best_overlap = src.key, overlap
            if best_key and best_overlap >= 0.3:
                matches.append(CitationMatch(claim=sent, source_keys=[best_key],
                                             confidence=best_overlap))
        return matches

    # -- rendering ---------------------------------------------------------
    def _marker(self, keys: List[str], sources_by_key: Dict[str, SourceDocument]) -> str:
        if self.style is CitationStyle.INLINE:
            return "".join(f"[{k}]" for k in keys)
        if self.style is CitationStyle.FOOTNOTE:
            return "".join(f"[^{k}]" for k in keys)
        if self.style is CitationStyle.ACADEMIC:
            return "(" + "; ".join(sources_by_key[k].source for k in keys) + ")"
        if self.style is CitationStyle.HYPERLINK:
            return "".join(f"[{k}]({sources_by_key[k].source})" for k in keys)
        return "".join(f"[DOC-{k}]" for k in keys)  # ENTERPRISE

    def insert_markers(self, answer: str, matches: List[CitationMatch],
                       sources: List[SourceDocument]) -> str:
        by_key = {s.key: s for s in sources}
        out = answer
        for m in matches:
            marker = self._marker(m.source_keys, by_key)
            idx = out.find(m.claim)
            if idx >= 0:
                end = idx + len(m.claim)
                out = out[:end] + " " + marker + out[end:]
        return out

    def build_bibliography(self, sources: List[SourceDocument], used_keys: set) -> str:
        lines = ["", "Sources:"]
        for s in sources:
            if s.key in used_keys:
                lines.append(f"  [{s.key}] {s.source}")
        return "\n".join(lines) if len(lines) > 2 else ""

    # -- entry point -------------------------------------------------------
    def cite(self, answer: str, docs: List[DocScore]) -> CitedAnswer:
        sources = self.extract_sources(docs)
        try:
            matches = self.match_claims(answer, sources)
        except Exception as exc:
            logger.warning("citation matching failed: %s", exc)
            matches = []
        text = self.insert_markers(answer, matches, sources)
        used = {k for m in matches for k in m.source_keys}
        bib = self.build_bibliography(sources, used) if self.include_bibliography else ""
        return CitedAnswer(text=text, sources=sources, matches=matches,
                           bibliography=bib, audit_id=uuid.uuid4().hex[:16])
