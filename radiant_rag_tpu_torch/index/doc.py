"""Stored document record: the port's copy of `radiant_rag_tpu/index/doc.py`."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class StoredDoc:
    """A stored document/chunk; hashed and compared by doc_id only."""

    doc_id: str
    content: str
    meta: Dict[str, Any] = field(default_factory=dict)

    def __hash__(self) -> int:
        return hash(self.doc_id)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, StoredDoc) and other.doc_id == self.doc_id

    @property
    def doc_level(self) -> str:
        return str(self.meta.get("doc_level", "leaf"))

    @property
    def parent_id(self) -> str:
        return str(self.meta.get("parent_id", "") or "")

    @property
    def language_code(self) -> str:
        return str(self.meta.get("language_code", "") or "")

    @property
    def source(self) -> str:
        return str(self.meta.get("source", "") or "")
