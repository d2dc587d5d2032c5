"""Vector-store interface: the port's copy of `radiant_rag_tpu/index/base.py`.

`retrieve_by_embedding_batch` is the primitive; the single-query and
quantized variants wrap it.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from radiant_rag_tpu_torch.index.doc import StoredDoc
from radiant_rag_tpu_torch.utils.hashing import make_doc_id as _make_doc_id

Triple = Tuple[str, Optional[Dict[str, Any]], Optional[np.ndarray]]


class BaseVectorStore(abc.ABC):
    """Abstract vector store. Scores are cosine similarities in [-1, 1]."""

    @property
    def default_search_mode(self) -> str:
        """Engine mode an unqualified search would use; backends without a
        quantized device engine serve exact scans."""
        return "exact"

    def make_doc_id(self, content: str, meta: Optional[Dict[str, Any]] = None) -> str:
        """Content-hash id."""
        return _make_doc_id(content, meta)

    @abc.abstractmethod
    def ping(self) -> bool:
        ...

    # -- writes ------------------------------------------------------------
    @abc.abstractmethod
    def upsert(self, content: str, meta: Optional[Dict[str, Any]] = None,
               embedding: Optional[np.ndarray] = None) -> str:
        """Insert/update one doc (with optional embedding); returns doc_id."""

    def upsert_doc_only(self, content: str, meta: Optional[Dict[str, Any]] = None) -> str:
        """Store a doc without an embedding (parents)."""
        return self.upsert(content, meta, embedding=None)

    def upsert_batch(self, docs: Sequence[Triple]) -> List[str]:
        """Batch upsert of (content, meta, embedding) triples."""
        return [self.upsert(c, m, e) for c, m, e in docs]

    def upsert_doc_only_batch(self, docs: Sequence[Tuple[str, Optional[Dict[str, Any]]]]
                              ) -> List[str]:
        return [self.upsert_doc_only(c, m) for c, m in docs]

    # -- reads -------------------------------------------------------------
    @abc.abstractmethod
    def get_doc(self, doc_id: str) -> Optional[StoredDoc]:
        ...

    @abc.abstractmethod
    def has_embedding(self, doc_id: str) -> bool:
        ...

    @abc.abstractmethod
    def delete_doc(self, doc_id: str) -> bool:
        ...

    @abc.abstractmethod
    def retrieve_by_embedding_batch(
        self,
        embeddings: np.ndarray,  # (B, D)
        top_k: int = 10,
        min_similarity: float = 0.0,
        ef_runtime: Optional[int] = None,
        language_filter: Optional[str] = None,
        doc_level_filter: Optional[str] = None,
        quantized: Optional[bool] = None,
    ) -> List[List[Tuple[StoredDoc, float]]]:
        """Batched KNN: one device search per call."""

    def retrieve_by_embedding(
        self,
        embedding: np.ndarray,
        top_k: int = 10,
        min_similarity: float = 0.0,
        ef_runtime: Optional[int] = None,
        language_filter: Optional[str] = None,
        doc_level_filter: Optional[str] = None,
        quantized: Optional[bool] = None,
    ) -> List[Tuple[StoredDoc, float]]:
        """Single-query retrieval."""
        return self.retrieve_by_embedding_batch(
            np.asarray(embedding)[None, :], top_k, min_similarity, ef_runtime,
            language_filter, doc_level_filter, quantized=quantized,
        )[0]

    def retrieve_by_embedding_quantized(
        self,
        embedding: np.ndarray,
        top_k: int = 10,
        min_similarity: float = 0.0,
        rescore_multiplier: float = 4.0,
        language_filter: Optional[str] = None,
        doc_level_filter: Optional[str] = None,
    ) -> List[Tuple[StoredDoc, float]]:
        """Two-stage quantized retrieval (the store's own multiplier
        applies, as in the JAX package)."""
        return self.retrieve_by_embedding_batch(
            np.asarray(embedding)[None, :], top_k, min_similarity, None,
            language_filter, doc_level_filter, quantized=True,
        )[0]

    # -- admin -------------------------------------------------------------
    @abc.abstractmethod
    def list_doc_ids(self) -> List[str]:
        ...

    @abc.abstractmethod
    def list_doc_ids_with_embeddings(self) -> List[str]:
        ...

    @abc.abstractmethod
    def get_index_info(self) -> Dict[str, Any]:
        ...

    @abc.abstractmethod
    def drop_index(self) -> None:
        ...

    @abc.abstractmethod
    def count_documents(self) -> int:
        ...
