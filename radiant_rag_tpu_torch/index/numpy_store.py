"""NumpyVectorStore: pure-host parity backend (exact numpy cosine scans).

The port's copy of `radiant_rag_tpu/index/numpy_store.py`: semantically the
TpuVectorStore with every scan exact, used as an oracle and for host-only
development.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from radiant_rag_tpu_torch.config import QuantizationConfig
from radiant_rag_tpu_torch.index.base import BaseVectorStore
from radiant_rag_tpu_torch.index.doc import StoredDoc
from radiant_rag_tpu_torch.index.docstore import DocStore


def _normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


class NumpyVectorStore(BaseVectorStore):
    def __init__(self, dim: int = 384, quantization: Optional[QuantizationConfig] = None) -> None:
        self.dim = dim
        self.quantization = quantization or QuantizationConfig()
        self.docstore = DocStore()
        self.vecs = np.zeros((0, dim), np.float32)

    def ping(self) -> bool:
        return True

    def upsert(self, content: str, meta: Optional[Dict[str, Any]] = None,
               embedding: Optional[np.ndarray] = None) -> str:
        meta = dict(meta or {})
        doc_id = self.make_doc_id(content, meta)
        doc = StoredDoc(doc_id, content, meta)
        if embedding is None:
            self.docstore.put(doc)
        elif self.docstore.row_of(doc_id) is None:
            row = self.vecs.shape[0]
            self.vecs = np.concatenate([self.vecs, _normalize(embedding)[None, :]], axis=0)
            self.docstore.put(doc, row=row)
        else:
            self.docstore.put(doc, row=self.docstore.row_of(doc_id))
        return doc_id

    def get_doc(self, doc_id: str) -> Optional[StoredDoc]:
        return self.docstore.get(doc_id)

    def has_embedding(self, doc_id: str) -> bool:
        return self.docstore.has_embedding(doc_id)

    def delete_doc(self, doc_id: str) -> bool:
        if self.docstore.get(doc_id) is None:
            return False
        row = self.docstore.delete(doc_id)
        if row is not None:
            self.vecs[row] = 0.0  # dead row scores ~0
        return True

    def retrieve_by_embedding_batch(
        self,
        embeddings: np.ndarray,
        top_k: int = 10,
        min_similarity: float = 0.0,
        ef_runtime: Optional[int] = None,
        language_filter: Optional[str] = None,
        doc_level_filter: Optional[str] = None,
        quantized: Optional[bool] = None,
    ) -> List[List[Tuple[StoredDoc, float]]]:
        q = _normalize(np.atleast_2d(embeddings))
        if self.vecs.shape[0] == 0:
            return [[] for _ in range(q.shape[0])]
        scores = q @ self.vecs.T  # (B, N)
        out: List[List[Tuple[StoredDoc, float]]] = []
        for qi in range(q.shape[0]):
            s = scores[qi]
            hits: List[Tuple[StoredDoc, float]] = []
            for r in np.argsort(-s):
                if len(hits) >= top_k:
                    break
                doc_id = self.docstore.row_to_id.get(int(r))
                doc = None if doc_id is None else self.docstore.get(doc_id)
                if doc is None or s[r] < min_similarity:
                    continue
                if doc_level_filter and doc.doc_level != doc_level_filter:
                    continue
                if language_filter and doc.language_code != language_filter:
                    continue
                hits.append((doc, float(s[r])))
            out.append(hits)
        return out

    def list_doc_ids(self) -> List[str]:
        return list(self.docstore.docs.keys())

    def list_doc_ids_with_embeddings(self) -> List[str]:
        return list(self.docstore.id_to_row.keys())

    def get_index_info(self) -> Dict[str, Any]:
        return {"backend": "numpy", "dim": self.dim, "num_docs": len(self.docstore),
                "num_embedded": len(self.docstore.id_to_row)}

    def drop_index(self) -> None:
        self.docstore.clear()
        self.vecs = np.zeros((0, self.dim), np.float32)

    def count_documents(self) -> int:
        return len(self.docstore)

    # row-space API (PersistentBM25Index)
    def row_of(self, doc_id: str) -> Optional[int]:
        return self.docstore.row_of(doc_id)

    def id_for_row(self, row: int) -> Optional[str]:
        return self.docstore.row_to_id.get(row)

    def valid_mask(self):
        return None

    def row_capacity(self) -> Optional[int]:
        return None
