"""TpuVectorStore: the vector store over the device index engine.

The port's copy of `radiant_rag_tpu/index/store.py` (the name is kept so
each function has its counterpart): a host `DocStore` of content and
metadata beside a `DeviceVectorIndex` on the card. Batched retrieval runs
the engine's fused two-stage search; `save` / `load` use the JAX package's
on-disk format (`docs/` segments, `engine.npz`, `manifest.json`), so either
package loads the other's saved directory.

`index.docstore: spill` keeps the content out of core (`SpillDocStore`
under `<data_dir>/docs_spill`, of `docstore_cache_docs` hot docs); loading
an in-RAM directory with it migrates the docs once.

`index.use_graph: true` plus `build_graph()` serves the store's own dense
retrieval from the engine's KNN graph (`index/graph.py`, degree
`index.graph_degree`, beam width `index.graph_ef_runtime`); before the
build, and after a restart (neither package saves the graph), it serves
the flat scan.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from radiant_rag_tpu_torch.config import IndexConfig, QuantizationConfig
from radiant_rag_tpu_torch.index.base import BaseVectorStore, Triple
from radiant_rag_tpu_torch.index.doc import StoredDoc
from radiant_rag_tpu_torch.index.docstore import DocStore, SpillDocStore, load_docstore
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex

logger = logging.getLogger(__name__)

LEVEL_CODES: Dict[str, int] = {"leaf": 0, "parent": 1, "other": 2}
_MODE_OF_PRECISION = {"binary": "binary", "int8": "int8", "both": "int8"}


def _normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


class TpuVectorStore(BaseVectorStore):
    def __init__(self, dim: int = 384, index_config: Optional[IndexConfig] = None,
                 quantization: Optional[QuantizationConfig] = None, device=None) -> None:
        self.index_config = index_config or IndexConfig(dim=dim)
        self.quantization = quantization or QuantizationConfig()
        self.dim = dim
        if self.index_config.docstore == "spill":
            self.docstore: DocStore = SpillDocStore(
                os.path.join(self.index_config.data_dir, "docs_spill"),
                cache_docs=self.index_config.docstore_cache_docs)
        else:
            self.docstore = DocStore()
        self.engine = self._new_engine(device)
        self.lang_codes: Dict[str, int] = {}
        path = self.quantization.int8_ranges_path
        if path and os.path.isfile(path):
            ranges = np.load(path)
            self.engine.set_int8_ranges(ranges[0], ranges[1])
            logger.info("loaded int8 calibration from %s", path)

    def _new_engine(self, device) -> DeviceVectorIndex:
        cfg = self.index_config
        return DeviceVectorIndex(self.dim, initial_capacity=cfg.initial_capacity,
                                 store_fp32=cfg.store_fp32, vec_dtype=cfg.dtype,
                                 stage1_select=cfg.stage1_select, device=device)

    # -- helpers -----------------------------------------------------------
    def _lang_code(self, lang: str) -> int:
        if not lang:
            return 0
        code = self.lang_codes.get(lang)
        if code is None:
            code = len(self.lang_codes) + 1
            self.lang_codes[lang] = code
        return code

    def _level_code(self, level: str) -> int:
        return LEVEL_CODES.get(level, LEVEL_CODES["other"])

    @property
    def default_search_mode(self) -> str:
        """The stage-1 scan an unqualified search uses (for callers that
        drive the engine themselves, such as `HybridSearcher`)."""
        return self._default_mode()

    def _default_mode(self) -> str:
        """"graph" under use_graph once a graph is built; otherwise precision
        "binary" scans the sign words, "int8" and "both" the int8 codes, and
        quantization off is the exact scan."""
        graph = self.engine.graph
        if self.index_config.use_graph and graph is not None and graph.built_rows > 0:
            return "graph"
        if not self.quantization.enabled:
            return "exact"
        return _MODE_OF_PRECISION[self.quantization.precision]

    def build_graph(self) -> None:
        """Build the KNN-graph engine over the current rows."""
        self.engine.build_graph(degree=self.index_config.graph_degree)

    # -- BaseVectorStore ---------------------------------------------------
    def ping(self) -> bool:
        return True

    def reserve(self, additional_docs: int) -> None:
        """Pre-size the device index for a bulk load."""
        self.engine.reserve(self.engine.count + max(0, int(additional_docs)))

    def upsert(self, content: str, meta: Optional[Dict[str, Any]] = None,
               embedding: Optional[np.ndarray] = None) -> str:
        return self.upsert_batch([(content, meta, embedding)])[0]

    def upsert_batch(self, docs: Sequence[Triple]) -> List[str]:
        ids: List[str] = []
        emb_rows: List[Tuple[StoredDoc, np.ndarray]] = []
        batch_seen: set = set()  # doc ids appended in this batch
        for content, meta, embedding in docs:
            meta = dict(meta or {})
            doc_id = self.make_doc_id(content, meta)
            doc = StoredDoc(doc_id, content, meta)
            ids.append(doc_id)
            if embedding is None:
                self.docstore.put(doc)
                continue
            old_row = self.docstore.row_of(doc_id)
            if old_row is not None:  # same content hash => same vector
                self.docstore.put(doc, row=old_row)
                continue
            if doc_id in batch_seen:
                # a duplicate within the batch: one engine row is enough (a
                # second would be displaced at put() and stay valid, an orphan)
                continue
            batch_seen.add(doc_id)
            emb_rows.append((doc, np.asarray(embedding, np.float32)))
        if emb_rows:
            vecs = _normalize(np.stack([e for _, e in emb_rows]))
            if vecs.shape[1] != self.engine.dim:
                raise ValueError(
                    f"embedding dim {vecs.shape[1]} != index dim {self.engine.dim}; the "
                    "index (possibly loaded from disk) was built for a different embedder")
            levels = np.asarray([self._level_code(d.doc_level) for d, _ in emb_rows], np.int8)
            langs = np.asarray([self._lang_code(d.language_code) for d, _ in emb_rows],
                               np.int32)
            doc_lens = np.asarray([len(d.content.split()) for d, _ in emb_rows], np.float32)
            rows = self.engine.append(vecs, levels, langs, doc_lens)
            for (doc, _), row in zip(emb_rows, rows):
                displaced = self.docstore.row_of(doc.doc_id)
                if displaced is not None and displaced != int(row):
                    self.engine.invalidate(np.asarray([displaced]))
                self.docstore.put(doc, row=int(row))
        return ids

    def get_doc(self, doc_id: str) -> Optional[StoredDoc]:
        return self.docstore.get(doc_id)

    def has_embedding(self, doc_id: str) -> bool:
        return self.docstore.has_embedding(doc_id)

    def delete_doc(self, doc_id: str) -> bool:
        if self.docstore.get(doc_id) is None:
            return False
        row = self.docstore.delete(doc_id)
        if row is not None:
            self.engine.invalidate(np.asarray([row]))
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
        embeddings = _normalize(np.atleast_2d(np.asarray(embeddings, np.float32)))
        b = embeddings.shape[0]
        if self.engine.count == 0:
            return [[] for _ in range(b)]
        if quantized is None:
            mode = self._default_mode()
        elif quantized:
            mode = _MODE_OF_PRECISION[self.quantization.precision]
        else:
            mode = "exact"
        level_code = -1 if not doc_level_filter else self._level_code(doc_level_filter)
        lang_code = -1
        if language_filter:
            lang_code = self.lang_codes.get(language_filter, -2)
            if lang_code == -2:  # a language never stored matches nothing
                return [[] for _ in range(b)]
        cfg, q = self.index_config, self.quantization
        scores, rows = self.engine.search(
            embeddings, top_k, mode=mode,
            rescore_multiplier=q.rescore_multiplier if q.use_rescoring else 1.0,
            ef_runtime=ef_runtime or (cfg.graph_ef_runtime if cfg.use_graph else None),
            level_code=level_code, lang_code=lang_code)
        out: List[List[Tuple[StoredDoc, float]]] = []
        for qi in range(b):
            hits: List[Tuple[StoredDoc, float]] = []
            for s, r in zip(scores[qi], rows[qi]):
                if r < 0 or s < min_similarity:
                    continue
                doc_id = self.docstore.row_to_id.get(int(r))
                doc = None if doc_id is None else self.docstore.get(doc_id)
                if doc is not None:
                    hits.append((doc, float(s)))
            out.append(hits)
        return out

    def list_doc_ids(self) -> List[str]:
        return list(self.docstore.docs.keys())

    def list_doc_ids_with_embeddings(self) -> List[str]:
        return list(self.docstore.id_to_row.keys())

    def get_index_info(self) -> Dict[str, Any]:
        return {
            "backend": "tpu",
            "dim": self.dim,
            "num_docs": len(self.docstore),
            "num_embedded": len(self.docstore.id_to_row),
            "capacity": self.engine.capacity,
            "rows_used": self.engine.count,
            "default_mode": self._default_mode(),
            "quantization": {
                "enabled": self.quantization.enabled,
                "precision": self.quantization.precision,
                "rescore_multiplier": self.quantization.rescore_multiplier,
                "calibrated": self.engine._calibrated,
            },
            "memory_bytes": self.engine.memory_bytes(),
            "languages": dict(self.lang_codes),
        }

    def drop_index(self) -> None:
        self.docstore.clear()
        self.engine = self._new_engine(self.engine.device)
        self.lang_codes.clear()

    def count_documents(self) -> int:
        return len(self.docstore)

    # -- row-space API (BM25 + fusion) ---------------------------------------
    def row_of(self, doc_id: str) -> Optional[int]:
        return self.docstore.row_of(doc_id)

    def id_for_row(self, row: int) -> Optional[str]:
        return self.docstore.id_for_row(row)

    def valid_mask(self):
        return self.engine.valid

    def row_capacity(self) -> int:
        return self.engine.capacity

    # -- persistence -------------------------------------------------------
    def save(self, directory: str) -> None:
        """Checkpoint the index: docstore segments + engine arrays + vocab."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        # a spill store saving into its own directory persists its index
        # delta in place; into another directory it exports the in-RAM
        # segmented format under docs/ (docs_spill/ holds spill stores only)
        if isinstance(self.docstore, SpillDocStore) and \
                (d / "docs_spill").resolve() == self.docstore.dir.resolve():
            self.docstore.save()
        else:
            self.docstore.save(str(d / "docs"))
        legacy = d / "docs.jsonl.gz"
        if legacy.exists():
            legacy.unlink()  # migrated to docs/ segments
        tmp = str(d / "engine.tmp.npz")
        np.savez_compressed(tmp, **self.engine.to_host())
        os.replace(tmp, str(d / "engine.npz"))
        with open(d / "manifest.json", "w") as fh:
            json.dump({"dim": self.dim, "lang_codes": self.lang_codes, "version": 1}, fh)

    @classmethod
    def load(cls, directory: str, index_config: Optional[IndexConfig] = None,
             quantization: Optional[QuantizationConfig] = None, device=None
             ) -> "TpuVectorStore":
        """Load a saved directory (either package's). As in the JAX package,
        the engine is rebuilt from the saved vectors with the default
        store_fp32=True: an fp32-free index comes back with the dequantized
        vectors resident."""
        d = Path(directory)
        with open(d / "manifest.json") as fh:
            manifest = json.load(fh)
        store = cls(dim=manifest["dim"], index_config=index_config,
                    quantization=quantization, device=device)
        store.lang_codes = {str(k): int(v) for k, v in manifest.get("lang_codes", {}).items()}
        cfg = store.index_config
        store.docstore = load_docstore(str(d), prefer="spill" if cfg.docstore == "spill" else "",
                                       cache_docs=cfg.docstore_cache_docs)
        with np.load(d / "engine.npz") as z:
            state = {k: z[k] for k in z.files}
        store.engine = DeviceVectorIndex.from_host(
            state, initial_capacity=store.index_config.initial_capacity,
            stage1_select=store.index_config.stage1_select, device=store.engine.device)
        return store
