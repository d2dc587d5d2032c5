"""Host-side document content store with segmented persistence.

The port's copy of `DocStore` and `load_docstore` from
`radiant_rag_tpu/index/docstore.py`, in the same on-disk format, so either
package loads the other's `docs/` directory. Content + metadata are keyed
by content-hash doc id, beside the id <-> device-row map of embedded docs.
Each save() writes only the docs added or changed since the last save into
a fresh gzip-JSONL segment and atomically replaces a small manifest
(segments + deletion tombstones); load replays segments in order and
applies tombstones; a compaction rewrite folds everything into one segment
when garbage exceeds 25% or segments pass 64. The legacy single-file
format still loads.

The out-of-core `SpillDocStore` is not ported yet (ROADMAP queue A item
10): a `docs_spill/` directory or `prefer="spill"` raises.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set

import numpy as np

from radiant_rag_tpu_torch.index.doc import StoredDoc

logger = logging.getLogger(__name__)

_MANIFEST = "manifest.json"
_MAX_SEGMENTS = 64
_GARBAGE_RATIO = 0.25
SPILL_NOT_PORTED = ("the spill docstore (index.docstore: spill) is not ported yet: "
                    "ROADMAP queue A item 10")


class DocStore:
    def __init__(self) -> None:
        # RLock: readers (serving's pipelined complete() resolves rows ->
        # docs WITHOUT the server device lock) vs writers (ingest/delete
        # under it). Mutations touch two maps (id_to_row + row_to_id), so
        # correctness cannot ride on single-dict GIL atomicity.
        self._lock = threading.RLock()
        self.docs: Dict[str, StoredDoc] = {}
        self.id_to_row: Dict[str, int] = {}  # only docs with embeddings
        self.row_to_id: Dict[int, str] = {}
        # persistence deltas since the last save()
        self._dirty: Set[str] = set()
        self._deleted: Set[str] = set()
        self._superseded = 0  # stale generations sitting in old segments
        self._force_compact = False  # clear() must persist as a full rewrite

    # -- membership --------------------------------------------------------
    def put(self, doc: StoredDoc, row: Optional[int] = None) -> None:
        with self._lock:
            if doc.doc_id in self.docs and doc.doc_id not in self._dirty:
                self._superseded += 1  # old generation remains in a segment
            self.docs[doc.doc_id] = doc
            self._dirty.add(doc.doc_id)
            self._deleted.discard(doc.doc_id)
            if row is not None:
                old = self.id_to_row.pop(doc.doc_id, None)
                if old is not None:
                    self.row_to_id.pop(old, None)
                self.id_to_row[doc.doc_id] = row
                self.row_to_id[row] = doc.doc_id

    def get(self, doc_id: str) -> Optional[StoredDoc]:
        with self._lock:
            return self.docs.get(doc_id)

    def delete(self, doc_id: str) -> Optional[int]:
        """Remove doc; returns its device row if it had one."""
        with self._lock:
            existed = self.docs.pop(doc_id, None) is not None
            if existed and doc_id not in self._dirty:
                self._deleted.add(doc_id)  # tombstone for persisted generations
            self._dirty.discard(doc_id)
            row = self.id_to_row.pop(doc_id, None)
            if row is not None:
                self.row_to_id.pop(row, None)
            return row

    def has_embedding(self, doc_id: str) -> bool:
        return doc_id in self.id_to_row

    def row_of(self, doc_id: str) -> Optional[int]:
        with self._lock:
            return self.id_to_row.get(doc_id)

    def id_for_row(self, row: int) -> Optional[str]:
        with self._lock:
            return self.row_to_id.get(int(row))

    def ids_for_rows(self, rows: np.ndarray) -> List[Optional[str]]:
        with self._lock:
            return [self.row_to_id.get(int(r)) if r >= 0 else None for r in rows]

    def __len__(self) -> int:
        return len(self.docs)

    def __iter__(self) -> Iterator[StoredDoc]:
        return iter(self.docs.values())

    def clear(self) -> None:
        with self._lock:
            self.docs.clear()
            self.id_to_row.clear()
            self.row_to_id.clear()
            self._dirty.clear()
            self._deleted.clear()
            self._superseded = 0
            self._force_compact = True

    # -- persistence -------------------------------------------------------
    @staticmethod
    def _record(doc: StoredDoc, row: int) -> str:
        return json.dumps({
            "doc_id": doc.doc_id,
            "content": doc.content,
            "meta": doc.meta,
            "row": row,
        }, default=str)

    @staticmethod
    def _write_segment(d: Path, name: str, entries: List) -> None:
        """entries: (doc, row) pairs snapshotted under the store lock.
        StoredDoc values are replaced wholesale (never mutated in place), so
        serializing the references outside the lock is race-free."""
        tmp = str(d / name) + ".tmp"
        with gzip.open(tmp, "wt", encoding="utf-8") as fh:
            for doc, row in entries:
                fh.write(DocStore._record(doc, row) + "\n")
        os.replace(tmp, str(d / name))

    @staticmethod
    def _read_manifest(d: Path) -> Dict:
        try:
            with open(d / _MANIFEST) as fh:
                return json.load(fh)
        except FileNotFoundError:
            return {"version": 1, "segments": [], "deleted": []}

    @staticmethod
    def _write_manifest(d: Path, manifest: Dict) -> None:
        tmp = str(d / _MANIFEST) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh)
        os.replace(tmp, str(d / _MANIFEST))

    def save(self, path: str) -> None:
        """Segmented incremental save into directory `path`. No-op when
        nothing changed since the last save (auto-persist after a read-only
        operation costs nothing)."""
        d = Path(path)
        d.mkdir(parents=True, exist_ok=True)
        manifest = self._read_manifest(d)
        known_deleted = set(manifest.get("deleted", []))
        # Snapshot the delta under the lock: a put()/delete() racing with the
        # segment write below must survive into the NEXT save instead of being
        # cleared unpersisted.
        with self._lock:
            dirty = set(self._dirty)
            deleted = set(self._deleted)
            superseded = self._superseded
            garbage = superseded + len(deleted | known_deleted)
            compact = (
                self._force_compact
                or len(manifest["segments"]) >= _MAX_SEGMENTS
                or (self.docs and garbage > _GARBAGE_RATIO * len(self.docs))
                or (not manifest["segments"] and not (d / _MANIFEST).exists())
            )
            write_ids = list(self.docs) if compact else sorted(dirty)
            entries = []
            for doc_id in write_ids:
                doc = self.docs.get(doc_id)
                if doc is not None:
                    entries.append((doc, self.id_to_row.get(doc_id, -1)))
        next_id = 1 + max(
            [int(s.split("-")[1].split(".")[0]) for s in manifest["segments"]] or [-1])
        if compact:
            name = f"seg-{next_id:05d}.jsonl.gz"
            self._write_segment(d, name, entries)
            old = list(manifest["segments"])
            self._write_manifest(d, {"version": 1, "segments": [name], "deleted": []})
            for s in old:
                try:
                    os.remove(d / s)
                except OSError:
                    pass
        elif dirty or deleted:
            name = f"seg-{next_id:05d}.jsonl.gz"
            self._write_segment(d, name, entries)
            manifest["segments"].append(name)
            # Drop tombstones for docs re-added since they were deleted: the
            # re-add's record is in the segment just written, and load()
            # applies tombstones AFTER replaying all segments — a stale
            # tombstone would silently erase the resurrected doc on restart
            # (delete -> re-ingest is routine with content-hash ids).
            manifest["deleted"] = sorted((known_deleted - dirty) | deleted)
            self._write_manifest(d, manifest)
        else:
            return  # nothing changed
        with self._lock:
            self._dirty -= dirty
            self._deleted -= deleted
            if compact:
                # racing put()s may have superseded docs since the snapshot
                self._superseded = max(0, self._superseded - superseded)
                self._force_compact = False

    @classmethod
    def load(cls, path: str) -> "DocStore":
        """Load a segmented directory, or a legacy single jsonl.gz file."""
        store = cls()
        p = Path(path)
        replayed = 0
        if p.is_dir():
            manifest = cls._read_manifest(p)
            for seg in manifest["segments"]:
                replayed += store._load_file(p / seg)
            for doc_id in manifest.get("deleted", []):
                store.docs.pop(doc_id, None)
                row = store.id_to_row.pop(doc_id, None)
                if row is not None:
                    store.row_to_id.pop(row, None)
        else:
            replayed += store._load_file(p)
        store._dirty.clear()
        store._deleted.clear()
        # on-disk garbage carried over: stale generations + tombstoned
        # records still sitting in segments (drives the compaction trigger)
        store._superseded = max(0, replayed - len(store.docs))
        return store

    def _load_file(self, path: Path) -> int:
        n = 0
        with gzip.open(path, "rt", encoding="utf-8") as fh:
            for line in fh:
                if not line.strip():
                    continue
                rec = json.loads(line)
                row = rec.get("row", -1)
                self.put(
                    StoredDoc(rec["doc_id"], rec["content"], rec.get("meta") or {}),
                    row=row if row >= 0 else None,
                )
                n += 1
        return n


def load_docstore(index_dir: str, prefer: str = "") -> DocStore:
    """Open the docstore persisted under an index directory: `docs/`
    (segmented) or the legacy `docs.jsonl.gz`."""
    d = Path(index_dir)
    if prefer == "spill" or (d / "docs_spill" / _MANIFEST).is_file():
        raise NotImplementedError(SPILL_NOT_PORTED)
    src = d / "docs"
    return DocStore.load(str(src if src.is_dir() else d / "docs.jsonl.gz"))
