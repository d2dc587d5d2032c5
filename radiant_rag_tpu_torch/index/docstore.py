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

`SpillDocStore` is the out-of-core form: content stays on disk in an
append-only log and only an id -> (segment, offset, length) index, the row
maps and a bounded LRU of hot docs live in host RAM. Its directory is the
JAX package's spill format too (`content-XXXXX.jsonl`, `idx-XXXXX.jsonl.gz`,
a `"format": "spill"` manifest): each package loads what the other wrote.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set

import numpy as np

from radiant_rag_tpu_torch.index.doc import StoredDoc

logger = logging.getLogger(__name__)

_MANIFEST = "manifest.json"
_MAX_SEGMENTS = 64
_GARBAGE_RATIO = 0.25


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


class _SpillKeysView:
    """Read-only mapping facade over SpillDocStore for code that reaches
    into `docstore.docs` (store.list_ids does `.docs.keys()`)."""

    def __init__(self, store: "SpillDocStore") -> None:
        self._s = store

    def keys(self):
        with self._s._lock:
            return list(self._s._loc.keys())

    def __len__(self) -> int:
        return len(self._s._loc)

    def __contains__(self, doc_id) -> bool:
        return doc_id in self._s._loc

    def __iter__(self):
        return iter(self.keys())

    def __getitem__(self, doc_id):
        doc = self._s.get(doc_id)
        if doc is None:
            raise KeyError(doc_id)
        return doc


class SpillDocStore(DocStore):
    """Out-of-core DocStore: content lives on disk, not in host RAM.

    The in-RAM DocStore holds every chunk's full text in a Python dict:
    fine to ~1M chunks, but 10M x ~500-char chunks is tens of GB of host
    RAM. The store is in-process by design, so the docstore itself goes
    out of core.

    Layout (all under one directory, which IS the persistent form):
      content-XXXXX.jsonl   append-only UNCOMPRESSED records
                            {"doc_id","content","meta","row"} — uncompressed
                            so a single doc is a seek+read, no stream decode
      idx-XXXXX.jsonl.gz    index delta per save(): {"doc_id",seg,off,len,row}
      manifest.json         {"format":"spill", content segments, index
                             segments, tombstones}

    RAM footprint per doc: one dict entry id -> (seg, off, len) plus the
    id<->row maps, a few hundred bytes instead of the full text and its
    meta; content fetches go through a bounded LRU (hot docs -- serving's
    top-k fetches -- stay resident).

    put() appends content immediately (buffered); save() flushes and writes
    only the index delta — O(new docs), same contract as the segmented
    in-RAM store. load() replays index segments only: restart never reads
    content bytes. Compaction (garbage > 25% or segments > 64) rewrites
    live records into a fresh content segment."""

    _CONTENT_FMT = "content-{:05d}.jsonl"
    _IDX_FMT = "idx-{:05d}.jsonl.gz"

    def __init__(self, directory: str, cache_docs: int = 50_000) -> None:
        super().__init__()
        del self.docs  # content never lives wholesale in RAM
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cache_docs = int(cache_docs)
        # id -> (content_seg_id, byte_offset, byte_len)
        self._loc: Dict[str, tuple] = {}
        self._cache: "OrderedDict[str, StoredDoc]" = OrderedDict()
        self._manifest = self._read_spill_manifest()
        self._active_id = 1 + max(self._manifest["content_segs"] or [0])
        self._active_fh = None
        self._readers: Dict[int, object] = {}
        self._live_bytes = 0
        self._total_bytes = 0

    # `docs` as a read-only property: DocStore.__init__ wrote the dict attr,
    # deleted above so this property (class-level) becomes visible.
    @property
    def docs(self) -> _SpillKeysView:  # type: ignore[override]
        return _SpillKeysView(self)

    @docs.setter
    def docs(self, value) -> None:  # DocStore.__init__ assigns; ignore
        pass

    @docs.deleter
    def docs(self) -> None:
        pass

    def _read_spill_manifest(self) -> Dict:
        try:
            with open(self.dir / _MANIFEST) as fh:
                m = json.load(fh)
            if m.get("format") != "spill":
                raise ValueError(
                    f"{self.dir} holds a non-spill docstore manifest; "
                    "load it with DocStore.load / load_docstore")
            return m
        except FileNotFoundError:
            return {"format": "spill", "version": 1,
                    "content_segs": [], "index_segs": [], "deleted": []}

    # -- content IO ---------------------------------------------------------
    def _writer(self):
        if self._active_fh is None:
            path = self.dir / self._CONTENT_FMT.format(self._active_id)
            self._active_fh = open(path, "ab")
        return self._active_fh

    def _read_record(self, seg: int, off: int, ln: int) -> StoredDoc:
        if seg == self._active_id and self._active_fh is not None:
            self._active_fh.flush()  # make buffered appends readable
        fh = self._readers.get(seg)
        if fh is None:
            fh = open(self.dir / self._CONTENT_FMT.format(seg), "rb")
            self._readers[seg] = fh
        fh.seek(off)
        rec = json.loads(fh.read(ln))
        return StoredDoc(rec["doc_id"], rec["content"], rec.get("meta") or {})

    def _append_record(self, doc: StoredDoc, row: int) -> None:
        data = (self._record(doc, row) + "\n").encode("utf-8")
        fh = self._writer()
        off = fh.tell()
        fh.write(data)
        self._loc[doc.doc_id] = (self._active_id, off, len(data) - 1)
        self._total_bytes += len(data)
        self._live_bytes += len(data)

    def _cache_put(self, doc: StoredDoc) -> None:
        c = self._cache
        c[doc.doc_id] = doc
        c.move_to_end(doc.doc_id)
        while len(c) > self.cache_docs:
            c.popitem(last=False)

    # -- membership ---------------------------------------------------------
    def put(self, doc: StoredDoc, row: Optional[int] = None) -> None:
        with self._lock:
            old = self._loc.get(doc.doc_id)
            if old is not None:
                self._superseded += 1
                self._live_bytes -= old[2] + 1
            self._append_record(doc, row if row is not None
                                else self.id_to_row.get(doc.doc_id, -1))
            self._cache_put(doc)
            self._dirty.add(doc.doc_id)
            self._deleted.discard(doc.doc_id)
            if row is not None:
                prev = self.id_to_row.pop(doc.doc_id, None)
                if prev is not None:
                    self.row_to_id.pop(prev, None)
                self.id_to_row[doc.doc_id] = row
                self.row_to_id[row] = doc.doc_id

    def get(self, doc_id: str) -> Optional[StoredDoc]:
        with self._lock:
            doc = self._cache.get(doc_id)
            if doc is not None:
                self._cache.move_to_end(doc_id)
                return doc
            loc = self._loc.get(doc_id)
            if loc is None:
                return None
            doc = self._read_record(*loc)
            self._cache_put(doc)
            return doc

    def delete(self, doc_id: str) -> Optional[int]:
        with self._lock:
            loc = self._loc.pop(doc_id, None)
            if loc is not None:
                self._live_bytes -= loc[2] + 1
                if doc_id not in self._dirty:
                    self._deleted.add(doc_id)
            self._cache.pop(doc_id, None)
            self._dirty.discard(doc_id)
            row = self.id_to_row.pop(doc_id, None)
            if row is not None:
                self.row_to_id.pop(row, None)
            return row

    def __len__(self) -> int:
        return len(self._loc)

    def __iter__(self) -> Iterator[StoredDoc]:
        # segment-ordered full scan (sequential IO), not per-id random reads
        with self._lock:
            order = sorted(self._loc.items(), key=lambda kv: (kv[1][0], kv[1][1]))
        for doc_id, loc in order:
            with self._lock:
                if self._loc.get(doc_id) != loc:
                    doc = self.get(doc_id)  # mutated mid-scan; fetch current
                else:
                    doc = self._read_record(*loc)
            if doc is not None:
                yield doc

    def clear(self) -> None:
        with self._lock:
            self._close_files()
            for seg in self._manifest["content_segs"] + [self._active_id]:
                for pat in (self._CONTENT_FMT.format(seg),):
                    try:
                        os.remove(self.dir / pat)
                    except OSError:
                        pass
            for name in self._manifest["index_segs"]:
                try:
                    os.remove(self.dir / name)
                except OSError:
                    pass
            self._loc.clear()
            self._cache.clear()
            self.id_to_row.clear()
            self.row_to_id.clear()
            self._dirty.clear()
            self._deleted.clear()
            self._superseded = 0
            self._live_bytes = self._total_bytes = 0
            self._manifest = {"format": "spill", "version": 1,
                              "content_segs": [], "index_segs": [], "deleted": []}
            self._write_manifest(self.dir, self._manifest)

    def _close_files(self) -> None:
        if self._active_fh is not None:
            self._active_fh.close()
            self._active_fh = None
        for fh in self._readers.values():
            fh.close()
        self._readers.clear()

    # -- persistence ---------------------------------------------------------
    def save(self, path: str = "") -> None:
        """Flush content, persist the index delta. `path`, when given, must
        equal this store's directory (the spill dir IS the persistent form);
        saving elsewhere is an export — full content rewrite."""
        if path and Path(path).resolve() != self.dir.resolve():
            self._export(Path(path))
            return
        with self._lock:
            if self._active_fh is not None:
                self._active_fh.flush()
                os.fsync(self._active_fh.fileno())
            dirty = set(self._dirty)
            deleted = set(self._deleted)
            garbage = self._total_bytes - self._live_bytes
            need_compact = (
                self._force_compact
                or len(self._manifest["index_segs"]) >= _MAX_SEGMENTS
                or (self._loc and garbage > _GARBAGE_RATIO * max(1, self._total_bytes))
            )
            if not (dirty or deleted or need_compact
                    or self._active_id not in self._manifest["content_segs"]):
                return
            if need_compact:
                self._compact_locked()
                return
            next_idx = 1 + len(self._manifest["index_segs"])
            name = self._IDX_FMT.format(next_idx)
            tmp = str(self.dir / name) + ".tmp"
            with gzip.open(tmp, "wt", encoding="utf-8") as fh:
                for doc_id in sorted(dirty):
                    loc = self._loc.get(doc_id)
                    if loc is None:
                        continue
                    fh.write(json.dumps({
                        "doc_id": doc_id, "seg": loc[0], "off": loc[1],
                        "len": loc[2], "row": self.id_to_row.get(doc_id, -1),
                    }) + "\n")
            os.replace(tmp, str(self.dir / name))
            m = self._manifest
            m["index_segs"].append(name)
            if self._active_id not in m["content_segs"]:
                m["content_segs"].append(self._active_id)
            m["deleted"] = sorted((set(m.get("deleted", [])) - dirty) | deleted)
            self._write_manifest(self.dir, m)
            self._dirty -= dirty
            self._deleted -= deleted

    def _compact_locked(self) -> None:
        """Rewrite live records into one fresh content segment + one index
        segment; drop old files. Called under the lock."""
        new_id = self._active_id + 1
        new_path = self.dir / self._CONTENT_FMT.format(new_id)
        new_loc: Dict[str, tuple] = {}
        written = 0
        with open(new_path, "wb") as out:
            for doc_id in list(self._loc):
                doc = self.get(doc_id)
                data = (self._record(doc, self.id_to_row.get(doc_id, -1))
                        + "\n").encode("utf-8")
                off = out.tell()
                out.write(data)
                new_loc[doc_id] = (new_id, off, len(data) - 1)
                written += len(data)
        idx_name = self._IDX_FMT.format(1)
        old_content = list(self._manifest["content_segs"])
        if self._active_id not in old_content:
            old_content.append(self._active_id)
        old_idx = list(self._manifest["index_segs"])
        self._close_files()
        self._loc = new_loc
        self._live_bytes = self._total_bytes = written
        self._active_id = new_id
        # fresh single index segment covering everything
        for name in old_idx:
            try:
                os.remove(self.dir / name)
            except OSError:
                pass
        tmp = str(self.dir / idx_name) + ".tmp"
        with gzip.open(tmp, "wt", encoding="utf-8") as fh:
            for doc_id, loc in self._loc.items():
                fh.write(json.dumps({
                    "doc_id": doc_id, "seg": loc[0], "off": loc[1],
                    "len": loc[2], "row": self.id_to_row.get(doc_id, -1),
                }) + "\n")
        os.replace(tmp, str(self.dir / idx_name))
        self._manifest = {"format": "spill", "version": 1,
                          "content_segs": [new_id], "index_segs": [idx_name],
                          "deleted": []}
        self._write_manifest(self.dir, self._manifest)
        for seg in old_content:
            if seg == new_id:
                continue
            try:
                os.remove(self.dir / self._CONTENT_FMT.format(seg))
            except OSError:
                pass
        self._dirty.clear()
        self._deleted.clear()
        self._superseded = 0
        self._force_compact = False

    def _export(self, d: Path) -> None:
        """Full export in the in-RAM store's segmented format (portable)."""
        tmp = DocStore()
        for doc in self:
            tmp.put(doc, row=self.id_to_row.get(doc.doc_id))
        tmp.save(str(d))

    @classmethod
    def load(cls, path: str, cache_docs: int = 50_000) -> "SpillDocStore":
        """Open a spill directory: replay index segments + tombstones. Never
        reads content bytes — restart cost is O(index), not O(corpus)."""
        store = cls(path, cache_docs=cache_docs)
        p = store.dir
        for name in store._manifest["index_segs"]:
            with gzip.open(p / name, "rt", encoding="utf-8") as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    doc_id = rec["doc_id"]
                    old = store._loc.get(doc_id)
                    if old is not None:
                        store._live_bytes -= old[2] + 1
                        store._superseded += 1
                    store._loc[doc_id] = (rec["seg"], rec["off"], rec["len"])
                    store._live_bytes += rec["len"] + 1
                    row = rec.get("row", -1)
                    prev = store.id_to_row.pop(doc_id, None)
                    if prev is not None:
                        store.row_to_id.pop(prev, None)
                    if row is not None and row >= 0:
                        store.id_to_row[doc_id] = row
                        store.row_to_id[row] = doc_id
        for doc_id in store._manifest.get("deleted", []):
            loc = store._loc.pop(doc_id, None)
            if loc is not None:
                store._live_bytes -= loc[2] + 1
            row = store.id_to_row.pop(doc_id, None)
            if row is not None:
                store.row_to_id.pop(row, None)
        for seg in store._manifest["content_segs"]:
            try:
                store._total_bytes += (p / cls._CONTENT_FMT.format(seg)).stat().st_size
            except OSError:
                pass
        store._dirty.clear()
        store._deleted.clear()
        return store


def load_docstore(index_dir: str, prefer: str = "",
                  cache_docs: int = 50_000) -> DocStore:
    """Open the docstore persisted under an index directory, dispatching on
    what is on disk: `docs_spill/` (out-of-core), `docs/` (in-RAM
    segmented), or legacy `docs.jsonl.gz`. With `prefer="spill"`, an
    in-RAM-format store is migrated once into `docs_spill/` so flipping
    `index.docstore: spill` on an existing deployment Just Works (later
    loads find the spill dir first)."""
    d = Path(index_dir)
    spill_dir = d / "docs_spill"
    if (spill_dir / _MANIFEST).is_file():
        return SpillDocStore.load(str(spill_dir), cache_docs=cache_docs)
    src = d / "docs"
    legacy = d / "docs.jsonl.gz"
    store = DocStore.load(str(src if src.is_dir() else legacy))
    if prefer == "spill":
        spill = SpillDocStore(str(spill_dir), cache_docs=cache_docs)
        for doc in store:
            spill.put(doc, row=store.id_to_row.get(doc.doc_id))
        spill.save()
        logger.info("migrated %d docs from in-RAM docstore %s to spill format",
                    len(spill), index_dir)
        return spill
    return store
