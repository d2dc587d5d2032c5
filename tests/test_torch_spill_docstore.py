"""The port's out-of-core docstore (`index/docstore.SpillDocStore`): the
cases of tests/test_spill_docstore.py against the port, then the cross-package
checks: the same operations write byte-identical spill directories in both
packages, and each package loads what the other wrote (the docstore alone,
and whole `index.docstore: spill` store directories).

Content lives on disk with only an id -> (segment, offset) index and an LRU
in RAM; save() persists O(new docs) index deltas; load() never reads content
bytes; flipping `index.docstore: spill` on an in-RAM deployment migrates once.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from radiant_rag_tpu.config import IndexConfig as JaxIndexConfig
from radiant_rag_tpu.index.docstore import SpillDocStore as JaxSpill
from radiant_rag_tpu.index.docstore import StoredDoc as JaxDoc
from radiant_rag_tpu.index.store import TpuVectorStore as JaxStore
from radiant_rag_tpu_torch.config import IndexConfig
from radiant_rag_tpu_torch.index.doc import StoredDoc
from radiant_rag_tpu_torch.index.docstore import DocStore, SpillDocStore, load_docstore
from radiant_rag_tpu_torch.index.store import TpuVectorStore


def _mk(n, prefix="doc"):
    return [StoredDoc(f"{prefix}{i}", f"content of {prefix}{i}", {"i": i})
            for i in range(n)]


def test_put_get_roundtrip_and_len(tmp_path):
    s = SpillDocStore(str(tmp_path / "spill"))
    for i, doc in enumerate(_mk(20)):
        s.put(doc, row=i)
    assert len(s) == 20
    assert s.get("doc7").content == "content of doc7"
    assert s.get("doc7").meta == {"i": 7}
    assert s.row_of("doc3") == 3
    assert s.id_for_row(3) == "doc3"
    assert s.get("missing") is None


def test_content_not_in_ram(tmp_path):
    """With a 2-doc LRU, older docs must be served from disk, not memory."""
    s = SpillDocStore(str(tmp_path / "spill"), cache_docs=2)
    for i, doc in enumerate(_mk(10)):
        s.put(doc, row=i)
    s.save()
    assert len(s._cache) == 2
    doc = s.get("doc0")  # evicted long ago -> disk fetch
    assert doc.content == "content of doc0"
    assert "doc0" in s._cache  # fetched docs become hot


def test_save_load_roundtrip(tmp_path):
    d = str(tmp_path / "spill")
    s = SpillDocStore(d)
    for i, doc in enumerate(_mk(15)):
        s.put(doc, row=i)
    s.save()
    s2 = SpillDocStore.load(d)
    assert len(s2) == 15
    assert s2.get("doc11").content == "content of doc11"
    assert s2.row_of("doc11") == 11
    assert s2.id_for_row(14) == "doc14"


def test_incremental_save_is_delta(tmp_path):
    d = tmp_path / "spill"
    s = SpillDocStore(str(d))
    for i, doc in enumerate(_mk(50)):
        s.put(doc, row=i)
    s.save()
    idx1 = sorted(p.name for p in d.glob("idx-*.jsonl.gz"))
    s.put(StoredDoc("extra", "late arrival", {}), row=50)
    s.save()
    idx2 = sorted(p.name for p in d.glob("idx-*.jsonl.gz"))
    new = set(idx2) - set(idx1)
    assert len(new) == 1
    import gzip

    with gzip.open(d / new.pop(), "rt") as fh:
        lines = [json.loads(x) for x in fh]
    assert [r["doc_id"] for r in lines] == ["extra"]


def test_unchanged_save_is_noop(tmp_path):
    d = tmp_path / "spill"
    s = SpillDocStore(str(d))
    for i, doc in enumerate(_mk(5)):
        s.put(doc, row=i)
    s.save()
    before = sorted(p.name for p in d.iterdir())
    s.save()
    assert sorted(p.name for p in d.iterdir()) == before


def test_delete_tombstone_survives_reload(tmp_path):
    d = str(tmp_path / "spill")
    s = SpillDocStore(d)
    for i, doc in enumerate(_mk(6)):
        s.put(doc, row=i)
    s.save()
    assert s.delete("doc2") == 2
    s.save()
    s2 = SpillDocStore.load(d)
    assert len(s2) == 5
    assert s2.get("doc2") is None
    assert s2.row_of("doc2") is None


def test_update_latest_generation_wins_after_reload(tmp_path):
    d = str(tmp_path / "spill")
    s = SpillDocStore(d)
    s.put(StoredDoc("a", "v1", {}), row=0)
    s.save()
    s.put(StoredDoc("a", "v2", {}), row=0)
    s.save()
    s2 = SpillDocStore.load(d)
    assert s2.get("a").content == "v2"
    assert len(s2) == 1


def test_compaction_reclaims_disk(tmp_path):
    d = tmp_path / "spill"
    s = SpillDocStore(str(d))
    for i, doc in enumerate(_mk(30)):
        s.put(doc, row=i)
    # rewrite everything several times -> >25% garbage triggers compaction
    for gen in range(4):
        for i in range(30):
            s.put(StoredDoc(f"doc{i}", f"gen{gen} doc{i}", {}), row=i)
        s.save()
    content = list(d.glob("content-*.jsonl"))
    total = sum(p.stat().st_size for p in content)
    # live data is ~30 short records; compaction must have dropped the rest
    assert total < 4 * 30 * 120
    s2 = SpillDocStore.load(str(d))
    assert len(s2) == 30
    assert s2.get("doc5").content == "gen3 doc5"


def test_iter_streams_all_docs(tmp_path):
    s = SpillDocStore(str(tmp_path / "spill"), cache_docs=3)
    for i, doc in enumerate(_mk(25)):
        s.put(doc, row=i)
    seen = {d.doc_id for d in s}
    assert seen == {f"doc{i}" for i in range(25)}


def test_docs_view_supports_keys(tmp_path):
    s = SpillDocStore(str(tmp_path / "spill"))
    for i, doc in enumerate(_mk(4)):
        s.put(doc, row=i)
    assert sorted(s.docs.keys()) == ["doc0", "doc1", "doc2", "doc3"]
    assert "doc2" in s.docs
    assert len(s.docs) == 4
    assert s.docs["doc1"].content == "content of doc1"
    with pytest.raises(KeyError):
        s.docs["nope"]


def test_clear_empties_disk_and_ram(tmp_path):
    d = tmp_path / "spill"
    s = SpillDocStore(str(d))
    for i, doc in enumerate(_mk(8)):
        s.put(doc, row=i)
    s.save()
    s.clear()
    assert len(s) == 0
    assert not list(d.glob("content-*.jsonl"))
    s.put(StoredDoc("fresh", "after clear", {}), row=0)
    s.save()
    s2 = SpillDocStore.load(str(d))
    assert len(s2) == 1 and s2.get("fresh").content == "after clear"


def test_load_never_reads_content_bytes(tmp_path, monkeypatch):
    d = str(tmp_path / "spill")
    s = SpillDocStore(d)
    for i, doc in enumerate(_mk(10)):
        s.put(doc, row=i)
    s.save()
    called = []
    orig = SpillDocStore._read_record

    def spy(self, *a):
        called.append(a)
        return orig(self, *a)

    monkeypatch.setattr(SpillDocStore, "_read_record", spy)
    s2 = SpillDocStore.load(d)
    assert len(s2) == 10
    assert called == []  # restart cost is O(index)
    assert s2.get("doc1").content == "content of doc1"
    assert len(called) == 1


def test_migration_from_memory_format(tmp_path):
    base = tmp_path / "index"
    base.mkdir()
    mem = DocStore()
    for i, doc in enumerate(_mk(12)):
        mem.put(doc, row=i)
    mem.save(str(base / "docs"))
    migrated = load_docstore(str(base), prefer="spill")
    assert isinstance(migrated, SpillDocStore)
    assert len(migrated) == 12
    assert migrated.row_of("doc4") == 4
    # second open finds the spill dir directly (no re-migration)
    again = load_docstore(str(base), prefer="spill")
    assert isinstance(again, SpillDocStore)
    assert len(again) == 12
    # without the preference the spill dir still wins (it is the fresher form)
    assert isinstance(load_docstore(str(base)), SpillDocStore)


def test_store_level_spill_roundtrip(tmp_path, rng=None):
    rng = np.random.default_rng(0)
    data_dir = str(tmp_path / "idx")
    cfg = IndexConfig(dim=32, initial_capacity=64, data_dir=data_dir,
                      docstore="spill", docstore_cache_docs=4)
    store = TpuVectorStore(dim=32, index_config=cfg, device="cpu")
    assert isinstance(store.docstore, SpillDocStore)
    embs = rng.standard_normal((10, 32)).astype(np.float32)
    store.upsert_batch([(f"text number {i}", {"i": i}, embs[i])
                        for i in range(10)])
    store.save(data_dir)
    loaded = TpuVectorStore.load(data_dir, index_config=cfg, device="cpu")
    assert isinstance(loaded.docstore, SpillDocStore)
    assert loaded.count_documents() == 10
    res = loaded.retrieve_by_embedding(embs[3], top_k=1)
    assert res and res[0][0].content == "text number 3"


def test_store_export_to_foreign_dir_is_portable(tmp_path):
    rng = np.random.default_rng(1)
    data_dir = str(tmp_path / "idx")
    cfg = IndexConfig(dim=32, initial_capacity=64, data_dir=data_dir,
                      docstore="spill")
    store = TpuVectorStore(dim=32, index_config=cfg, device="cpu")
    embs = rng.standard_normal((5, 32)).astype(np.float32)
    store.upsert_batch([(f"chunk {i}", {}, embs[i]) for i in range(5)])
    foreign = str(tmp_path / "export")
    store.save(foreign)
    # foreign dir holds the portable in-RAM format; loads with default config
    loaded = TpuVectorStore.load(foreign, device="cpu")
    assert loaded.count_documents() == 5
    assert isinstance(loaded.docstore, DocStore)


def _script(spill_cls, doc_cls, d):
    """One sequence of puts, updates, deletes and saves (a compaction
    included) through a package's SpillDocStore."""
    s = spill_cls(str(d), cache_docs=3)
    for i in range(12):
        s.put(doc_cls(f"doc{i}", f"content of doc{i} \u00e9", {"i": i, "tags": ["a", "b"]}),
              row=i)
    s.save()
    s.put(doc_cls("doc3", "updated three", {}), row=3)
    s.delete("doc8")
    s.put(doc_cls("late", "late arrival", {"k": None}))
    s.save()
    for gen in range(3):  # > 25% garbage: the next save compacts
        for i in range(6):
            s.put(doc_cls(f"doc{i}", f"gen{gen} doc{i}", {}), row=i)
    s.save()
    s.put(doc_cls("after", "after compaction", {}), row=40)
    s.save()
    return s


def _files(d: Path):
    return {p.name: p.read_bytes() if not p.name.endswith(".gz") else
            __import__("gzip").decompress(p.read_bytes()) for p in sorted(d.iterdir())}


def test_spill_directories_are_byte_identical_to_jax(tmp_path):
    _script(JaxSpill, JaxDoc, tmp_path / "j")
    _script(SpillDocStore, StoredDoc, tmp_path / "t")
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_spill_directory_loads_across_packages(tmp_path, writer, reader):
    w_cls, doc_cls = (JaxSpill, JaxDoc) if writer == "jax" else (SpillDocStore, StoredDoc)
    r_cls = SpillDocStore if reader == "port" else JaxSpill
    wrote = _script(w_cls, doc_cls, tmp_path / "s")
    got = r_cls.load(str(tmp_path / "s"))
    assert len(got) == len(wrote) == 13
    for doc in wrote:
        other = got.get(doc.doc_id)
        assert (other.content, other.meta) == (doc.content, doc.meta)
        assert got.row_of(doc.doc_id) == wrote.row_of(doc.doc_id)
    assert got.get("doc8") is None and got.get("doc3").content == "gen2 doc3"
    assert got.id_for_row(40) == "after"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spill_store_directory_loads_across_packages(tmp_path, writer):
    """A whole `index.docstore: spill` store saved by one package serves in
    the other: the same docs, rows and nearest neighbours."""
    rng = np.random.default_rng(2)
    data_dir = str(tmp_path / "idx")
    kw = dict(dim=32, initial_capacity=64, data_dir=data_dir, docstore="spill",
              docstore_cache_docs=4)
    jcfg, tcfg = JaxIndexConfig(**kw), IndexConfig(**kw)
    embs = rng.standard_normal((10, 32)).astype(np.float32)
    docs = [(f"text number {i}", {"i": i}, embs[i]) for i in range(10)]
    if writer == "jax":
        src = JaxStore(dim=32, index_config=jcfg)
        ids = src.upsert_batch(docs)
        src.save(data_dir)
        loaded = TpuVectorStore.load(data_dir, index_config=tcfg, device="cpu")
    else:
        src = TpuVectorStore(dim=32, index_config=tcfg, device="cpu")
        ids = src.upsert_batch(docs)
        src.save(data_dir)
        loaded = JaxStore.load(data_dir, index_config=jcfg)
    assert (tmp_path / "idx" / "docs_spill" / "manifest.json").is_file()
    assert type(loaded.docstore).__name__ == "SpillDocStore"
    assert loaded.count_documents() == 10
    assert [loaded.row_of(i) for i in ids] == [src.row_of(i) for i in ids]
    for i in (0, 3, 9):
        hit = loaded.retrieve_by_embedding(embs[i], top_k=1)
        assert hit and hit[0][0].content == f"text number {i}"
