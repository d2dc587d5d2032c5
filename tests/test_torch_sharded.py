"""Parity of the port's corpus-sharded index and pod store with the JAX
package (CPU): `parallel/sharded_index.py` and `parallel/sharded_store.py`
on 8 logical `cpu` shards against the JAX package on the 8 virtual CPU
devices of tests/conftest.py, the same numpy-seeded inputs through both.

Tolerance: tests/_torch_parity.py (exact rows, scores rtol 1e-5 / atol
1e-6). The binary dense leg follows the rule of tests/test_torch_binary.py
per shard: a row may differ only where its stage-1 score ties its shard's
kc-th stage-1 score (`assert_sharded_binary_rows_match`). The pod's merged
legs break score ties by a stable order (base before delta, then rank),
where the JAX package's `np.argsort` is not stable: the data here is
tie-free there, and `test_merge_leg_tie_order` states the port's rule.
"""

import numpy as np
import pytest
import torch

from radiant_rag_tpu.config import IndexConfig as JaxIndexConfig
from radiant_rag_tpu.index.bm25 import BM25Index as JaxBM25
from radiant_rag_tpu.index.store import TpuVectorStore as JaxStore
from radiant_rag_tpu.parallel.mesh import create_mesh as jax_create_mesh
from radiant_rag_tpu.parallel.sharded_index import ShardedFlatIndex as JaxFlat
from radiant_rag_tpu.parallel.sharded_index import ShardedHybridIndex as JaxHybrid
from radiant_rag_tpu.parallel.sharded_store import ShardedVectorStore as JaxPod
from radiant_rag_tpu_torch.config import IndexConfig
from radiant_rag_tpu_torch.index.bm25 import BM25Index
from radiant_rag_tpu_torch.index.store import TpuVectorStore
from radiant_rag_tpu_torch.ops import quantize as qz
from radiant_rag_tpu_torch.parallel.mesh import create_mesh, mesh_info
from radiant_rag_tpu_torch.parallel.sharded_index import ShardedFlatIndex, ShardedHybridIndex
from radiant_rag_tpu_torch.parallel.sharded_store import ShardedVectorStore, _host_fuse

from _torch_parity import assert_result_match, assert_rows_match

CPU8 = ["cpu"] * 8


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _meshes(data, model):
    return jax_create_mesh(data=data, model=model), create_mesh(data, model, devices=CPU8)


def _raw(vecs, queries):
    """(B, N) stage-1 raw scores 32 W - 2 * Hamming of the sign words."""
    c = qz.pack_binary(torch.from_numpy(vecs)).numpy().view(np.uint32)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    q = qz.pack_binary(torch.from_numpy(qn)).numpy().view(np.uint32)
    x = np.bitwise_xor(q[:, None, :], c[None, :, :])
    h = np.unpackbits(x.view(np.uint8), axis=-1).reshape(x.shape[0], x.shape[1], -1).sum(-1)
    return 32 * c.shape[1] - 2 * h.astype(np.int64)


def assert_sharded_binary_rows_match(ref, got, raw, valid, kc, rps, what=""):
    """Per query: every returned row scores at least its own shard's kc-th
    stage-1 score; the rows strictly above it come in the same order with
    the same scores in both results, one list a prefix of the other."""
    (rs, rr), (gs, gr) = ref, got
    n = raw.shape[1]
    for q in range(rr.shape[0]):
        kth = {}
        for s in range(-(-n // rps)):
            live = np.sort(raw[q, s * rps:(s + 1) * rps][valid[s * rps:(s + 1) * rps]])[::-1]
            kth[s] = None if kc >= len(live) else live[kc - 1]

        def strict(rows):
            return [i for i, x in enumerate(rows)
                    if x >= 0 and (kth[x // rps] is None or raw[q, x] > kth[x // rps])]

        for row in set(rr[q][rr[q] >= 0]) | set(gr[q][gr[q] >= 0]):
            t = kth[row // rps]
            assert t is None or raw[q, row] >= t, (what, q, row)
        fr, fg = strict(rr[q]), strict(gr[q])
        p = min(len(fr), len(fg))
        assert_rows_match(rr[q][fr[:p]][None], rs[q][fr[:p]][None], gr[q][fg[:p]][None],
                          gs[q][fg[:p]][None], f"{what} q{q}")


def test_create_mesh_shapes_and_logical_shards():
    mesh = create_mesh(data=4, model=2, devices=CPU8)
    assert mesh_info(mesh) == {"data": 4, "model": 2}
    assert len(mesh.shards) == 8 and mesh.first == torch.device("cpu")
    assert mesh_info(create_mesh(devices=CPU8)) == {"data": 8, "model": 1}
    with pytest.raises(ValueError, match="needs 8 devices"):
        create_mesh(data=8, model=1, devices=CPU8[:4])


def test_sharded_search_matches_jax():
    rng = np.random.default_rng(1)
    jm, tm = _meshes(4, 2)
    n, d = 600, 64
    vecs = _unit(rng, n, d)
    queries = vecs[17:21] + 0.05 * rng.standard_normal((4, d)).astype(np.float32)
    ref_idx, got_idx = JaxFlat(jm, vecs), ShardedFlatIndex(tm, vecs)
    assert got_idx.rows_per_shard == ref_idx.rows_per_shard == 128
    ref, got = ref_idx.search(queries, k=10, mode="exact"), got_idx.search(queries, k=10,
                                                                          mode="exact")
    assert_rows_match(ref[1], ref[0], got[1], got[0], "exact")
    oracle = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ vecs.T
    np.testing.assert_array_equal(got[1], np.argsort(-oracle, axis=1)[:, :10])
    ref, got = ref_idx.search(queries, k=10), got_idx.search(queries, k=10)
    assert_sharded_binary_rows_match(ref, got, _raw(vecs, queries), np.ones(n, bool), 40, 128,
                                     "binary")


def test_sharded_search_masks_padding():
    rng = np.random.default_rng(2)
    jm, tm = _meshes(8, 1)
    vecs = _unit(rng, 130, 32)  # 130 rows over 8 shards of 128: heavy padding
    ref = JaxFlat(jm, vecs).search(vecs[:3], k=5, mode="exact")
    got = ShardedFlatIndex(tm, vecs).search(vecs[:3], k=5, mode="exact")
    assert got[1].max() < 130 and all(got[1][i, 0] == i for i in range(3))
    assert_rows_match(ref[1], ref[0], got[1], got[0], "padding")


def _hybrid_pair(n=700, d=64, sketch_dim=256, seed=3):
    rng = np.random.default_rng(seed)
    vecs = _unit(rng, n, d)
    texts = [f"token{i % 37} shared{i % 5} word{i}" for i in range(n)]
    jb, tb = JaxBM25(sketch_dim=sketch_dim), BM25Index(sketch_dim=sketch_dim, device="cpu")
    jb.bulk_build(list(range(n)), texts)
    tb.bulk_build(list(range(n)), texts)
    return rng, vecs, texts, jb, tb


@pytest.mark.parametrize("fusion", ["equal", "confidence", "score"])
def test_sharded_hybrid_matches_jax(fusion):
    rng, vecs, texts, jb, tb = _hybrid_pair()
    jm, tm = _meshes(4, 2)
    ref_idx, got_idx = JaxHybrid(jm, vecs, jb), ShardedHybridIndex(tm, vecs, tb)
    for idx in (ref_idx, got_idx):
        idx.set_fusion(fusion, [0.3, 0.7])
    queries = vecs[100:104] + 0.1 * rng.standard_normal((4, 64)).astype(np.float32)
    qtexts = ["token7 shared2", "word5", "token0", "shared4 word9"]
    kw = dict(dense_k=5, bm25_k=5, fused_k=8)
    ref = ref_idx.hybrid_search(queries, qtexts, mode="exact", **kw)
    got = got_idx.hybrid_search(queries, qtexts, mode="exact", **kw)
    assert_result_match(ref, got, f"exact {fusion}")
    oracle = queries / np.linalg.norm(queries, axis=1, keepdims=True) @ vecs.T
    np.testing.assert_array_equal(got["dense"][1], np.argsort(-oracle, axis=1)[:, :5])
    assert any("token7" in texts[r] or "shared2" in texts[r] for r in got["bm25"][1][0])
    ref = ref_idx.hybrid_search(queries, qtexts, **kw)
    got = got_idx.hybrid_search(queries, qtexts, **kw)
    assert_sharded_binary_rows_match(ref["dense"], got["dense"], _raw(vecs, queries),
                                     np.ones(len(vecs), bool), 20, got_idx.rows_per_shard,
                                     f"binary {fusion} dense")
    assert_rows_match(ref["bm25"][1], ref["bm25"][0], got["bm25"][1], got["bm25"][0], "bm25")
    if np.array_equal(ref["dense"][1], got["dense"][1]):
        assert_rows_match(ref["fused"][1], ref["fused"][0], got["fused"][1], got["fused"][0],
                          "fused")


def test_shard_body_keeps_the_sketch_candidate_order():
    """Exact-BM25 ties among the candidates go to the one the sketch ranked
    higher, as in the JAX shard body (not to the lowest row, as in the
    row-sorted single-device rescore). Every doc holding "qterm" scores the same
    exact BM25 for it; the 16-bin sketch orders them by the collisions of
    their other term with its bin."""
    n = 64
    texts = [f"{'qterm' if i % 2 == 0 else 'yterm'} x{i}" for i in range(n)]
    vecs = _unit(np.random.default_rng(4), n, 32)
    jb, tb = JaxBM25(sketch_dim=16), BM25Index(sketch_dim=16, device="cpu")
    jb.bulk_build(list(range(n)), texts)
    tb.bulk_build(list(range(n)), texts)
    jm, tm = jax_create_mesh(data=1, model=1), create_mesh(1, 1, devices=["cpu"])
    kw = dict(dense_k=10, bm25_k=10, fused_k=10, mode="exact")
    ref = JaxHybrid(jm, vecs, jb).hybrid_search(vecs[:1], ["qterm"], **kw)
    got = ShardedHybridIndex(tm, vecs, tb).hybrid_search(vecs[:1], ["qterm"], **kw)
    assert_rows_match(ref["bm25"][1], ref["bm25"][0], got["bm25"][1], got["bm25"][0], "bm25")
    live = got["bm25"][1][0] >= 0
    assert live.all() and np.unique(got["bm25"][0]).size == 1  # one exact score: all ties
    row_sorted = tb.search_rows_batch(["qterm"], top_k=10, method="sketch")[1][0]
    assert (row_sorted >= 0).all()
    assert not np.array_equal(got["bm25"][1][0], row_sorted)


def _stores(rng, n, dim, texts, meta_of=lambda i: {"doc_level": "leaf"}, sketch_dim=1024):
    embs = _unit(rng, n, dim)
    cfg = dict(dim=dim, initial_capacity=256)
    jsrc, tsrc = JaxStore(dim=dim, index_config=JaxIndexConfig(**cfg)), \
        TpuVectorStore(dim, IndexConfig(**cfg), device="cpu")
    docs = [(texts[i], meta_of(i), embs[i]) for i in range(n)]
    ids = jsrc.upsert_batch(docs)
    assert tsrc.upsert_batch(docs) == ids
    return embs, ids, jsrc, tsrc


def _bm25s(jsrc, tsrc, ids, sketch_dim=1024):
    jb, tb = JaxBM25(sketch_dim=sketch_dim), BM25Index(sketch_dim=sketch_dim, device="cpu")
    live = [i for i in ids if jsrc.row_of(i) is not None]
    for b, src in ((jb, jsrc), (tb, tsrc)):
        b.bulk_build([src.row_of(i) for i in live], [src.get_doc(i).content for i in live])
    return jb, tb


def _doc_ids(hits):
    return [[d.doc_id for d, _ in run] for run in hits]


def _same_hits(ref, got, what=""):
    assert _doc_ids(ref) == _doc_ids(got), what
    for a, b in zip(ref, got):
        np.testing.assert_allclose([s for _, s in b], [s for _, s in a], rtol=1e-5, atol=1e-6,
                                   err_msg=what)


def test_sharded_vector_store_serving_matches_jax():
    rng = np.random.default_rng(5)
    texts = [f"token{i % 23} shared word{i}" for i in range(200)]
    embs, ids, jsrc, tsrc = _stores(
        rng, 200, 32, texts, lambda i: {"doc_level": "leaf" if i % 4 else "parent",
                                        "source": f"s{i}"})
    for src in (jsrc, tsrc):
        src.delete_doc(ids[7])
    jb, tb = _bm25s(jsrc, tsrc, ids, sketch_dim=256)
    jm, tm = _meshes(4, 2)
    ref, got = JaxPod(jm, jsrc, bm25_index=jb), ShardedVectorStore(tm, tsrc, bm25_index=tb)
    q = embs[20:23]
    for kw in (dict(quantized=False), dict(quantized=False, doc_level_filter="leaf"), {}):
        r = ref.retrieve_by_embedding_batch(q, top_k=5, min_similarity=-1.0, **kw)
        g = got.retrieve_by_embedding_batch(q, top_k=5, min_similarity=-1.0, **kw)
        if kw:
            _same_hits(r, g, str(kw))
        assert all(ids[7] not in run for run in _doc_ids(g))
    want = tsrc.retrieve_by_embedding_batch(q, top_k=5, min_similarity=-1.0, quantized=False)
    assert _doc_ids(got.retrieve_by_embedding_batch(q, top_k=5, min_similarity=-1.0,
                                                    quantized=False)) == _doc_ids(want)
    leaves = got.retrieve_by_embedding_batch(q[:1], top_k=10, min_similarity=-1.0,
                                             doc_level_filter="leaf")[0]
    assert leaves and all(d.doc_level == "leaf" for d, _ in leaves)
    r = ref.search_hybrid(q[:1], ["token3 shared"], top_k=5)
    g = got.search_hybrid(q[:1], ["token3 shared"], top_k=5)
    if _doc_ids(r) == _doc_ids(g):
        _same_hits(r, g, "hybrid")
    assert any("token3" in d.content or "shared" in d.content for d, _ in g[0])
    new = ("brand new doc about qq17", {"doc_level": "leaf"}, rng.standard_normal(32))
    for src, pod in ((jsrc, ref), (tsrc, got)):
        src.upsert_batch([new])
        pod.refresh()
    assert got.count_documents() == ref.count_documents() == tsrc.count_documents()
    info = got.get_index_info()
    assert info["backend"] == "tpu-sharded" and info["mesh"] == {"data": 4, "model": 2}
    assert info["rows_per_shard"] == ref.get_index_info()["rows_per_shard"]


def _pod_pair(seed, n, rebase, sketch_dim=1024, texts=None):
    rng = np.random.default_rng(seed)
    texts = texts or [f"base doc {i} with marker base{i}" for i in range(n)]
    embs, ids, jsrc, tsrc = _stores(rng, n, 32, texts)
    jb, tb = _bm25s(jsrc, tsrc, ids, sketch_dim)
    jm, tm = _meshes(4, 2)
    ref = JaxPod(jm, jsrc, bm25_index=jb, delta_rebase_fraction=rebase)
    got = ShardedVectorStore(tm, tsrc, bm25_index=tb, delta_rebase_fraction=rebase)
    return rng, embs, ids, ref, got


def _hybrid_equal(ref, got, q, qtexts, top_k=5, fused_depth=40):
    """The pod's dense leg is always binary; at fused depth 40 its stage 1
    (kc = 160) takes every live row of a 128-row shard, so no stage-1 tie
    can differ and the legs compare exactly."""
    kw = dict(top_k=top_k, return_legs=True, fused_depth=fused_depth)
    r, g = ref.search_hybrid(q, qtexts, **kw), got.search_hybrid(q, qtexts, **kw)
    for leg in ("dense", "bm25", "fused"):
        _same_hits(r[leg], g[leg], leg)
    return g


def test_sharded_store_delta_tombstones_and_rebase_match_jax():
    """Appends while serving land in the delta segment (no re-shard),
    deletes tombstone base rows or drop delta rows, and crossing the rebase
    fraction folds the delta into a fresh base: the same results as the
    JAX pod store at every step (exact dense mode; the hybrid legs)."""
    rng, embs, ids, ref, got = _pod_pair(6, 120, 0.5)
    base_rows = got._base_rows
    new_embs = _unit(rng, 8, 32)
    new_docs = [(f"fresh doc {i} with rare term zzfresh{i}", {"doc_level": "leaf"},
                 new_embs[i]) for i in range(8)]
    new_ids = ref.upsert_batch(new_docs)
    assert got.upsert_batch(new_docs) == new_ids
    assert got._base_rows == base_rows and got.delta_size == ref.delta_size == 8
    assert got.count_documents() == 128

    def dense(q):
        kw = dict(top_k=5, min_similarity=-1.0, quantized=False)
        r, g = ref.retrieve_by_embedding_batch(q, **kw), got.retrieve_by_embedding_batch(q, **kw)
        _same_hits(r, g, "dense")
        return _doc_ids(g)

    assert new_ids[0] in dense(new_embs[:2])[0]
    g = _hybrid_equal(ref, got, new_embs[2:3], ["zzfresh2"])
    assert new_ids[2] in _doc_ids(g["fused"])[0]
    _hybrid_equal(ref, got, embs[10:14], ["base10", "zzfresh3", "base11 zzfresh5", "base13 base12"],
                  top_k=12)
    for pod in (ref, got):
        pod.delete_doc(ids[5])  # a base row: tombstoned
    assert got._tombstones == {5} and got._base_rows == base_rows
    assert ids[5] not in dense(embs[5:6])[0]
    _hybrid_equal(ref, got, embs[5:7], ["base5", "base6 zzfresh1"])
    for pod in (ref, got):
        pod.delete_doc(new_ids[0])  # a delta row: dropped from the delta
    assert new_ids[0] not in dense(new_embs[:1])[0]
    many = _unit(rng, 70, 32)
    bulk = [(f"bulk doc {i} term qbulk{i}", {"doc_level": "leaf"}, many[i]) for i in range(70)]
    more_ids = ref.upsert_batch(bulk)
    assert got.upsert_batch(bulk) == more_ids
    assert got._base_rows == ref._base_rows > base_rows  # rebased
    assert got.delta_size == 0 and not got._tombstones
    assert more_ids[10] in dense(many[10:11])[0]
    g = _hybrid_equal(ref, got, new_embs[3:4], ["zzfresh3"])
    assert new_ids[3] in _doc_ids(g["fused"])[0]


def test_sharded_fusion_carries_calibration_matches_jax():
    """set_fusion reaches the device fusion (pure base) and the host fusion
    (base + delta), survives refresh, and score mode runs on both."""
    texts = [f"unique{i} subject{i % 7} verb{i % 11}" for i in range(96)]
    rng, embs, ids, ref, got = _pod_pair(7, 96, 0.9, sketch_dim=256, texts=texts)
    for pod in (ref, got):
        pod.set_fusion("confidence", [0.005, 0.995])
    q = _unit(rng, 1, 32)
    g = _hybrid_equal(ref, got, q, ["unique5 subject5"])
    assert _doc_ids(g["fused"])[0][0] == ids[5]
    new = [("delta doc rare zzdelta0", {"doc_level": "leaf"}, _unit(rng, 1, 32)[0])]
    for pod in (ref, got):
        pod.upsert_batch(new)
    assert got.delta_size == 1
    g = _hybrid_equal(ref, got, q, ["unique5 subject5"])
    assert _doc_ids(g["fused"])[0][0] == ids[5]
    for pod in (ref, got):
        pod.refresh()
    assert got._hybrid.fusion_mode == "confidence"
    g = _hybrid_equal(ref, got, q, ["unique7 subject0"])
    assert _doc_ids(g["fused"])[0][0] == ids[7]
    for pod in (ref, got):
        pod.set_fusion("score", [0.3, 0.7])
    g = _hybrid_equal(ref, got, q, ["unique9 subject2"])
    assert ids[9] in _doc_ids(g["fused"])[0]


def test_merge_leg_tie_order():
    """The port's merge of base and delta: score descending, ties in the
    order of the concatenated runs (base first, each in rank order); a
    tombstoned base row keeps its slot at (-inf, -1) when the delta is
    empty (as in the JAX package)."""
    pod = ShardedVectorStore.__new__(ShardedVectorStore)
    pod._tombstones = {3}
    base = (np.asarray([[0.9, 0.5, 0.5, 0.2]], np.float32), np.asarray([[3, 1, 2, 4]]))
    delta = (np.asarray([[0.5, 0.1]], np.float32), np.asarray([[9, 8]]))
    s, r = pod._merge_leg(base, delta, 4)
    np.testing.assert_array_equal(r, [[1, 2, 9, 4]])
    np.testing.assert_array_equal(s, np.asarray([[0.5, 0.5, 0.5, 0.2]], np.float32))
    s, r = pod._merge_leg(base, None, 3)
    np.testing.assert_array_equal(r, [[-1, 1, 2]])
    assert s[0, 0] == -np.inf


@pytest.mark.parametrize("fusion", ["equal", "confidence", "score"])
def test_host_fuse_matches_jax(fusion):
    from radiant_rag_tpu.parallel.sharded_store import _host_fuse as jax_host_fuse

    rng = np.random.default_rng(8)
    d = (np.sort(rng.random((3, 6)).astype(np.float32))[:, ::-1].copy(),
         rng.integers(-1, 20, (3, 6)))
    b = (np.sort(rng.random((3, 5)).astype(np.float32) * 9)[:, ::-1].copy(),
         rng.integers(-1, 20, (3, 5)))
    w = np.asarray([0.3, 0.7], np.float32)
    ref, got = jax_host_fuse(d, b, 7, 60, fusion, w), _host_fuse(d, b, 7, 60, fusion, w)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
