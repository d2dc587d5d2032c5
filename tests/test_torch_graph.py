"""Parity of the port's graph engine (`radiant_rag_tpu_torch/index/graph.py`
and its engine and store wiring) with the JAX package's, on the CPU: each
case of tests/test_graph.py runs the JAX function and the port's on the
same seeded numpy inputs, asserts the JAX test's own property on the port,
and holds the port to the JAX package.

Tolerance.
  - Builds (exact, NN-descent, polish, insertion): a row's edges may differ
    from the JAX package's only at near-ties: where the two adjacencies
    disagree, the two neighbours' float64 cosines to the row differ by at
    most 1e-6 (over the bf16-rounded vectors where the program scores bf16
    operands: descent and polish). That admits reordered ties and a tie
    swapped across the degree boundary, nothing else; the two frameworks
    sum the same f32 products in different orders. Long-range edges are
    equal (the same RNG draws).
  - A descent of several rounds feeds each round's adjacency to the next,
    so one near-tie swapped in round t changes another row's candidates in
    round t + 1: there up to 0.1% of rows may differ beyond a near-tie
    (`CASCADE_SHARE`); the one-round and polish cases allow none.
  - Beam search over the same graph: rows equal and scores within rtol
    1e-5 / atol 1e-6 (tests/_torch_parity.py).

The JAX reference runs with host arrays copied on upload
(`_jax_uploads_copy`): on the CPU backend `jnp.asarray` of a numpy array
may alias it, and `nn_descent_graph` rewrites its host adjacency in place
while queued blocks still read the aliased upload, so two runs of the JAX
function disagree on a few percent of edges (measured: 3.7% at 3,000 rows).
A device upload copies on a TPU, which is the semantics the copy restores.
"""

import logging
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiant_rag_tpu import config as jcfg
from radiant_rag_tpu.index import graph as jg
from radiant_rag_tpu.index.engine import DeviceVectorIndex as JaxEngine
from radiant_rag_tpu.index.store import TpuVectorStore as JaxStore
from radiant_rag_tpu_torch import config as tcfg
from radiant_rag_tpu_torch.index import graph as tg
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
from radiant_rag_tpu_torch.index.store import TpuVectorStore

from _torch_parity import assert_edges_match, assert_rows_match

CASCADE_SHARE = 1e-3


class _CopyingJnp(types.ModuleType):
    """jax.numpy with `asarray` copying numpy input (module doc)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x, *args, **kwargs):
        if isinstance(x, np.ndarray):
            x = x.copy()
        return jnp.asarray(x, *args, **kwargs)


@pytest.fixture(autouse=True)
def _jax_uploads_copy(monkeypatch):
    monkeypatch.setattr(jg, "jnp", _CopyingJnp("jax.numpy"))


def _corpus(seed, n, d):
    """tests/test_graph.py's clustered corpus, from its own seed."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32)
    v = centers[rng.integers(0, 16, n)] + 0.4 * rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _pair_index(**kw):
    return jg.GraphIndex(**kw), tg.GraphIndex(device="cpu", **kw)


def _carry(jgi, tgi):
    """The JAX index's graph state into the port's (search parity over one
    graph)."""
    tgi.neighbors = torch.from_numpy(np.array(jgi.neighbors))
    tgi.entry_points = torch.from_numpy(np.array(jgi.entry_points))
    tgi.entry_sample_rows = torch.from_numpy(np.array(jgi.entry_sample_rows))
    tgi.entry_sample_vecs = torch.from_numpy(np.array(jgi.entry_sample_vecs))


def _recall(rows, queries, vecs):
    sims = queries @ vecs.T
    return float(np.mean([len(set(int(x) for x in rows[q] if x >= 0)
                              & set(np.argsort(-sims[q])[:10])) / 10
                          for q in range(len(queries))]))


def _search_both(jgi, tgi, vecs, queries, k, ef, mask=None, what=""):
    js, ji = jgi.search(jnp.asarray(vecs), queries, k=k, ef=ef,
                        mask=None if mask is None else jnp.asarray(mask))
    ts, ti = tgi.search(torch.from_numpy(vecs), queries, k=k, ef=ef,
                        mask=None if mask is None else torch.from_numpy(mask))
    assert ti.dtype == np.int64 and ts.dtype == np.float32
    assert_rows_match(ji, js, ti, ts, what)
    np.testing.assert_array_equal(ji, ti, err_msg=what)
    return ts, ti


# -- counterparts of tests/test_graph.py ----------------------------------------


def test_knn_graph_edges_are_nearest():
    vecs = _corpus(1, 500, 32)
    ref = jg.build_knn_graph(vecs, degree=8, n_long_edges=2, block=256)
    adj = tg.build_knn_graph(vecs, degree=8, n_long_edges=2, block=256, device="cpu")
    assert adj.shape == (500, 10) and adj.dtype == np.int32
    sims = vecs @ vecs.T
    np.fill_diagonal(sims, -2)
    for row in (0, 123, 499):
        assert len(set(adj[row, :8]) & set(np.argsort(-sims[row])[:8])) >= 7
        assert row not in set(adj[row, :8])
    assert_edges_match(ref, adj, vecs, 8, what="exact build")
    # a device-resident corpus builds the same graph as a host array
    np.testing.assert_array_equal(
        tg.build_knn_graph(torch.from_numpy(vecs), degree=8, n_long_edges=2, block=256), adj)


def test_graph_search_recall():
    n, d = 2000, 48
    vecs = _corpus(2, n, d)
    jgi, tgi = _pair_index(degree=16, n_long_edges=4, n_entry_points=16, steps=8)
    jgi.build(vecs)
    tgi.build(vecs)
    assert_edges_match(jgi.neighbors, tgi.neighbors.numpy(), vecs, 16, what="build")
    np.testing.assert_array_equal(np.asarray(jgi.entry_points), tgi.entry_points.numpy())
    np.testing.assert_array_equal(np.asarray(jgi.entry_sample_rows),
                                  tgi.entry_sample_rows.numpy())
    queries = _corpus(3, 16, d)
    s, i = tgi.search(torch.from_numpy(vecs), queries, k=10, ef=64)
    assert _recall(i, queries, vecs) >= 0.85
    sims = queries @ vecs.T
    for qi in range(3):
        for x, sc in zip(i[qi], s[qi]):
            if x >= 0:
                np.testing.assert_allclose(sc, sims[qi, int(x)], rtol=1e-4)
    _carry(jgi, tgi)
    _search_both(jgi, tgi, vecs, queries, 10, 64, what="recall search")


def test_graph_search_respects_mask():
    n, d = 400, 32
    vecs = _corpus(4, n, d)
    jgi, tgi = _pair_index(degree=8, steps=6)
    jgi.build(vecs)
    tgi.build(vecs)
    assert_edges_match(jgi.neighbors, tgi.neighbors.numpy(), vecs, 8, what="build")
    mask = np.ones(n, bool)
    mask[:50] = False
    _carry(jgi, tgi)
    _, i = _search_both(jgi, tgi, vecs, vecs[:4], 10, 32, mask, "masked search")
    assert not ({int(x) for row in i for x in row if x >= 0} & set(range(50)))


def _store_pair(degree=8):
    kw = dict(dim=32, initial_capacity=256, use_graph=True, graph_degree=degree)
    return (JaxStore(dim=32, index_config=jcfg.IndexConfig(**kw)),
            TpuVectorStore(dim=32, index_config=tcfg.IndexConfig(**kw), device="cpu"))


def _hits_match(ref, got, what):
    assert [d.content for d, _ in ref] == [d.content for d, _ in got], what
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], rtol=1e-5,
                               atol=1e-6, err_msg=what)


def test_store_graph_mode():
    rng = np.random.default_rng(5)
    js, ts = _store_pair()
    docs = [(f"doc {i}", {}, rng.standard_normal(32)) for i in range(150)]
    for st in (js, ts):
        st.upsert_batch(docs)
        assert st._default_mode() != "graph"  # not built yet -> flat
        st.build_graph()
        assert st._default_mode() == "graph"
    assert ts.engine.graph.degree == 8 and ts.get_index_info()["default_mode"] == "graph"
    q = np.asarray(docs[42][2])
    hits = ts.retrieve_by_embedding(q, top_k=5)
    assert hits and hits[0][0].content == "doc 42"
    _hits_match(js.retrieve_by_embedding(q, top_k=5), hits, "graph mode")
    # deletes respected through the graph's mask
    for st in (js, ts):
        st.delete_doc(hits[0][0].doc_id)
    hits2 = ts.retrieve_by_embedding(q, top_k=5)
    assert all(d.content != "doc 42" for d, _ in hits2)
    _hits_match(js.retrieve_by_embedding(q, top_k=5), hits2, "after the delete")


@pytest.mark.parametrize("ef", [16, 64, 128])
def test_graph_search_ef_improves_recall(ef):
    n, d = 1500, 32
    vecs = _corpus(6, n, d)
    jgi, tgi = _pair_index(degree=8, n_long_edges=2, steps=6)
    jgi.build(vecs)
    tgi.build(vecs)
    assert_edges_match(jgi.neighbors, tgi.neighbors.numpy(), vecs, 8, what="build")
    queries = _corpus(7, 24, d)
    r_small = _recall(tgi.search(torch.from_numpy(vecs), queries, k=10, ef=8)[1], queries, vecs)
    r_big = _recall(tgi.search(torch.from_numpy(vecs), queries, k=10, ef=96)[1], queries, vecs)
    assert r_big >= r_small and r_big >= 0.85
    _carry(jgi, tgi)
    _search_both(jgi, tgi, vecs, queries, 10, ef, what=f"ef {ef}")


def test_graph_build_excludes_invalid_rows():
    n, d = 600, 32
    vecs = _corpus(8, n, d)
    valid = np.ones(n, bool)
    valid[100:200] = False
    jgi, tgi = _pair_index(degree=8, steps=6)
    jgi.build(vecs, valid=valid)
    tgi.build(vecs, valid=valid)
    adj = tgi.neighbors.numpy()[:, :8]
    dead = set(range(100, 200))
    assert sum(len(set(adj[r]) & dead) for r in np.nonzero(valid)[0][:50]) == 0
    assert not ({int(x) for x in tgi.entry_points.numpy()} & dead)
    assert_edges_match(jgi.neighbors, tgi.neighbors.numpy(), vecs, 8, what="valid build")
    np.testing.assert_array_equal(np.asarray(jgi.entry_points), tgi.entry_points.numpy())


def test_graph_search_k_exceeds_matches():
    n, d = 300, 32
    vecs = _corpus(9, n, d)
    jgi, tgi = _pair_index(degree=8, steps=4)
    jgi.build(vecs)
    tgi.build(vecs)
    mask = np.zeros(n, bool)
    mask[:5] = True  # only 5 valid docs
    _carry(jgi, tgi)
    _, i = _search_both(jgi, tgi, vecs, vecs[:2], 10, 32, mask, "k > matches")
    for row in i:
        assert {int(x) for x in row if x >= 0} <= set(range(5))
    assert (i >= -1).all() and (i == -1).any()


def test_store_graph_auto_extends_after_growth():
    rng = np.random.default_rng(10)
    js, ts = _store_pair()
    docs = [(f"doc {i}", {}, rng.standard_normal(32)) for i in range(120)]
    more = [(f"late doc {i}", {}, rng.standard_normal(32)) for i in range(30)]
    q = np.asarray(more[7][2])
    for st in (js, ts):
        st.upsert_batch(docs)
        st.build_graph()
        st.upsert_batch(more)
        assert st.engine.graph.built_rows == 120  # stale until the next search
    hits = ts.retrieve_by_embedding(q, top_k=3)
    assert ts.engine.graph.built_rows == 150 and ts.engine.graph.stale_fraction == 30 / 150
    assert hits and hits[0][0].content == "late doc 7"
    _hits_match(js.retrieve_by_embedding(q, top_k=3), hits, "auto-extended")
    assert_edges_match(js.engine.graph.neighbors, ts.engine.graph.neighbors.numpy(),
                       ts.engine.vecs.numpy(), 8, what="inserted graph")


def test_graph_incremental_add_recall():
    n0, n1, d = 2000, 500, 48
    vecs = _corpus(11, n0 + n1, d)
    jgi, tgi = _pair_index(degree=16, n_long_edges=4, n_entry_points=16, steps=8)
    jgi.build(vecs[:n0])
    tgi.build(vecs[:n0])
    jgi.add(vecs, n0, n1)
    tgi.add(torch.from_numpy(vecs), n0, n1)
    assert tgi.built_rows == n0 + n1 and 0.0 < tgi.stale_fraction < 0.3
    assert_edges_match(np.asarray(jgi.neighbors)[:n0 + n1], tgi.neighbors.numpy()[:n0 + n1],
                       vecs, 16, what="incremental add")
    np.testing.assert_array_equal(np.asarray(jgi.entry_sample_rows),
                                  tgi.entry_sample_rows.numpy())
    full = tg.GraphIndex(degree=16, n_long_edges=4, n_entry_points=16, steps=8, device="cpu")
    full.build(vecs)
    rng = np.random.default_rng(12)
    q = vecs[n0:n0 + 32] + 0.1 * rng.standard_normal((32, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    r_inc = _recall(tgi.search(torch.from_numpy(vecs), q, k=10, ef=96)[1], q, vecs)
    r_full = _recall(full.search(torch.from_numpy(vecs), q, k=10, ef=96)[1], q, vecs)
    assert r_inc >= 0.8 and r_inc >= r_full - 0.1, (r_inc, r_full)
    _carry(jgi, tgi)
    _search_both(jgi, tgi, vecs, q, 10, 96, what="after the add")


def test_graph_incremental_back_edges():
    n0, d = 400, 32
    vecs0 = _corpus(13, n0, d)
    rng = np.random.default_rng(14)
    new = vecs0[:20] + 0.01 * rng.standard_normal((20, d)).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    allv = np.concatenate([vecs0, new])
    jgi, tgi = _pair_index(degree=8, n_long_edges=2, steps=6)
    jgi.build(vecs0)
    tgi.build(vecs0)
    jgi.add(allv, n0, 20)
    tgi.add(allv, n0, 20)  # a host array goes to the index's device
    adj = tgi.neighbors.numpy()
    assert sum(1 for r in range(20) if (adj[r, :8] >= n0).any()) >= 15
    assert sum(1 for j in range(20) if j in set(adj[n0 + j, :8])) >= 15
    assert_edges_match(np.asarray(jgi.neighbors)[:n0 + 20], adj[:n0 + 20], allv, 8,
                       what="back-edges")
    assert adj.shape == np.asarray(jgi.neighbors).shape and (adj[n0 + 20:] == -1).all()


def test_graph_incremental_respects_invalid_rows():
    n0, n1, d = 300, 60, 32
    vecs = _corpus(15, n0 + n1, d)
    valid = np.ones(n0 + n1, bool)
    valid[50:100] = False
    jgi, tgi = _pair_index(degree=8, n_long_edges=2, steps=6)
    jgi.build(vecs[:n0], valid=valid[:n0])
    tgi.build(vecs[:n0], valid=valid[:n0])
    jgi.add(vecs, n0, n1, valid=valid)
    tgi.add(torch.from_numpy(vecs), n0, n1, valid=valid)
    adj = tgi.neighbors.numpy()[n0:n0 + n1, :8]
    assert not (set(adj.reshape(-1).tolist()) & set(range(50, 100)))
    assert_edges_match(np.asarray(jgi.neighbors)[:n0 + n1], tgi.neighbors.numpy()[:n0 + n1],
                       vecs, 8, what="add with invalid rows")


def _engines(d=32, **kw):
    return JaxEngine(d, initial_capacity=256, **kw), \
        DeviceVectorIndex(d, initial_capacity=256, device="cpu", **kw)


def _append(engs, v):
    n = v.shape[0]
    for eng in engs:
        eng.append(v, np.zeros(n, np.int8), np.zeros(n, np.int32), np.full(n, 10, np.float32))


def test_engine_extend_graph_rebuilds_past_threshold():
    engs = _engines()
    _append(engs, _corpus(16, 80, 32))
    for eng in engs:
        eng.build_graph(degree=8)
        assert eng.graph.built_rows == 80
    _append(engs, _corpus(17, 20, 32))  # small growth -> incremental
    for eng in engs:
        eng.extend_graph()
        assert eng.graph.built_rows == 100 and eng.graph.stale_fraction > 0
    _append(engs, _corpus(18, 200, 32))  # large growth -> full rebuild
    for eng in engs:
        eng.extend_graph()
        assert eng.graph.built_rows == 300 and eng.graph.stale_fraction == 0.0
    j, t = engs
    assert_edges_match(np.asarray(j.graph.neighbors), t.graph.neighbors.numpy(),
                       t.vecs[:300].numpy(), 8, what="rebuilt graph")


def test_nn_descent_edges_near_exact():
    n, d = 3000, 48
    vecs = _corpus(19, n, d)
    ref = jg.nn_descent_graph(vecs, degree=8, n_long_edges=0, iters=10, block=1024, seed=0)
    approx = tg.nn_descent_graph(vecs, degree=8, n_long_edges=0, iters=10, block=1024, seed=0,
                                 device="cpu")
    exact = tg.build_knn_graph(vecs, degree=8, n_long_edges=0, block=1024, device="cpu")
    agree = np.mean([len(set(approx[i]) & set(exact[i])) / 8 for i in range(0, n, 7)])
    assert agree >= 0.85, agree
    assert_edges_match(ref, approx, vecs, 8, bf16=True, cascade_rows=int(CASCADE_SHARE * n),
                       what="10 rounds + polish")


def test_nn_descent_search_recall_matches_exact_build():
    n, d = 2000, 48
    vecs = _corpus(20, n, d)
    jnd, tnd = _pair_index(degree=16, n_long_edges=4, n_entry_points=16, steps=8)
    jnd.build(vecs, method="nn_descent")
    tnd.build(vecs, method="nn_descent")
    assert_edges_match(jnd.neighbors, tnd.neighbors.numpy(), vecs, 16, bf16=True,
                       cascade_rows=int(CASCADE_SHARE * n), what="nn_descent build")
    tex = tg.GraphIndex(degree=16, n_long_edges=4, n_entry_points=16, steps=8, device="cpu")
    tex.build(vecs, method="exact")
    queries = _corpus(21, 16, d)
    r_nd = _recall(tnd.search(torch.from_numpy(vecs), queries, k=10, ef=64)[1], queries, vecs)
    r_ex = _recall(tex.search(torch.from_numpy(vecs), queries, k=10, ef=64)[1], queries, vecs)
    assert r_nd >= r_ex - 0.05 and r_nd >= 0.8, (r_nd, r_ex)


def test_nn_descent_respects_invalid_rows():
    n, d = 800, 32
    vecs = _corpus(22, n, d)
    valid = np.ones(n, bool)
    valid[200:300] = False
    ref = jg.nn_descent_graph(vecs, degree=8, n_long_edges=2, iters=6, block=256, valid=valid)
    adj = tg.nn_descent_graph(vecs, degree=8, n_long_edges=2, iters=6, block=256, valid=valid,
                              device="cpu")
    dead = set(range(200, 300))
    assert sum(len(set(adj[i, :8].tolist()) & dead) for i in np.nonzero(valid)[0][:100]) == 0
    assert_edges_match(ref, adj, vecs, 8, bf16=True, cascade_rows=int(CASCADE_SHARE * n),
                       what="descent with invalid rows")


@pytest.mark.parametrize("polish", [False, True])
def test_cluster_polish_recovers_underconverged_descent(polish):
    """One round, without and with the polish: nothing feeds a near-tie
    forward, so no row may differ beyond one."""
    n, d = 3000, 48
    vecs = _corpus(23, n, d)
    ref = jg.nn_descent_graph(vecs, degree=8, n_long_edges=0, iters=1, block=512, polish=polish)
    got = tg.nn_descent_graph(vecs, degree=8, n_long_edges=0, iters=1, block=512, polish=polish,
                              device="cpu")
    assert_edges_match(ref, got, vecs, 8, bf16=True, what=f"one round, polish {polish}")
    if polish:
        raw = tg.nn_descent_graph(vecs, degree=8, n_long_edges=0, iters=1, block=512,
                                  polish=False, device="cpu")
        sims = vecs[:256] @ vecs.T
        np.fill_diagonal(sims[:, :256], -1)

        def agreement(adj):
            return sum(len(set(np.argsort(-sims[i])[:8]) & {int(x) for x in adj[i] if x >= 0})
                       for i in range(256)) / (256 * 8)

        a_raw, a_pol = agreement(raw), agreement(got)
        assert a_pol > a_raw + 0.1 and a_pol >= 0.8, (a_raw, a_pol)


# -- the port's own pieces against the JAX programs ---------------------------------


def test_cluster_polish_alone_matches_jax():
    """`_cluster_polish` on one adjacency, pool and generator state."""
    n, d, r = 2500, 32, 8
    vecs = _corpus(24, n, d)
    valid = np.ones(n, bool)
    valid[::9] = False
    pool = np.nonzero(valid)[0]
    adj = np.random.default_rng(25).choice(pool, size=(n, r)).astype(np.int32)
    ref = jg._cluster_polish(jnp.asarray(vecs), jnp.asarray(valid), adj.copy(), pool,
                             np.random.default_rng(26), block=512)
    got = tg._cluster_polish(torch.from_numpy(vecs).bfloat16(), torch.from_numpy(valid),
                             adj.copy(), pool, np.random.default_rng(26), block=512)
    assert_edges_match(ref, got, vecs, r, bf16=True, what="polish alone")
    assert not (set(got[valid].reshape(-1).tolist()) & set(np.nonzero(~valid)[0].tolist()))


def test_dedup_by_sort_equals_the_pairwise_mask():
    rng = np.random.default_rng(27)
    ids = rng.integers(-1, 40, (6, 300)).astype(np.int32)
    ids[0] = -1  # a row of pads only
    ids[1, :150] = ids[1, 150:]  # every id twice
    pairwise = ~np.any((ids[:, :, None] == ids[:, None, :])
                       & np.tril(np.ones((300, 300), bool), k=-1)[None], axis=-1)
    np.testing.assert_array_equal(tg.dedup_mask(torch.from_numpy(ids)).numpy(), pairwise)


def test_padded_block_past_n_matches_jax():
    """A block padded past N, as the JAX loops pass it: the rows past N get
    no edges (`jnp.take` fills, the port clamps and masks), the real rows
    their descent edges."""
    n, d, r = 3000, 48, 8
    vecs = _corpus(28, n, d)
    rng = np.random.default_rng(29)
    mask = np.ones(n, bool)
    adj = rng.integers(0, n, (n, r)).astype(np.int32)
    extra = rng.integers(-1, n, (512, 24)).astype(np.int32)
    extra[440:] = -1
    qrows = np.arange(2560, 3072, dtype=np.int32)
    qb = np.zeros((512, d), np.float32)
    qb[:440] = vecs[2560:]
    js, ji = jg._descent_block(jnp.asarray(vecs), jnp.asarray(mask), jnp.asarray(adj),
                               jnp.asarray(qb), jnp.asarray(qrows), jnp.asarray(extra), r)
    ts, ti = tg._descent_block(torch.from_numpy(vecs).bfloat16(), torch.from_numpy(mask),
                               torch.from_numpy(adj), torch.from_numpy(qb),
                               torch.from_numpy(qrows), torch.from_numpy(extra), r)
    assert (ti[440:] == -1).all()
    assert_rows_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy(), "padded block")


@pytest.mark.parametrize("entry_sample", [True, False])
def test_graph_search_entry_sample_matches_jax(entry_sample):
    n, d = 1200, 32
    vecs = _corpus(30, n, d)
    jgi = jg.GraphIndex(degree=8, n_long_edges=2, steps=5, entry_sample_size=256)
    jgi.build(vecs)
    nbrs, entries = np.array(jgi.neighbors), np.array(jgi.entry_points)
    rows = np.array(jgi.entry_sample_rows) if entry_sample else None
    svecs = np.array(jgi.entry_sample_vecs) if entry_sample else None
    mask = np.random.default_rng(31).random(n) > 0.2
    q = _corpus(32, 20, d)
    js, ji = jg.graph_search(jnp.asarray(vecs), jnp.asarray(nbrs), jnp.asarray(entries),
                             jnp.asarray(q), jnp.asarray(mask), 10, ef=48, steps=5,
                             entry_sample_rows=None if rows is None else jnp.asarray(rows),
                             entry_sample_vecs=None if svecs is None else jnp.asarray(svecs))
    t = (lambda a: None if a is None else torch.from_numpy(a))
    ts, ti = tg.graph_search(torch.from_numpy(vecs), torch.from_numpy(nbrs),
                             torch.from_numpy(entries), torch.from_numpy(q),
                             torch.from_numpy(mask), 10, ef=48, steps=5,
                             entry_sample_rows=t(rows), entry_sample_vecs=t(svecs))
    assert ti.dtype == torch.int32
    assert_rows_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy(), "graph_search")
    assert not set(ti.numpy().reshape(-1).tolist()) & set(np.nonzero(~mask)[0].tolist())


@pytest.mark.parametrize("store_fp32", [True, False])
def test_graph_mode_falls_back_to_int8_like_jax(store_fp32):
    """Without fp32 vectors, or before a build, mode="graph" is the int8
    search in both packages; a built graph is searched up to its rows, k
    past them padded."""
    engs = _engines(store_fp32=store_fp32)
    _append(engs, _corpus(33, 200, 32))
    q = _corpus(34, 9, 32)
    out = []
    for eng in engs:
        gs, gr = eng.search(q, 10, mode="graph", ef_runtime=40)
        s8, r8 = eng.search(q, 10, mode="int8", ef_runtime=40)
        np.testing.assert_array_equal(gr, r8)
        np.testing.assert_array_equal(gs, s8)
        out.append((gs, gr))
    assert_rows_match(out[0][1], out[0][0], out[1][1], out[1][0], "int8 fallback")
    if not store_fp32:
        return
    small = _engines()
    _append(small, _corpus(35, 30, 32))
    got = []
    for eng in small:
        eng.build_graph(degree=8)
        got.append(eng.search(q, 40, mode="graph"))
    assert (got[1][1][:, :30] >= 0).all() and (got[1][1][:, 30:] == -1).all()
    assert (got[1][0][:, 30:] == np.float32(-1e30)).all()
    assert_rows_match(got[0][1], got[0][0], got[1][1], got[1][0], "k past the graph")


def test_stale_graph_warns_and_is_served_as_it_is(caplog):
    """Past max(20,000, count // 10) new rows the query path inserts
    nothing: it warns and searches the graph as built, in both packages."""
    engs = _engines(d=8)
    base = _corpus(36, 100, 8)
    _append(engs, base)
    for eng in engs:
        eng.build_graph(degree=4)
    _append(engs, _corpus(37, 20_001, 8))
    res = []
    for eng in engs:
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            res.append(eng.search(base[:4], 5, mode="graph"))
        assert "serving the stale graph" in caplog.text
        assert eng.graph.built_rows == 100
    assert (res[1][1] < 100).all()
    assert_rows_match(res[0][1], res[0][0], res[1][1], res[1][0], "stale graph")


def test_graph_index_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.GraphIndex()
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.build_knn_graph(_corpus(38, 10, 8), degree=2, n_long_edges=0)
