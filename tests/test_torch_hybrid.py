"""The whole slice: the port's HybridSearcher.search_rows against the JAX
package's on the same corpus and queries (CPU).

The corpus is made the way bench.py makes it (clustered vectors, zipfian
texts), at a small size. Both packages build their own indexes from it,
except in the convert.py case, where the port searches the JAX package's own
tables. Tolerance: tests/_torch_parity.py (exact rows and ranks on every
leg; scores rtol 1e-5 / atol 1e-6).
"""

import numpy as np
import pytest
import torch

from radiant_rag_tpu.index.bm25 import BM25Index as JaxBM25
from radiant_rag_tpu.index.engine import DeviceVectorIndex as JaxEngine
from radiant_rag_tpu.index.hybrid import HybridSearcher as JaxHybrid
from radiant_rag_tpu_torch.convert import bm25_from_jax_state, engine_from_jax_state
from radiant_rag_tpu_torch.index.bm25 import BM25Index
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
from radiant_rag_tpu_torch.index.hybrid import HybridSearcher

from _torch_parity import assert_result_match

N, D, S = 3000, 64, 256


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, D)).astype(np.float32)
    vecs = centers[rng.integers(0, 32, N)] + 0.7 * rng.standard_normal((N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (N, 24)) % 2000]
    levels = rng.integers(0, 2, N).astype(np.int8)
    langs = rng.integers(0, 3, N).astype(np.int32)
    lens = np.asarray([len(t.split()) for t in texts], np.float32)
    return rng, vecs, texts, levels, langs, lens


@pytest.fixture(scope="module")
def world():
    rng, vecs, texts, levels, langs, lens = _corpus()
    je = JaxEngine(D, initial_capacity=N)
    te = DeviceVectorIndex(D, initial_capacity=N, device="cpu")
    for eng in (je, te):
        for s in range(0, N, 1024):
            eng.append(vecs[s:s + 1024], levels[s:s + 1024], langs[s:s + 1024],
                       lens[s:s + 1024])
    jb, tb = JaxBM25(sketch_dim=S), BM25Index(sketch_dim=S, device="cpu")
    jb.bulk_build(list(range(N)), texts)
    tb.bulk_build(list(range(N)), texts)
    qidx = rng.integers(0, N, 24)
    q = vecs[qidx] + 0.25 * rng.standard_normal((24, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = [" ".join(texts[i].split()[:6]) for i in qidx]
    jb._finalize_csr()
    lengths = np.diff(jb._term_start)
    rare = [jb.terms[t] for t in np.argsort(lengths, kind="stable")[:16]]
    rare_qt = [f"{rare[i]} {rare[15 - i]}" for i in range(8)]
    return {"j": JaxHybrid(je, jb), "t": HybridSearcher(te, tb), "q": q, "qt": qt,
            "rare_qt": rare_qt, "texts": texts}


def _both(world, q, qt, **kw):
    return (world["j"].search_rows(q, qt, **kw), world["t"].search_rows(q, qt, **kw))


@pytest.mark.parametrize("fused_depth", [0, 40])
@pytest.mark.parametrize("bm25_mode", ["sketch", "pages"])
def test_search_rows_matches_jax(world, bm25_mode, fused_depth):
    ref, got = _both(world, world["q"], world["qt"], mode="int8", bm25_mode=bm25_mode,
                     fused_depth=fused_depth)
    assert_result_match(ref, got, f"{bm25_mode} depth {fused_depth}")
    assert (got["fused"][1][:, 0] >= 0).all()


@pytest.mark.parametrize("bm25_mode", ["sketch", "pages"])
def test_search_rows_filters_match_jax(world, bm25_mode):
    ref, got = _both(world, world["q"], world["qt"], mode="int8", bm25_mode=bm25_mode,
                     level_code=1, lang_code=2, fused_depth=40)
    assert_result_match(ref, got, f"filtered {bm25_mode}")


@pytest.mark.parametrize("bm25_mode", ["sketch", "pages"])
def test_padded_query_rows_match_jax(world, bm25_mode):
    """B = 5 pads to the 8-query bucket; padded rows never leak out."""
    ref, got = _both(world, world["q"][:5], world["qt"][:5], mode="int8",
                     bm25_mode=bm25_mode)
    assert_result_match(ref, got, f"padded {bm25_mode}")
    assert got["fused"][1].shape == (5, 15)


@pytest.mark.parametrize("fusion", ["equal", "score"])
def test_fusion_modes_match_jax(world, fusion):
    ref, got = _both(world, world["q"], world["qt"], mode="int8", bm25_mode="sketch",
                     fusion=fusion, fused_depth=40)
    assert_result_match(ref, got, f"fusion {fusion}")


def test_blockmax_select_matches_jax(world):
    ref, got = _both(world, world["q"], world["qt"], mode="int8", bm25_mode="sketch",
                     select="blockmax")
    assert_result_match(ref, got, "blockmax")


def test_graph_mode_runs_the_int8_stage_like_jax(world):
    """Under index.use_graph the app hands search_rows mode="graph": with a
    graph built on both engines, each package's fused hybrid still runs the
    int8 stage 1, so its dense leg equals its own mode="int8" search
    exactly; the BM25 and fused legs, which no mode touches, match under
    the parity rule (the BM25 scatter-add order is not fixed)."""
    engines = (world["j"].engine, world["t"].engine)
    try:
        for eng in engines:
            eng.build_graph(degree=8)
        assert engines[1].graph.built_rows == N
        for bm25_mode in ("sketch", "pages"):
            ref_g, got_g = _both(world, world["q"], world["qt"], mode="graph",
                                 bm25_mode=bm25_mode, fused_depth=40)
            ref_8, got_8 = _both(world, world["q"], world["qt"], mode="int8",
                                 bm25_mode=bm25_mode, fused_depth=40)
            for g, i8 in ((ref_g, ref_8), (got_g, got_8)):
                for part in (0, 1):  # scores, rows
                    np.testing.assert_array_equal(np.asarray(g["dense"][part]),
                                                  np.asarray(i8["dense"][part]))
                assert_result_match(i8, g, f"graph against int8, {bm25_mode}")
            assert_result_match(ref_g, got_g, f"graph mode {bm25_mode}")
    finally:
        for eng in engines:
            eng.graph = None


def test_exact_dense_mode_matches_jax(world):
    ref, got = _both(world, world["q"], world["qt"], mode="exact", bm25_mode="pages")
    assert_result_match(ref, got, "exact dense")


@pytest.mark.parametrize("batch", ["common", "rare"])
def test_auto_route_matches_jax(world, batch, monkeypatch):
    """The router on both packages: with the thresholds scaled to this small
    corpus, common-term queries take the sketch, rare-term ones the pages."""
    for bm in (world["j"].bm25, world["t"].bm25):
        monkeypatch.setattr(bm, "pages_route_threshold", 200)
        monkeypatch.setattr(bm, "disc_route_df_frac", 0.002)
    qt = world["qt"][:8] if batch == "common" else world["rare_qt"]
    tids = world["t"].bm25.query_tids(qt)
    routes = world["t"].bm25.routes_pages(qt, tids, num_docs=world["t"].engine.capacity)
    assert routes == (batch == "rare")
    ref, got = _both(world, world["q"][:8], qt, mode="int8", fused_depth=40)
    assert_result_match(ref, got, f"auto {batch}")


def test_fetch_false_and_chunking_match_fetched(world):
    t = world["t"]
    full = t.search_rows(world["q"], world["qt"], bm25_mode="sketch")
    packed, unpack = t.search_rows(world["q"], world["qt"], bm25_mode="sketch", fetch=False)
    assert isinstance(packed, torch.Tensor)
    piped = unpack()
    eng = t.engine
    saved = eng.usable_bytes
    try:  # shrink the gate to 8-query batches: the searcher chunks
        eng.usable_bytes = (eng.resident_bytes()
                            + t.bm25.device_bytes_projected(eng.capacity)
                            + 8 * eng.capacity * 24)
        assert t.max_query_bucket() == 8
        chunked = t.search_rows(world["q"], world["qt"], bm25_mode="sketch")
    finally:
        eng.usable_bytes = saved
    for leg in full:
        for other in (piped, chunked):
            np.testing.assert_array_equal(other[leg][1], full[leg][1])
            np.testing.assert_array_equal(other[leg][0], full[leg][0])


@pytest.mark.parametrize("bm25_mode", ["sketch", "pages"])
def test_state_carried_across_matches_jax(world, bm25_mode):
    """convert.py: the port searches the JAX package's own tables."""
    jh = world["j"]
    je, jb = jh.engine, jh.bm25
    jb.ensure_sketch(je.capacity)
    jb.ensure_doc_major(je.capacity)
    eng = engine_from_jax_state(
        vecs=np.asarray(je.vecs), i8=np.asarray(je.i8), i8_lo=np.asarray(je.i8_lo),
        i8_hi=np.asarray(je.i8_hi), codes=np.asarray(je.codes), valid=np.asarray(je.valid),
        level=np.asarray(je.level), lang=np.asarray(je.lang), doc_len=np.asarray(je.doc_len),
        count=je.count, capacity=je.capacity, device="cpu")
    bm = bm25_from_jax_state(
        terms=jb.terms, df=jb.df, term_start=jb._term_start, term_idf=jb._term_idf,
        post_rows=jb._host_post_rows, post_tf=jb._host_post_tf, doc_lens=jb.doc_lens,
        sketch=np.asarray(jb._sketch), sketch_scale=float(np.asarray(jb._sketch_scale)),
        bins_per_term=jb._bins_per_term, signs_per_term=jb._signs_per_term,
        dm_tids=np.asarray(jb._dm_tids), dm_tfs=np.asarray(jb._dm_tfs),
        device="cpu", sketch_dim=S)
    got = HybridSearcher(eng, bm).search_rows(world["q"], world["qt"], mode="int8",
                                              bm25_mode=bm25_mode, fused_depth=40)
    ref = jh.search_rows(world["q"], world["qt"], mode="int8", bm25_mode=bm25_mode,
                         fused_depth=40)
    assert_result_match(ref, got, f"carried {bm25_mode}")


def test_empty_engine_returns_no_rows():
    te = DeviceVectorIndex(D, device="cpu")
    hs = HybridSearcher(te, BM25Index(device="cpu"))
    res = hs.search_rows(np.zeros((3, D), np.float32), ["a", "b", "c"])
    assert res["fused"][1].shape == (3, 15) and (res["fused"][1] == -1).all()
    _, unpack = hs.search_rows(np.zeros((3, D), np.float32), ["a", "b", "c"], fetch=False)
    assert (unpack()["dense"][1] == -1).all()


# -- the models slice: embed_queries_device -> search_rows(_qdev) -> rerank --

@pytest.fixture(scope="module")
def chain():
    """Both packages' models (dtype float32, weights carried across) over one
    corpus whose vectors are the JAX embedder's embeddings of its texts."""
    import jax

    from radiant_rag_tpu.config import CrossEncoderConfig as JaxCEConfig
    from radiant_rag_tpu.config import EmbeddingConfig as JaxEmbConfig
    from radiant_rag_tpu.models.cross_encoder import CrossEncoder as JaxCE
    from radiant_rag_tpu.models.device_rerank import DeviceReranker as JaxReranker
    from radiant_rag_tpu.models.embedder import Embedder as JaxEmbedder
    from radiant_rag_tpu.models.registry import LocalNLPModels as JaxModels
    from radiant_rag_tpu_torch.config import CrossEncoderConfig, EmbeddingConfig
    from radiant_rag_tpu_torch.convert import bert_params_from_jax, cross_encoder_params_from_jax
    from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
    from radiant_rag_tpu_torch.models.device_rerank import DeviceReranker
    from radiant_rag_tpu_torch.models.embedder import Embedder
    from radiant_rag_tpu_torch.models.registry import LocalNLPModels

    d, n = 32, 2000
    emb = dict(preset="none", dim=d, num_layers=2, num_heads=4, hidden_dim=64, vocab_size=2048,
               max_seq_len=32, batch_size=256, dtype="float32", checkpoint_dir="")
    ce = dict(dim=d, num_layers=1, num_heads=4, hidden_dim=64, vocab_size=2048, max_seq_len=64,
              dtype="float32")
    jemb, jce = JaxEmbedder(JaxEmbConfig(**emb), seed=2), JaxCE(JaxCEConfig(**ce), seed=3)
    temb = Embedder(EmbeddingConfig(**emb), device="cpu",
                    params=bert_params_from_jax(jax.tree.map(np.asarray, jemb.params)))
    tce = CrossEncoder(CrossEncoderConfig(**ce), device="cpu",
                       params=cross_encoder_params_from_jax(jax.tree.map(np.asarray, jce.params)))
    rng = np.random.default_rng(5)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (n, 24)) % 2000]
    vecs = jemb.embed(texts)
    je, te = JaxEngine(d, initial_capacity=n), DeviceVectorIndex(d, initial_capacity=n,
                                                                device="cpu")
    for eng in (je, te):
        eng.append(vecs, np.zeros(n, np.int8), np.zeros(n, np.int32), np.full(n, 24, np.float32))
    jb, tb = JaxBM25(sketch_dim=S), BM25Index(sketch_dim=S, device="cpu")
    jb.bulk_build(list(range(n)), texts)
    tb.bulk_build(list(range(n)), texts)
    jr, tr = JaxReranker(jce, pair_chunk=256), DeviceReranker(tce, pair_chunk=256)
    jr.build_table(texts)
    tr.build_table(texts)
    qt = [" ".join(texts[i].split()[:6]) for i in rng.integers(0, n, 21)]
    return {"j": (JaxModels(embedder=jemb, cross_encoder=jce), JaxHybrid(je, jb), jr),
            "t": (LocalNLPModels(embedder=temb, cross_encoder=tce), HybridSearcher(te, tb), tr),
            "qt": qt}


def _chain(models, searcher, reranker, qt, bm25_mode):
    from radiant_rag_tpu.index.hybrid import embed_queries_device as jax_embed_queries_device
    from radiant_rag_tpu_torch.index.hybrid import embed_queries_device

    fn = embed_queries_device if isinstance(searcher, HybridSearcher) else jax_embed_queries_device
    qdev = fn(models, searcher.engine, qt)
    res = searcher.search_rows(None, qt, dense_k=40, bm25_k=40, fused_k=40, mode="int8",
                               bm25_mode=bm25_mode, fused_depth=0, _qdev=qdev)
    return qdev, res, reranker.rerank_rows(qt, res["fused"][1], top_k=10)


@pytest.mark.parametrize("bm25_mode", ["sketch", "pages"])
def test_models_slice_chain_matches_jax(chain, bm25_mode):
    """embed_queries_device -> search_rows(_qdev) -> rerank_rows, at float32:
    the JAX chain's rows exactly, scores within tests/_torch_parity.py's
    tolerance (the rerank's logits within 1e-5)."""
    jq, jres, jrr = _chain(*chain["j"], chain["qt"], bm25_mode)
    tq, tres, trr = _chain(*chain["t"], chain["qt"], bm25_mode)
    assert isinstance(tq, torch.Tensor) and tq.shape == (32, 32) and (tq[21:] == 0).all()
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
    assert_result_match(jres, tres, f"chain {bm25_mode}")
    np.testing.assert_array_equal(trr[1], jrr[1])
    live = jrr[1] >= 0
    np.testing.assert_allclose(trr[0][live], jrr[0][live], rtol=1e-5, atol=1e-5)
    for q in range(len(chain["qt"])):  # the reranked rows are the query's fused rows
        assert set(trr[1][q][trr[1][q] >= 0]) <= set(tres["fused"][1][q])


def test_qdev_queries_skip_the_fp16_rounding(chain):
    """Host queries are rounded through fp16 on the sketch route (as the JAX
    blob ships them); device queries are not, on either package: the dense
    scores are the f32 query's exact rescore."""
    models, searcher, _ = chain["t"]
    qt = chain["qt"]
    qdev = models.embed_device(qt, pad_to=32)
    q = qdev[:len(qt)].numpy()
    on_dev = searcher.search_rows(None, qt, mode="int8", bm25_mode="sketch", _qdev=qdev)
    on_host = searcher.search_rows(q, qt, mode="int8", bm25_mode="sketch")
    vecs = searcher.engine.vecs.numpy()
    s, rows = on_dev["dense"]
    exact = np.einsum("bd,bkd->bk", q, vecs[rows])
    np.testing.assert_allclose(s, exact, rtol=1e-5, atol=1e-6)
    q16 = q.astype(np.float16).astype(np.float32)
    hs, hrows = on_host["dense"]
    np.testing.assert_allclose(hs, np.einsum("bd,bkd->bk", q16, vecs[hrows]), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(s - np.einsum("bd,bkd->bk", q16, vecs[rows])).max() > 1e-5
    jmodels, jsearcher, _ = chain["j"]
    import jax.numpy as jnp

    ref = jsearcher.search_rows(None, qt, mode="int8", bm25_mode="sketch",
                                _qdev=jnp.asarray(qdev.numpy()))
    assert_result_match(ref, on_dev, "qdev sketch")


def test_embed_queries_device_returns_none_only_where_jax_does(chain):
    from radiant_rag_tpu_torch.index.hybrid import embed_queries_device

    models, searcher, _ = chain["t"]
    eng = searcher.engine
    assert embed_queries_device(object(), eng, ["a"]) is None  # no embed_device
    assert embed_queries_device(models, DeviceVectorIndex(16, device="cpu"), ["a"]) is None
    too_many = ["q"] * (eng.QUERY_BUCKETS[-1] + 1)
    assert embed_queries_device(models, eng, too_many) is None
    assert embed_queries_device(models, eng, ["a", "b", "c"]).shape == (4, 32)

    class Broken:
        embedding_dimension = 32

        def embed_device(self, texts, pad_to):
            raise RuntimeError("device path broken")

    with pytest.raises(RuntimeError, match="device path broken"):  # no silent host fallback
        embed_queries_device(Broken(), eng, ["a"])
    with pytest.raises(ValueError, match="bucket"):
        searcher.search_rows(None, ["a", "b"], bm25_mode="sketch",
                             _qdev=torch.zeros((8, 32)))


def test_oversized_qdev_batch_is_chunked_through_the_host(chain):
    """Past the gated bucket the device queries are fetched and chunked as
    host queries (the JAX package does the same), so the result equals the
    host-query search of the same vectors."""
    models, searcher, _ = chain["t"]
    qt = chain["qt"]
    qdev = models.embed_device(qt, pad_to=32)
    eng = searcher.engine
    saved = eng.usable_bytes
    try:
        eng.usable_bytes = (eng.resident_bytes() + searcher.bm25.device_bytes_projected(
            eng.capacity) + 8 * eng.capacity * 24)
        assert searcher.max_query_bucket() == 8
        got = searcher.search_rows(None, qt, bm25_mode="sketch", _qdev=qdev)
        ref = searcher.search_rows(qdev[:len(qt)].numpy(), qt, bm25_mode="sketch")
    finally:
        eng.usable_bytes = saved
    for leg in ref:
        np.testing.assert_array_equal(got[leg][1], ref[leg][1])
        np.testing.assert_array_equal(got[leg][0], ref[leg][0])
