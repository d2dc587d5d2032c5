"""Fusion calibration of the port against the JAX package's (CPU).

`HybridSearcher.calibrate_fusion` picks the fusion mode and the leg weights
from self-retrieval probes over the live corpus. Its result is a chain of
exact steps (probe rows in insertion order, numpy's generator, MRRs on rows,
eps and margin rules), so the tolerance here is: probes string-equal,
`fusion_mode` and every MRR equal, `leg_weights` within 1e-6, and after
calibration `search_rows(fusion="auto")` rows equal, scores within
tests/_torch_parity.py's tolerance. Mirrors `tests/test_hybrid.py`'s
calibration cases.

The probes search in the default mode, binary. The corpus holds no more
rows than the stage-1 depth (kc = 40), so that stage keeps every row: at
the kc-th Hamming score the JAX package's CPU stage 1 keeps another subset
of the tied rows than the port's lowest-row rule (ROADMAP section C, PR 2),
which would change dense rows below the probes' targets, and with them the
score-fusion MRRs, for a reason that is not calibration's.
"""

import zlib

import numpy as np
import pytest

from radiant_rag_tpu.config import IndexConfig as JaxIndexConfig
from radiant_rag_tpu.index.bm25 import BM25Index as JaxBM25
from radiant_rag_tpu.index.hybrid import HybridSearcher as JaxHybrid
from radiant_rag_tpu.index.store import TpuVectorStore as JaxStore
from radiant_rag_tpu.parallel import data as jdata
from radiant_rag_tpu_torch.config import IndexConfig
from radiant_rag_tpu_torch.index.bm25 import BM25Index
from radiant_rag_tpu_torch.index.hybrid import HybridSearcher
from radiant_rag_tpu_torch.index.store import TpuVectorStore
from radiant_rag_tpu_torch.parallel import data as tdata

from _torch_parity import assert_result_match

N_DOCS, DIM = 40, 16


def _texts(n):
    return [f"unique{i} subject{i % 7} verb{i % 11} object{i} the fast function returns "
            f"value{i % 5} for each batch of documents" for i in range(n)]


def _pair(texts, embs):
    """The same corpus in both packages' stores, BM25 indexes and searchers."""
    out = {}
    for key, store_cls, cfg_cls, bm_cls, hy_cls, kw in (
            ("j", JaxStore, JaxIndexConfig, JaxBM25, JaxHybrid, {}),
            ("t", TpuVectorStore, IndexConfig, BM25Index, HybridSearcher, {"device": "cpu"})):
        store = store_cls(dim=DIM, index_config=cfg_cls(dim=DIM, initial_capacity=len(texts)),
                          **kw)
        store.upsert_batch([(t, {}, embs[i]) for i, t in enumerate(texts)])
        bm25 = bm_cls(sketch_dim=128, **kw)
        bm25.bulk_build([store.row_of(store.make_doc_id(t, {})) for t in texts], texts)

        def text_of(row, store=store):
            doc_id = store.id_for_row(row)
            doc = store.get_doc(doc_id) if doc_id else None
            return doc.content if doc else None

        out[key] = (hy_cls(store.engine, bm25), text_of)
    return out


def _garbage_embed(qs):
    """A deterministic encoder that knows nothing: unit vectors from a hash
    of the text (equal inputs in both packages)."""
    out = np.stack([np.random.default_rng(zlib.crc32(q.encode())).standard_normal(DIM)
                    for q in qs]).astype(np.float32)
    return out / np.linalg.norm(out, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpora():
    rng = np.random.default_rng(11)
    texts = _texts(N_DOCS)
    embs = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    by_text = {t: embs[i] for i, t in enumerate(texts)}

    def oracle_embed(qs):
        # a probe made from a doc's words maps to that doc's embedding
        out = np.zeros((len(qs), DIM), np.float32)
        for qi, q in enumerate(qs):
            for w in q.split():
                if w.startswith("unique"):
                    out[qi] = by_text[texts[int(w[6:])]]
                    break
            else:
                out[qi] = _garbage_embed([q])[0]
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-9)

    return {"texts": texts, "embs": embs, "oracle": oracle_embed}


@pytest.mark.parametrize("seed", range(12))
def test_probe_makers_equal_jax(corpora, seed):
    text = corpora["texts"][seed] + ". Second sentence here! And a third one with memory cache."
    for max_words in (3, 8, 12):
        for fn in ("make_pseudo_query", "make_paraphrase_query"):
            jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
            for _ in range(4):  # successive draws from one generator
                assert getattr(tdata, fn)(text, tr, max_words=max_words) == \
                    getattr(jdata, fn)(text, jr, max_words=max_words)
    assert tdata.SYNONYMS == jdata.SYNONYMS and tdata.STOPWORDS == jdata.STOPWORDS
    assert tdata._SENT_RE.pattern == jdata._SENT_RE.pattern


def _assert_calibration_equal(j, t):
    assert t.fusion_mode == j.fusion_mode
    np.testing.assert_allclose(t.leg_weights, j.leg_weights, rtol=0, atol=1e-6)
    jc, tc = j.last_calibration, t.last_calibration
    assert set(tc) == set(jc)
    for key in jc:
        if key in ("weights", "confidence_weights"):
            np.testing.assert_allclose(tc[key], jc[key], rtol=0, atol=1e-6)
        else:
            assert tc[key] == jc[key], key  # MRRs, probe counts, near ties, seeds


@pytest.mark.parametrize("encoder,fused_depth,seeds", [
    ("garbage", 0, 1), ("oracle", 0, 1), ("oracle", 60, 2), ("garbage", 60, 2)])
def test_calibrate_fusion_matches_jax(corpora, encoder, fused_depth, seeds):
    """Both encoders of tests/test_hybrid.py (a garbage dense leg that
    calibration demotes, and an oracle one), at fused depth 0 and the auto
    depth 60, one and two probe draws."""
    embed = _garbage_embed if encoder == "garbage" else corpora["oracle"]
    pair = _pair(corpora["texts"], corpora["embs"])
    for key in pair:
        pair[key][0].default_fused_depth = fused_depth
    (j, jtext), (t, ttext) = pair["j"], pair["t"]
    assert t.needs_calibration() and j.needs_calibration()
    jw = j.calibrate_fusion(embed, jtext, n_probes=48, seeds=seeds)
    tw = t.calibrate_fusion(embed, ttext, n_probes=48, seeds=seeds)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
    _assert_calibration_equal(j, t)
    assert not t.needs_calibration()
    if encoder == "garbage":
        assert t.fusion_mode == "confidence" and t.leg_weights[1] > 0.9
        assert t.last_calibration["bm25_mrr"] > 0.5
    # "auto" now serves the calibrated config, in the mode the app serves
    # (the store's default, int8): rows as the JAX package's
    qt = [" ".join(corpora["texts"][i].split()[:4]) for i in (5, 17, 23, 38)]
    q = embed(qt)
    kw = dict(dense_k=5, bm25_k=5, fused_k=5, mode="int8")
    for bm25_mode in ("sketch", "pages"):
        ref = j.search_rows(q, qt, bm25_mode=bm25_mode, **kw)
        got = t.search_rows(q, qt, bm25_mode=bm25_mode, **kw)
        assert_result_match(ref, got, f"auto after calibration ({bm25_mode})")
        explicit = t.search_rows(q, qt, bm25_mode=bm25_mode, fusion=t.fusion_mode, **kw)
        np.testing.assert_array_equal(got["fused"][1], explicit["fused"][1])


def test_calibration_on_a_tiny_corpus_is_skipped_like_jax(corpora):
    pair = _pair(corpora["texts"][:6], corpora["embs"][:6])
    (j, jtext), (t, ttext) = pair["j"], pair["t"]
    j.calibrate_fusion(_garbage_embed, jtext)
    t.calibrate_fusion(_garbage_embed, ttext)
    assert t.last_calibration == j.last_calibration
    assert t.last_calibration["skipped"] and not t.needs_calibration()
    np.testing.assert_array_equal(t.leg_weights, [0.5, 0.5])


def test_needs_calibration_and_invalidate(corpora):
    pair = _pair(corpora["texts"][:40], corpora["embs"][:40])
    t, ttext = pair["t"]
    assert t.needs_calibration()
    t.calibrate_fusion(_garbage_embed, ttext, n_probes=16)
    assert not t.needs_calibration() and t._calibrated_at == 40
    extra = np.random.default_rng(3).standard_normal((8, DIM)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    z8, z32 = np.zeros(8, np.int8), np.zeros(8, np.int32)
    t.engine.append(extra, z8, z32, np.full(8, 10, np.float32))  # +20%: not yet
    assert not t.needs_calibration()
    t.engine.append(extra, z8, z32, np.full(8, 10, np.float32))  # +40%
    assert t.needs_calibration()
    t.fusion_mode, t.leg_weights = "score", np.asarray([0.3, 0.7], np.float32)
    t.invalidate_calibration()
    assert t.needs_calibration() and t.last_calibration is None
    assert t.fusion_mode == "confidence"
    np.testing.assert_allclose(t.leg_weights, [0.5, 0.5])
    other = BM25Index(sketch_dim=64, device="cpu")
    t.rebind_bm25(other)
    assert t.bm25 is other


# -- the rerank auto-disable verdict: repairs of ROADMAP section C ------------

@pytest.fixture(scope="module")
def big_stacks(tmp_path_factory):
    from _torch_agentic_world import BIG_DOCS, make_stacks

    return make_stacks(tmp_path_factory.mktemp("big"), BIG_DOCS)


def test_clear_index_earns_the_rerank_verdict_again(tmp_path):
    """clear_index replaces the store's engine; the searcher's rebind must
    drop the rerank verdict with the fusion calibration, or a smaller
    corpus (inside the 20% growth window of the old count) keeps the old
    verdict."""
    from _torch_agentic_world import BIG_DOCS, llms, make_stacks, replace_sections
    from radiant_rag_tpu_torch.app import RadiantTPU
    from radiant_rag_tpu_torch.ingestion.processor import IngestedChunk

    cfg, store, _, models = make_stacks(tmp_path / "w", BIG_DOCS)["t"]
    cfg = replace_sections(cfg, rerank={"auto_disable_probes": 8},
                           bm25={"index_path": str(tmp_path / "bm25.json.gz")},
                           index={"data_dir": str(tmp_path / "idx")})
    app = RadiantTPU(cfg, llm=llms()[1], local_models=models, store=store, device="cpu")
    orch = app.orchestrator
    orch._ensure_rerank_calibration()
    assert orch._rerank_calibrated_at == store.count_documents() == len(BIG_DOCS)
    app.clear_index()
    app.ingest_chunks([IngestedChunk(t, {"source": f"d{i}"}) for i, t in enumerate(BIG_DOCS[:40])])
    n = store.count_documents()
    assert 8 * 8 <= n < len(BIG_DOCS)  # 40 parents + 40 leaves
    assert app.search("Document about golgi transport", top_k=3, use_cache=False)
    orch._ensure_rerank_calibration()
    assert orch._rerank_calibrated_at == n and orch.rerank_calibration["probes"] >= 4


def _search_finds_nothing(searcher):
    def search_rows(q_embs, queries, dense_k=10, bm25_k=10, fused_k=15, **kw):
        b = len(queries)
        empty = lambda k: (np.full((b, k), -1e30, np.float32),  # noqa: E731
                           np.full((b, k), -1, np.int64))
        return {"dense": empty(dense_k), "bm25": empty(bm25_k), "fused": empty(fused_k)}

    searcher.search_rows = search_rows


def test_rerank_probes_without_evidence_leave_the_stage_as_it_was(big_stacks):
    """Every probe hydrates to no doc: the JAX package reads a gain of 0.0
    and switches the rerank off on nan MRRs; the port stamps the count and
    leaves the stage as it was (the too-few-probes case)."""
    import warnings

    from _torch_agentic_world import orchestrators

    jo, to = orchestrators(big_stacks, sections={"rerank": {"auto_disable_probes": 8}})
    for orch in (jo, to):
        _search_finds_nothing(orch._hybrid)
        assert orch.rerank.enabled
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the mean of no probes
        jo._ensure_rerank_calibration()
    v = jo.rerank_calibration
    assert v["probes"] == 0 and v["auto_disabled"] and np.isnan(v["rerank_mrr"])
    assert not jo.rerank.enabled
    to._ensure_rerank_calibration()
    assert to.rerank.enabled and not to.rerank_calibration
    assert to._rerank_calibrated_at == big_stacks["t"][1].count_documents()
