"""The port's CUDA kernels and main path on the card (skipped without one).

Imports no jax, so it also runs on a machine without the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: the kernels do integer work and must equal their plain versions
exactly; the whole path on the card must match the CPU path under
tests/_torch_parity.py's rule (scores within rtol 1e-5 / atol 1e-6 for the
fp32 summation order, rows equal up to swaps of candidates tied within it).
"""

import numpy as np
import pytest
import torch

from radiant_rag_tpu_torch.ops import cuda_kernels as ck

from _torch_parity import assert_edges_match, assert_result_match

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, n, d, b, lo, hi, card):
    rng = np.random.default_rng(seed)
    codes = rng.integers(lo, hi, (n, d), dtype=np.int8)
    codes[n // 2:n // 2 + 5] = codes[7]  # duplicated rows: tied scores
    qi = rng.integers(lo, hi, (b, d), dtype=np.int8)
    mask = np.ones(n, bool)
    mask[3:40] = False
    mask[1024:1536] = False  # a fully dead 512-row tile
    return (torch.from_numpy(codes).to(card), torch.from_numpy(qi).to(card),
            torch.from_numpy(mask).to(card))


@pytest.mark.parametrize("n,d,b,k,lo,hi", [(5000, 384, 33, 40, -127, 128),
                                           (70_000, 1024, 1, 160, -1, 2),
                                           (4096, 64, 64, 256, -3, 4)])
def test_kernels_equal_plain_versions(card, n, d, b, k, lo, hi):
    codes, qi, mask = _inputs(n + k, n, d, b, lo, hi, card)
    launches = (ck.int8_scan_topk.launches, ck.blockmax2.launches)
    for kern, plain, args in ((ck.int8_scan_topk, ck.int8_scan_topk_reference,
                               (codes, qi, mask, k)),
                              (ck.blockmax2, ck.blockmax2_reference, (codes, qi, mask))):
        s, r = kern(*args)
        torch.cuda.synchronize()
        ps, pr = plain(*args)
        assert torch.equal(r, pr) and torch.equal(s, ps)
    assert (ck.int8_scan_topk.launches, ck.blockmax2.launches) == \
        (launches[0] + 1, launches[1] + 1)


@pytest.mark.parametrize("n,d,b,k", [(20_000, 384, 40, 360), (9000, 512, 3, 360),
                                     (12_000, 1024, 33, 240), (5000, 384, 2, 512),
                                     (5000, 1024, 3, 512)])
def test_int8_scan_topk_at_serving_k(card, n, d, b, k):
    """The k the presets reach at the auto fused depth (60 x 4.0, 60 x 6.0),
    and k = 512 at D = 1024, which the 32-query CTA fits."""
    codes, qi, mask = _inputs(n + d + k, n, d, b, -2, 3, card)
    s, r = ck.int8_scan_topk(codes, qi, mask, k)
    torch.cuda.synchronize()
    ps, pr = ck.int8_scan_topk_reference(codes, qi, mask, k)
    assert torch.equal(r, pr) and torch.equal(s, ps)


# The tensor-core tile's edges: N not a multiple of its 128 rows, B not a
# multiple of its query block and B = 1, D = 16 and 48 (K tails short of
# the 32-byte mma step), k on both sides of the 64 -> 32 query-block switch,
# a dead 128-row tile inside the dead 512 rows, duplicate rows tied at the
# k-th score (narrow value ranges).
@pytest.mark.parametrize("n,d,b,k,lo,hi", [(3001, 16, 65, 40, -127, 128),
                                           (4099, 48, 7, 100, -2, 3),
                                           (2177, 48, 1, 16, -1, 2),
                                           (6000, 64, 65, 363, -2, 3),
                                           (6000, 64, 65, 364, -2, 3),
                                           (1500, 96, 130, 300, -1, 2)])
def test_mma_tile_edges(card, n, d, b, k, lo, hi):
    assert ck.int8_scan_qb(363) == 64 and ck.int8_scan_qb(364) == 32
    codes, qi, mask = _inputs(n * 7 + d + k, n, d, b, lo, hi, card)
    s, r = ck.int8_scan_topk(codes, qi, mask, k)
    sc = ck.int8_scores(codes, qi)
    torch.cuda.synchronize()
    ps, pr = ck.int8_scan_topk_reference(codes, qi, mask, k)
    assert torch.equal(r, pr) and torch.equal(s, ps)
    assert torch.equal(sc, ck.int8_scores_reference(codes, qi))


def _words(seed, n, w, b, card, ties=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    if ties:  # few distinct words: raw takes few values, ties at every k
        codes &= np.uint32(0x0F0F0F0F)
    codes[n // 2:n // 2 + 9] = codes[5]  # a block of duplicate codes
    q = rng.integers(0, 2**32, (b, w), dtype=np.uint64).astype(np.uint32)
    mask = np.ones(n, bool)
    mask[2:50] = False
    return (torch.from_numpy(codes.view(np.int32)).to(card),
            torch.from_numpy(q.view(np.int32)).to(card), torch.from_numpy(mask).to(card))


# The sign producer's edges on the tensor-core tile: W = 1, 3 and 13 (odd:
# the last 64-byte slice is half used), 24 and 32; N off the 128-row tile,
# B off the 64-query block; k on both sides of the 64 -> 32 query-block
# switch (363 | 364) and k = 512; ties from few distinct words and duplicates.
@pytest.mark.parametrize("n,w,b,k,ties", [(20_000, 12, 40, 360, True), (5000, 12, 1, 60, True),
                                          (70_001, 24, 65, 240, False),
                                          (3000, 12, 8, 512, True), (100, 12, 4, 360, False),
                                          (3001, 1, 65, 40, True), (4099, 3, 7, 100, True),
                                          (6001, 13, 65, 363, True), (6001, 13, 65, 364, True),
                                          (5000, 32, 3, 512, False), (1500, 13, 129, 300, False)])
def test_hamming_scan_topk_equals_plain_version(card, n, w, b, k, ties):
    codes, q, mask = _words(n + k, n, w, b, card, ties)
    before = ck.hamming_scan_topk.launches
    key = ("hamming_scan_topk", w, k, b)
    before_shape = ck.launches_by_shape.get(key, 0)
    s, r = ck.hamming_scan_topk(codes, q, mask, k)
    torch.cuda.synchronize()
    ps, pr = ck.hamming_scan_topk_reference(codes, q, mask, k)
    assert torch.equal(r, pr) and torch.equal(s, ps)
    assert ck.hamming_scan_topk.launches == before + 1
    assert ck.launches_by_shape[key] == before_shape + 1


@pytest.mark.parametrize("n,w,b", [(5000, 12, 33), (70_001, 24, 1), (4096, 32, 64),
                                   (3001, 1, 65), (4099, 3, 7), (6001, 13, 130),
                                   (2049, 32, 129)])
def test_score_kernels_equal_plain_versions(card, n, w, b):
    codes, q, _ = _words(n + w, n, w, b, card, ties=False)
    h = ck.hamming_scores(codes, q)
    ht = ck.hamming_scores_t(codes.T.contiguous(), q)
    i8, qi, _ = _inputs(n + b, n, 32 * w, b, -127, 128, card)
    sc = ck.int8_scores(i8, qi)
    torch.cuda.synchronize()
    ref = ck.hamming_scores_reference(codes, q)
    assert torch.equal(h, ref) and torch.equal(ht, ref)
    assert torch.equal(sc, ck.int8_scores_reference(i8, qi))


def test_wrapper_rejects_what_the_kernel_cannot_take(card):
    codes, qi, mask = _inputs(1, 2048, 64, 4, -3, 4, card)
    with pytest.raises(ValueError):
        ck.int8_scan_topk(codes, qi, mask, ck.INT8_SCAN_TOPK_MAX_K + 1)
    wide = torch.zeros((4, ck.MAX_D + 1), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="exact int32"):
        ck.int8_scan_topk(wide, wide[:1].clone(), None, 10)
    with pytest.raises(TypeError):
        ck.blockmax2(codes.float(), qi, mask)
    unaligned = torch.empty(2048 * 64 + 1, dtype=torch.int8, device=card)[1:].view(2048, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ck.int8_scores(unaligned, qi)
    words, q, _ = _words(3, 2048, 12, 4, card)
    with pytest.raises(TypeError):
        ck.hamming_scan_topk(words.to(torch.int64), q, None, 10)
    with pytest.raises(ValueError):
        ck.hamming_scores(words, q[:, :8].contiguous())


# D off the 16-byte chunk (zero-padded by the wrapper) and wider than 1024
# (the plain versions sum in float64), for all three int8 kernels.
@pytest.mark.parametrize("n,d,b,k,lo,hi", [(5000, 1536, 33, 40, -127, 128),
                                           (3000, 1536, 3, 360, -2, 3),
                                           (5000, 100, 33, 40, -127, 128),
                                           (2177, 100, 130, 240, -2, 3)])
def test_int8_kernels_at_wide_and_odd_d(card, n, d, b, k, lo, hi):
    codes, qi, mask = _inputs(n + d, n, d, b, lo, hi, card)
    before = ck.launches_by_shape.get(("int8_scores", d, 0, b), 0)
    for kern, plain, args in ((ck.int8_scan_topk, ck.int8_scan_topk_reference,
                               (codes, qi, mask, k)),
                              (ck.blockmax2, ck.blockmax2_reference, (codes, qi, mask)),
                              (ck.int8_scores, ck.int8_scores_reference, (codes, qi))):
        out = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        for a, c in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(a, c), kern.__name__
    assert ck.launches_by_shape[("int8_scores", d, 0, b)] == before + 1  # at the caller's D


# The block-max kernel off its 128-query block (B = 129, 255) with a dead
# 512-row tile, duplicate rows and a ragged last tile.
@pytest.mark.parametrize("n,d,b,lo,hi", [(70_000, 384, 129, -1, 2), (9000, 64, 255, -2, 3),
                                         (4095, 16, 129, -127, 128), (700, 48, 1, -1, 2)])
def test_blockmax2_edges(card, n, d, b, lo, hi):
    codes, qi, mask = _inputs(n + b, n, d, b, lo, hi, card)
    s, r = ck.blockmax2(codes, qi, mask)
    torch.cuda.synchronize()
    ps, pr = ck.blockmax2_reference(codes, qi, mask)
    assert torch.equal(r, pr) and torch.equal(s, ps)


def test_blockmax2_past_the_old_tile_cap(card):
    """65,536 x 512 + 700 rows (537 MB of D = 16 codes): more 512-row tiles
    than a grid dimension of 65535 held."""
    n, d, b = 65_536 * 512 + 700, 16, 3
    g = torch.Generator(device=card).manual_seed(7)
    codes = torch.randint(-2, 3, (n, d), dtype=torch.int8, device=card, generator=g)
    qi = torch.randint(-2, 3, (b, d), dtype=torch.int8, device=card, generator=g)
    mask = torch.ones(n, dtype=torch.bool, device=card)
    mask[-1200:-900] = False
    s, r = ck.blockmax2(codes, qi, mask)
    torch.cuda.synchronize()
    ps, pr = ck.blockmax2_reference(codes, qi, mask)
    assert s.shape == (b, 2 * 65_538)
    assert torch.equal(r, pr) and torch.equal(s, ps)


@pytest.mark.parametrize("k", [513, 960])
def test_stage1_product_route_on_card(card, monkeypatch, k):
    """k > 512: the exact-product route through int8_scores / hamming_scores
    equals the scans' plain versions; the scans are not launched. The int8
    route runs under a budget of 16 queries per step, the Hamming one under
    the card's measured free memory (one step)."""
    from radiant_rag_tpu_torch.ops import similarity as sim

    codes, qi, mask = _inputs(k, 20_000, 384, 40, -2, 3, card)
    words, q, wmask = _words(k, 20_000, 12, 40, card)
    before = (ck.int8_scan_topk.launches, ck.hamming_scan_topk.launches,
              ck.int8_scores.launches, ck.hamming_scores.launches)
    measured = sim.route_budget(codes.device)
    assert sim.product_query_block(20_000, 40, measured) == 40
    with monkeypatch.context() as m:
        m.setattr(sim, "route_budget", lambda device: 16 * 20_000 * 24)
        s, r = sim.scan_select(codes, qi, mask, k, "f32")
    hs, hr = sim.hamming_scan_topk(words, q, wmask, k)
    torch.cuda.synchronize()
    ps, pr = ck.int8_scan_topk_reference(codes, qi, mask, k)
    assert torch.equal(r, pr) and torch.equal(s, ps)
    _, phr = ck.hamming_scan_topk_reference(words, q, wmask, k)
    assert torch.equal(hr, phr)
    assert (ck.int8_scan_topk.launches, ck.hamming_scan_topk.launches,
            ck.int8_scores.launches, ck.hamming_scores.launches) == \
        (before[0], before[1], before[2] + 3, before[3] + 1)  # 40 queries in steps of 16


def test_hamming_kernels_past_32_words(card):
    """W = 48 (a 1536-d embedding's sign words)."""
    words, q, mask = _words(48, 6001, 48, 65, card, ties=False)
    s, r = ck.hamming_scan_topk(words, q, mask, 100)
    h = ck.hamming_scores(words, q)
    torch.cuda.synchronize()
    ps, pr = ck.hamming_scan_topk_reference(words, q, mask, 100)
    assert torch.equal(r, pr) and torch.equal(s, ps)
    assert torch.equal(h, ck.hamming_scores_reference(words, q))


@pytest.mark.parametrize("route,select", [("sketch", ""), ("pages", ""),
                                          ("sketch", "blockmax")])
def test_hybrid_on_card_equals_cpu_path(card, route, select):
    from radiant_rag_tpu_torch.index.bm25 import BM25Index
    from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
    from radiant_rag_tpu_torch.index.hybrid import HybridSearcher

    rng = np.random.default_rng(3)
    n, d = 5000, 64
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (n, 24)) % 3000]
    q = vecs[:21] + 0.3 * rng.standard_normal((21, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = [" ".join(t.split()[:6]) for t in texts[:21]]
    out = []
    for dev in ("cpu", card):
        eng = DeviceVectorIndex(d, initial_capacity=n, device=dev)
        eng.append(vecs, np.zeros(n, np.int8), np.zeros(n, np.int32), np.full(n, 24, np.float32))
        bm = BM25Index(device=dev, sketch_dim=256)
        bm.bulk_build(list(range(n)), texts)
        out.append(HybridSearcher(eng, bm).search_rows(q, qt, bm25_mode=route, select=select,
                                                       fused_depth=40))
    assert_result_match(out[0], out[1], f"card vs cpu, {route} {select}")


# -- the models slice on the card ------------------------------------------------

def _small_models(device, dtype, params=None):
    from radiant_rag_tpu_torch.config import CrossEncoderConfig, EmbeddingConfig
    from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
    from radiant_rag_tpu_torch.models.embedder import Embedder

    emb = Embedder(EmbeddingConfig(preset="none", dim=64, num_layers=2, num_heads=4,
                                   hidden_dim=128, vocab_size=2048, max_seq_len=64,
                                   dtype=dtype, checkpoint_dir=""),
                   params=params and params[0], device=device)
    ce = CrossEncoder(CrossEncoderConfig(dim=64, num_layers=2, num_heads=4, hidden_dim=128,
                                         vocab_size=2048, max_seq_len=64, dtype=dtype),
                      params=params and params[1], device=device)
    return emb, ce


def _state(model):
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_models_on_card_equal_cpu(card, dtype):
    """The same weights on the card and on the CPU (float32 on the CPU). In
    float32 the card's GEMMs sum in another order (rtol 1e-4 / atol 1e-5;
    TF32 off); in bf16 within chip_smoke.py's bf16 tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    emb_c, ce_c = _small_models("cpu", "float32")
    emb_g, ce_g = _small_models(card, dtype, (_state(emb_c.model), _state(ce_c.model)))
    texts = [f"card text {i} about topic {i % 7} " * (1 + i % 5) for i in range(40)]
    got, ref = emb_g.embed(texts), emb_c.embed(texts)
    pairs = [(f"topic {i % 7}", t) for i, t in enumerate(texts)]
    gs, rs = ce_g.score_pairs(pairs), ce_c.score_pairs(pairs)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gs, rs, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 3e-2
        assert np.abs(gs - rs).max() <= 5e-2 * max(1.0, np.abs(rs).max())
    dev = emb_g.embed_device(texts[:5], pad_to=8)
    assert dev.device.type == "cuda" and bool((dev[5:] == 0).all())


def test_qdev_chain_on_card_equals_cpu(card):
    """embed_queries_device -> search_rows(_qdev) -> rerank_rows on the card
    against the same chain on the CPU, float32 models: rows equal up to
    tied swaps, rerank rows equal."""
    from radiant_rag_tpu_torch.index.bm25 import BM25Index
    from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
    from radiant_rag_tpu_torch.index.hybrid import HybridSearcher, embed_queries_device
    from radiant_rag_tpu_torch.models.device_rerank import DeviceReranker
    from radiant_rag_tpu_torch.models.registry import LocalNLPModels

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    n = 4000
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (n, 24)) % 3000]
    qt = [" ".join(texts[i].split()[:6]) for i in rng.integers(0, n, 37)]
    emb_c, ce_c = _small_models("cpu", "float32")
    vecs = emb_c.embed(texts)
    out = []
    for dev in ("cpu", card):
        emb, ce = ((emb_c, ce_c) if dev == "cpu" else
                   _small_models(dev, "float32", (_state(emb_c.model), _state(ce_c.model))))
        eng = DeviceVectorIndex(64, initial_capacity=n, device=dev)
        eng.append(vecs, np.zeros(n, np.int8), np.zeros(n, np.int32), np.full(n, 24, np.float32))
        bm = BM25Index(device=dev, sketch_dim=256)
        bm.bulk_build(list(range(n)), texts)
        hs = HybridSearcher(eng, bm)
        models = LocalNLPModels(embedder=emb, cross_encoder=ce)
        rr = DeviceReranker(ce, pair_chunk=512)
        rr.build_table(texts)
        qdev = embed_queries_device(models, eng, qt)
        res = hs.search_rows(None, qt, dense_k=40, bm25_k=40, fused_k=40, mode="int8",
                             bm25_mode="sketch", _qdev=qdev)
        out.append((res, rr.rerank_rows(qt, res["fused"][1], top_k=10)))
    assert_result_match(out[0][0], out[1][0], "qdev chain card vs cpu")
    np.testing.assert_array_equal(out[1][1][1], out[0][1][1])
    np.testing.assert_allclose(out[1][1][0], out[0][1][0], rtol=1e-4, atol=1e-5)


def test_bf16_softmax_rounds_once_on_card(card):
    """models/bert.py takes torch's softmax of the bf16 logits as the JAX
    package's float32 softmax rounded to bf16: equal on the card."""
    g = torch.Generator(device=card).manual_seed(5)
    x = (torch.randn((64, 12, 127, 127), generator=g, device=card) * 3).to(torch.bfloat16)
    x[..., 100:] = -1e9
    assert torch.equal(torch.softmax(x, -1),
                       torch.softmax(x, -1, dtype=torch.float32).to(torch.bfloat16))


def _card_app(tmp_path, n_docs=600):
    """RadiantTPU with device=None (CUDA) over a small corpus, ingested as
    chunks through the hierarchical path, calibrated by a first search."""
    from radiant_rag_tpu_torch.app import RadiantTPU
    from radiant_rag_tpu_torch.config import config_from_dict
    from radiant_rag_tpu_torch.ingestion.processor import IngestedChunk

    cfg = config_from_dict({
        "index": {"dim": 64, "data_dir": str(tmp_path / "idx"), "auto_persist": False},
        "embedding": {"preset": "none", "dim": 64, "num_layers": 2, "num_heads": 4,
                      "hidden_dim": 128, "vocab_size": 2048, "max_seq_len": 64,
                      "checkpoint_dir": ""},
        "bm25": {"index_path": str(tmp_path / "bm25.json.gz"), "sketch_dim": 256},
        "retrieval": {"calibration_probes": 64}})
    app = RadiantTPU(cfg)
    rng = np.random.default_rng(13)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (n_docs, 30)) % 3000]
    app.ingest_chunks([IngestedChunk(t, {"source": f"doc{i}"}) for i, t in enumerate(texts)])
    queries = [" ".join(texts[i].split()[:5]) for i in rng.integers(0, n_docs, 64)]
    app.search_batch(queries[:4], use_cache=False)  # calibrates
    return app, queries


def test_app_with_device_none_lives_on_the_card(card, tmp_path):
    app, queries = _card_app(tmp_path)
    assert app.device.type == "cuda"
    assert app.store.engine.device.type == "cuda" and app.store.engine.vecs.is_cuda
    bm = app.bm25_index.index
    assert bm.device.type == "cuda" and bm._device_doc_lens(app.store.engine.capacity).is_cuda
    assert app.local_models.device.type == "cuda"
    assert all(p.is_cuda for p in app.local_models.embedder.model.parameters())
    hy = app.orchestrator._hybrid
    assert hy.last_calibration is not None and "skipped" not in hy.last_calibration
    launches = ck.int8_scan_topk.launches
    hits = app.search_batch(queries[:8], use_cache=False)
    # the dense leg's scan, and the sketch leg's where the batch takes that route
    assert ck.int8_scan_topk.launches > launches and all(hits)
    assert app.check_health()["ok"]


def test_search_batch_async_from_two_threads_equals_search_batch(card, tmp_path):
    """Two threads dispatch through search_batch_async under one lock (as
    the server's coalescer does) and resolve outside it, concurrently with
    the other's dispatch: every batch equals search_batch of its queries."""
    import threading

    app, queries = _card_app(tmp_path)
    ref = {i: app.search_batch(queries[8 * i:8 * i + 8], use_cache=False) for i in range(8)}
    lock = threading.Lock()
    got, errors = {}, []

    def worker(parts):
        try:
            for i in parts:
                with lock:
                    complete = app.search_batch_async(queries[8 * i:8 * i + 8],
                                                      use_cache=False)
                assert complete.pipelined
                got[i] = complete()
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(range(k, 8, 2),)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for i in range(8):
        assert [[(d.doc_id, s) for d, s in h] for h in got[i]] == \
            [[(d.doc_id, s) for d, s in h] for h in ref[i]], i


def test_agentic_run_on_card_equals_cpu(card, tmp_path):
    """RAGOrchestrator.run over the same corpus and float32 weights on the
    card and on the CPU, driven by the same scripted mock LLM (4 effective
    queries, one search_rows of B = 4): the same fused doc ids in the same
    order (up to swaps of docs tied within tests/_torch_parity.py's
    tolerance), the same plan and answer; the run launches the scan."""
    import json

    from radiant_rag_tpu_torch.config import config_from_dict
    from radiant_rag_tpu_torch.index.bm25 import PersistentBM25Index
    from radiant_rag_tpu_torch.index.store import TpuVectorStore
    from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
    from radiant_rag_tpu_torch.llm.client import LLMClient
    from radiant_rag_tpu_torch.models.registry import LocalNLPModels
    from radiant_rag_tpu_torch.orchestrator import RAGOrchestrator

    from _torch_parity import assert_rows_match

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(17)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (800, 30)) % 3000]
    plan = {"use_decomposition": True, "use_rewrite": False, "use_expansion": True,
            "retrieval_mode": "hybrid"}

    def responder(messages):
        last = messages[-1]["content"]
        if "query-planning agent" in last:
            return json.dumps(plan)
        if "Decompose the question" in last:
            return json.dumps([" ".join(texts[3].split()[:5]), " ".join(texts[9].split()[:5])])
        if "alternative phrasings" in last:
            return json.dumps([" ".join(texts[i].split()[2:7]) for i in (3, 9)])
        if "Evaluate this answer" in last:
            return json.dumps({"confidence": 0.9, "should_retry": False})
        return "[]" if "JSON" in last else "An answer [DOC 1]."

    emb_c, ce_c = _small_models("cpu", "float32")
    vecs = emb_c.embed(texts)
    out = []
    for dev in ("cpu", card):
        emb, ce = ((emb_c, ce_c) if dev == "cpu" else
                   _small_models(dev, "float32", (_state(emb_c.model), _state(ce_c.model))))
        cfg = config_from_dict({
            "index": {"dim": 64}, "bm25": {"sketch_dim": 256},
            "retrieval": {"fusion_weighting": "equal"},
            "rerank": {"auto_disable_probes": 0},
            "context_eval": {"min_mean_score": -1.0},
            "strategy_memory": {"enabled": False}})
        store = TpuVectorStore(dim=64, index_config=cfg.index, device=dev)
        store.upsert_batch([(t, {"source": f"doc{i}"}, vecs[i]) for i, t in enumerate(texts)])
        bm = PersistentBM25Index(store, path=str(tmp_path / f"{dev}.json.gz"), sketch_dim=256,
                                 device=dev)
        bm.build_from_store()
        orch = RAGOrchestrator(cfg, store, bm, LocalNLPModels(embedder=emb, cross_encoder=ce),
                               LLMClient(backend=MockLLMBackend(responder=responder)))
        launches = ck.int8_scan_topk.launches
        res = orch.run("Tell me everything these two documents say about their own words")
        out.append(res)
        if dev != "cpu":
            assert ck.int8_scan_topk.launches > launches
    ref, got = out
    assert got.success and got.plan == ref.plan and got.answer == ref.answer
    assert got.effective_queries == ref.effective_queries and len(got.effective_queries) == 4
    ids = {}
    rows = [[ids.setdefault(d.doc_id, len(ids)) for d, _ in r.fused_docs] for r in (ref, got)]
    scores = [[s for _, s in r.fused_docs] for r in (ref, got)]
    assert len(rows[0]) == len(rows[1]) > 0
    assert_rows_match([rows[0]], [scores[0]], [rows[1]], [scores[1]], "agentic fused docs")


@pytest.mark.parametrize("kind", ["contrastive", "ce_listwise"])
def test_train_steps_on_card_equal_cpu(card, kind):
    """Three AdamW steps (warmup + cosine) of a small float32 model on the
    card and on the CPU from the same init and batches: losses within rtol
    1e-4, params within 2e-5 but for the leaves whose exact gradient is 0
    (tests/test_torch_train.py), held within steps x lr."""
    from radiant_rag_tpu_torch.models.bert import BertConfig, BertEncoder, init_module
    from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoderModel
    from radiant_rag_tpu_torch.parallel import train as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BertConfig(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=128, dtype=torch.float32)
    lr = 1e-3
    rng = np.random.default_rng(5)
    if kind == "contrastive":
        make, build = tt.make_train_state, lambda dev: tt.contrastive_train_step(dev)
        init = init_module(BertEncoder(cfg), 3).state_dict()
        batches = [{f"{s}_{n}": (rng.integers(1, 300, (r, 24)).astype(np.int32) if n == "ids"
                                 else np.ones((r, 24), np.int32))
                    for s, r in (("q", 8), ("d", 8), ("n", 16)) for n in ("ids", "mask")}
                   for _ in range(3)]
    else:
        make = tt.make_ce_train_state
        build = lambda dev: tt.cross_encoder_train_step(dev, group=4)  # noqa: E731
        init = init_module(CrossEncoderModel(cfg), 3).state_dict()
        batches = [{"ids": rng.integers(1, 300, (16, 32)).astype(np.int32),
                    "mask": np.ones((16, 32), np.int32),
                    "type_ids": np.repeat([[0] * 12 + [1] * 20], 16, 0).astype(np.int32),
                    "labels": np.tile([1, 0, 0, 0], 4).astype(np.int32)} for _ in range(3)]
    runs = []
    for dev in ("cpu", card):
        state = make(cfg, learning_rate=lr, schedule_steps=20, init_params_tree=init,
                     device=dev)
        step, place = build(dev)
        losses = []
        for b in batches:
            state, met = step(state, place(b))
            losses.append(met["loss"].item())
        runs.append((losses, {k: v.cpu() for k, v in state.params.items()}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    for name, ref in runs[0][1].items():
        zero = name.endswith("attention.key.bias") or (kind == "ce_listwise"
                                                       and name == "classifier.bias")
        torch.testing.assert_close(runs[1][1][name], ref, rtol=0,
                                   atol=3 * lr if zero else 2e-5, msg=name)


@pytest.mark.parametrize("shards", [1, 4])
def test_pod_on_card_equals_cpu(card, shards):
    """The sharded hybrid index on the card (one shard, or 4 logical shards
    of one card) against the same index on the CPU (plain versions): the
    kernels launch once a shard a leg, and every leg matches under
    tests/_torch_parity.py's rule; exact mode's merge equals the
    single-device exact search."""
    from radiant_rag_tpu_torch.index.bm25 import BM25Index
    from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
    from radiant_rag_tpu_torch.parallel.mesh import create_mesh
    from radiant_rag_tpu_torch.parallel.sharded_index import ShardedHybridIndex

    rng = np.random.default_rng(11)
    n, d, b = 9000, 384, 37
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (n, 24)) % 3000]
    q = vecs[:b] + 0.2 * rng.standard_normal((b, d)).astype(np.float32)
    qt = [" ".join(t.split()[:5]) for t in texts[:b]]
    out = {}
    for dev in ("cpu", "cuda"):
        bm = BM25Index(device=dev)
        bm.bulk_build(list(range(n)), texts)
        idx = ShardedHybridIndex(create_mesh(shards, 1, devices=[dev] * shards), vecs, bm)
        before = (ck.hamming_scan_topk.launches, ck.int8_scan_topk.launches)
        out[dev] = idx.hybrid_search(q, qt, dense_k=60, bm25_k=60, fused_k=10)
        launched = (ck.hamming_scan_topk.launches - before[0],
                    ck.int8_scan_topk.launches - before[1])
        assert launched == ((shards, shards) if dev == "cuda" else (0, 0))
        if dev == "cuda":
            eng = DeviceVectorIndex(d, initial_capacity=n, device=dev)
            eng.append(vecs, np.zeros(n, np.int8), np.zeros(n, np.int32), np.full(n, 24.0))
            got = idx.search(q, 10, mode="exact")
            want = eng.search(q / np.linalg.norm(q, axis=1, keepdims=True), 10, mode="exact")
            assert_result_match({"exact": want}, {"exact": got}, "exact merge")
    assert_result_match(out["cpu"], out["cuda"], f"{shards} shard(s)")


def _clustered(seed, n, d):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32)
    v = centers[rng.integers(0, 16, n)] + 0.4 * rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_graph_engine_on_card_equals_cpu(card):
    """The exact build and the beam search on the card against the port's
    plain run on the CPU over a 4,096-row graph: the same edges up to
    near-ties; over one graph (the CPU's, carried to the card) the same
    rows, scores within tests/_torch_parity.py's rule."""
    from radiant_rag_tpu_torch.index.graph import GraphIndex

    assert not torch.backends.cuda.matmul.allow_tf32
    n, d = 4096, 384
    vecs = _clustered(40, n, d)
    q = _clustered(41, 64, d)
    idx = {dev: GraphIndex(degree=16, n_long_edges=4, steps=6, device=dev)
           for dev in ("cpu", "cuda")}
    for dev, gi in idx.items():
        gi.build(torch.from_numpy(vecs).to(dev))
    assert_edges_match(idx["cpu"].neighbors.numpy(), idx["cuda"].neighbors.cpu().numpy(),
                       vecs, 16, what="exact build")
    cpu, gpu = idx["cpu"], idx["cuda"]
    for name in ("neighbors", "entry_points", "entry_sample_rows", "entry_sample_vecs"):
        setattr(gpu, name, getattr(cpu, name).to(card))
    mask = torch.from_numpy(np.random.default_rng(42).random(n) > 0.1)
    for ef in (16, 100):
        ws, wi = cpu.search(torch.from_numpy(vecs), q, k=10, ef=ef, mask=mask)
        gs, gi_ = gpu.search(torch.from_numpy(vecs).to(card), q, k=10, ef=ef,
                             mask=mask.to(card))
        assert_result_match({"graph": (ws, wi)}, {"graph": (gs, gi_)}, f"ef {ef}")


def test_two_level_descent_on_card(card, monkeypatch):
    """nn_descent_graph's two_level path (above 2^18 live rows; too slow for
    the CPU suite) on the card: it runs the subsample descent and the
    nearest-sample init, and its graph is well formed: every KNN edge a
    live row other than its source, no row repeating an edge, long edges
    from the live pool."""
    from radiant_rag_tpu_torch.index import graph as tg

    n, deg = 270_000, 4
    vecs = _clustered(43, n, 8)
    valid = np.ones(n, bool)
    valid[::1000] = False  # 269,730 live rows
    calls = []
    nearest = tg._nearest_sample_block
    monkeypatch.setattr(tg, "_nearest_sample_block",
                        lambda *a: calls.append(1) or nearest(*a))
    adj = tg.nn_descent_graph(torch.from_numpy(vecs).to(card), degree=deg, n_long_edges=2,
                              iters=2, valid=valid, two_level=True)
    assert calls and adj.shape == (n, deg + 2) and adj.dtype == np.int32
    knn = adj[:, :deg]
    assert (knn >= 0).all() and valid[knn].all()
    assert not (knn == np.arange(n)[:, None]).any()
    srt = np.sort(knn, axis=1)
    assert not (srt[:, 1:] == srt[:, :-1]).any()
    assert valid[adj[:, deg:]].all()


def test_mmr_template_on_card_equals_cpu(card):
    """TEMPLATE 4's MMR (`agents/agent_template._mmr_select`, plain PyTorch)
    on the card picks what the CPU picks over the same float32 vectors, and
    its agent runs the selection there as a device stage."""
    from radiant_rag_tpu_torch.agents.agent_template import _mmr_select

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(12)
    for n, d, k, lam in ((40, 384, 10, 0.7), (200, 64, 25, 0.5), (8, 32, 8, 0.0)):
        vecs = rng.standard_normal((n, d)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        qv = vecs[1] + 0.2 * rng.standard_normal(d).astype(np.float32)
        cpu = _mmr_select(torch.from_numpy(vecs), torch.from_numpy(qv), lam, k)
        got = _mmr_select(torch.from_numpy(vecs).to(card), torch.from_numpy(qv).to(card), lam, k)
        assert got.device.type == "cuda" and got.cpu().tolist() == cpu.tolist()


def test_profiler_trace_on_card_names_the_kernels(card, tmp_path):
    """`utils/profiling.profiler_trace` records CUDA activity: the Chrome
    trace holds the scan kernel's launches under their names and the
    annotation; `device_timer` copies the output to the host."""
    import json

    from radiant_rag_tpu_torch.utils.profiling import annotate, device_timer, profiler_trace

    codes, qi, mask = _inputs(3, 20_000, 384, 64, -127, 128, card)
    ck.int8_scan_topk(codes, qi, mask, 40)
    torch.cuda.synchronize()
    with profiler_trace(str(tmp_path / "tr")):
        with annotate("scan.window"):
            for _ in range(3):
                ck.int8_scan_topk(codes, qi, mask, 40)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    kernels = [e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    assert any("scan" in name for name in kernels), sorted(set(kernels))[:20]
    assert any(e.get("name") == "scan.window" for e in trace["traceEvents"])
    stats = device_timer(lambda: ck.int8_scan_topk(codes, qi, mask, 40), iters=3)
    assert 0 < stats["min_ms"] <= stats["median_ms"] <= stats["max_ms"]


def test_program_spans_add_no_device_rows_on_card(card):
    """A program span (`annotate`) is a host range only: the CUDA trace
    holds no device row of its name, where a `record_function` user
    annotation gets one spanning its kernels, and a reader that counts
    device rows as kernels would count it. The scan launched inside the
    span is found by its launch time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from radiant_rag_tpu_torch.utils.profiling import annotate

    codes, qi, mask = _inputs(4, 20_000, 384, 64, -127, 128, card)
    ck.int8_scan_topk(codes, qi, mask, 40)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with annotate("hybrid.dense"):
            ck.int8_scan_topk(codes, qi, mask, 40)
        with record_function("user.range"):
            ck.int8_scan_topk(codes, qi, mask, 40)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    on_card = {e.name() for e in events if e.device_type() == cuda}
    assert "hybrid.dense" not in on_card and "user.range" in on_card, sorted(on_card)[:20]
    (span,) = [e for e in events if e.name() == "hybrid.dense" and e.device_type() == cpu]
    s0, s1 = span.start_ns(), span.start_ns() + span.duration_ns()
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == cpu and e.name().startswith("cu")}
    scans = [launched.get(e.correlation_id(), -1) for e in events
             if e.device_type() == cuda and "scan_topk" in e.name()]
    assert sum(s0 <= t <= s1 for t in scans) >= 1, (s0, s1, scans)


@pytest.mark.parametrize("kind", ["contrastive", "ce_listwise"])
def test_mesh_of_logical_shards_on_card_equals_one_by_one(card, kind):
    """The dp x tp layout on the card: a (2, 2) mesh of cuda:0 (logical
    shards) against the (1, 1) mesh, three float32 AdamW steps from the
    same init and batches: losses within rtol 1e-5, params within 2e-5
    but for the zero-gradient leaves (within steps x lr), as
    tests/test_torch_parallel_train.py holds them on the CPU."""
    from radiant_rag_tpu_torch.models.bert import BertConfig, BertEncoder, init_module
    from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoderModel
    from radiant_rag_tpu_torch.parallel import train as tt
    from radiant_rag_tpu_torch.parallel.mesh import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BertConfig(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
                     intermediate_size=128, dtype=torch.float32)
    lr, rng = 1e-3, np.random.default_rng(6)
    if kind == "contrastive":
        make, build = tt.make_train_state, tt.contrastive_train_step
        init = init_module(BertEncoder(cfg), 3).state_dict()
        batches = [{f"{s}_{n}": (rng.integers(1, 300, (r, 24)).astype(np.int32) if n == "ids"
                                 else np.ones((r, 24), np.int32))
                    for s, r in (("q", 8), ("d", 8), ("n", 16)) for n in ("ids", "mask")}
                   for _ in range(3)]
    else:
        make = tt.make_ce_train_state
        build = lambda mesh: tt.cross_encoder_train_step(mesh, group=4)  # noqa: E731
        init = init_module(CrossEncoderModel(cfg), 3).state_dict()
        batches = [{"ids": rng.integers(1, 300, (16, 32)).astype(np.int32),
                    "mask": np.ones((16, 32), np.int32),
                    "type_ids": np.repeat([[0] * 12 + [1] * 20], 16, 0).astype(np.int32),
                    "labels": np.tile([1, 0, 0, 0], 4).astype(np.int32)} for _ in range(3)]
    runs = []
    for shape in ((1, 1), (2, 2)):
        mesh = create_mesh(data=shape[0], model=shape[1], devices=[card] * 4)
        state = make(cfg, mesh, lr, schedule_steps=20, init_params_tree=init)
        step, place = build(mesh)
        losses = []
        for b in batches:
            state, met = step(state, place(b))
            losses.append(met["loss"].item())
        runs.append((losses, {k: v.cpu() for k, v in state.params.items()}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for name, ref in runs[0][1].items():
        zero = name.endswith("attention.key.bias") or (kind == "ce_listwise"
                                                       and name == "classifier.bias")
        torch.testing.assert_close(runs[1][1][name], ref, rtol=0,
                                   atol=3 * lr if zero else 2e-5, msg=name)
