"""Stage 1 at any depth and width (CPU).

The fused scan kernels keep per-query lists of at most
`INT8_SCAN_TOPK_MAX_K` = 512 entries. A deeper stage 1 (the
quality-optimized preset's kc = 960, `DeviceVectorIndex.search(top_k=129)`)
takes the exact-product route of `similarity.scan_select` /
`hamming_scan_topk`: the (b, N) product of the score kernel a block of
queries at a time, then an exact top-k. The int8 wrappers take any D the
int32 accumulator holds, zero-padding D to a multiple of 16 for the tile.

Held here: the route by k, the query block from a memory budget (the
card's free memory, measured by `similarity.route_budget`), the pad,
the plain versions' exactness above D = 1024, and parity with the JAX
package (which selects any k over its full (B, N) scores) at the quality
preset's arguments and at D = 1536 and 100. Tolerance: tests/_torch_parity.py
(exact rows and ranks; scores rtol 1e-5 / atol 1e-6); integer outputs exact.
The binary stage 1 keeps the boundary-tie rule of tests/test_torch_binary.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from radiant_rag_tpu.index.bm25 import BM25Index as JaxBM25
from radiant_rag_tpu.index.engine import DeviceVectorIndex as JaxEngine
from radiant_rag_tpu.index.hybrid import HybridSearcher as JaxHybrid
from radiant_rag_tpu.ops import quantize as jq
from radiant_rag_tpu.ops import similarity as jsim
from radiant_rag_tpu_torch.config import config_from_dict
from radiant_rag_tpu_torch.index.bm25 import BM25Index
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
from radiant_rag_tpu_torch.index.hybrid import HybridSearcher, resolve_fused_depth
from radiant_rag_tpu_torch.ops import bm25 as tbm
from radiant_rag_tpu_torch.ops import cuda_kernels as ck
from radiant_rag_tpu_torch.ops import similarity as tsim

from _torch_parity import assert_result_match, assert_rows_match
from test_torch_binary import _stage1_raw, assert_binary_rows_match

T = torch.from_numpy

# config.quality-optimized.example.yaml's retrieval settings
QUALITY = {"quantization": {"rescore_multiplier": 8.0},
           "retrieval": {"dense_top_k": 20, "bm25_top_k": 20, "fused_top_k": 30}}


# -- the route ---------------------------------------------------------------

@pytest.mark.parametrize("k,route", [(1, "scan"), (40, "scan"), (360, "scan"), (512, "scan"),
                                     (513, "product"), (960, "product"), (5000, "product")])
def test_route_by_k(k, route):
    assert ck.INT8_SCAN_TOPK_MAX_K == 512
    assert tsim.stage1_route(k) == route


@pytest.mark.parametrize("n,b,budget,block", [
    (1 << 20, 2048, 2048 * (1 << 20) * 24 - 1, 2047),  # one cell short of the batch
    (1 << 20, 2048, 2048 * (1 << 20) * 24, 2048),      # the whole batch fits
    (1 << 20, 2048, 100 * (1 << 20) * 24 + 5, 100),
    (1 << 20, 2048, 0, 1),                             # never below one query
    (1000, 3, 10**12, 3), (1000, 0, 10**12, 1)])
def test_product_query_block_from_budget(n, b, budget, block):
    assert tsim.SCORE_BYTES_PER_CELL == 24
    assert tsim.product_query_block(n, b, budget) == block


def test_route_budget_off_the_card():
    """Off a card the route's budget is the fixed test-size one (on a card
    it is measured: tests/test_torch_cuda.py)."""
    assert tsim.route_budget(torch.device("cpu")) == tsim.CPU_ROUTE_BYTES == 16 << 30
    assert tsim.product_query_block(4096, 2048, tsim.route_budget(torch.device("cpu"))) == 2048


def _budget(monkeypatch, budget):
    """Run the exact-product route under `budget` bytes (None: as measured);
    returns the budget in force."""
    if budget is None:
        return tsim.route_budget(torch.device("cpu"))
    monkeypatch.setattr(tsim, "route_budget", lambda device: budget)
    return budget


def _i8(seed, n, d, b, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(lo, hi, (n, d), dtype=np.int8)
    codes[n // 2:n // 2 + 6] = codes[9]  # duplicates: ties at the boundary
    qi = rng.integers(lo, hi, (b, d), dtype=np.int8)
    mask = rng.random(n) > 0.1
    return T(codes), T(qi), T(mask)


class _Spy:
    """Counts calls of a cuda_kernels wrapper (and calls it)."""

    def __init__(self, monkeypatch, name):
        self.fn, self.calls = getattr(ck, name), 0
        monkeypatch.setattr(ck, name, self)

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


@pytest.mark.parametrize("k", [40, 512, 513, 960])
@pytest.mark.parametrize("budget", [None, 3 * 3000 * 24])
def test_scan_select_routes_by_k(monkeypatch, k, budget):
    """k <= 512 launches the scan and no product; above, the product a
    block of queries at a time (3 per step under the budget) and no scan.
    Both equal the scan's plain version exactly."""
    codes, qi, mask = _i8(k, 3000, 48, 8)
    scan, scores = _Spy(monkeypatch, "int8_scan_topk"), _Spy(monkeypatch, "int8_scores")
    steps = -(-8 // tsim.product_query_block(3000, 8, _budget(monkeypatch, budget)))
    s, r = tsim.scan_select(codes, qi, mask, k, "f32")
    assert (scan.calls, scores.calls) == ((1, 0) if k <= 512 else (0, steps))
    ps, pr = ck.int8_scan_topk_reference(codes, qi, mask, k)
    assert torch.equal(r, pr) and torch.equal(s, ps)


@pytest.mark.parametrize("k", [360, 513, 960])
@pytest.mark.parametrize("budget", [None, 5 * 2500 * 24])
def test_hamming_scan_topk_routes_by_k(monkeypatch, k, budget):
    rng = np.random.default_rng(k)
    words = rng.integers(0, 2**32, (2500, 12), dtype=np.uint64).astype(np.uint32)
    words &= np.uint32(0x0F0F0F0F)  # few distinct words: ties at every k
    q = rng.integers(0, 2**32, (7, 12), dtype=np.uint64).astype(np.uint32)
    mask = T(rng.random(2500) > 0.1)
    codes, qw = T(words.view(np.int32)), T(q.view(np.int32))
    scan, scores = _Spy(monkeypatch, "hamming_scan_topk"), _Spy(monkeypatch, "hamming_scores")
    steps = -(-7 // tsim.product_query_block(2500, 7, _budget(monkeypatch, budget)))
    s, r = tsim.hamming_scan_topk(codes, qw, mask, k)
    assert (scan.calls, scores.calls) == ((1, 0) if k <= 512 else (0, steps))
    ps, pr = ck.hamming_scan_topk_reference(codes, qw, mask, k)
    np.testing.assert_array_equal(r.numpy(), pr.numpy())
    inv = float(torch.tensor(1 / 384, dtype=torch.float32))
    assert torch.equal(s, torch.where(pr > -1, ps * inv, tsim.NEG_INF))


# -- widths ------------------------------------------------------------------

@pytest.mark.parametrize("d,d16", [(1, 16), (16, 16), (100, 112), (300, 304), (384, 384),
                                   (1536, 1536), (1537, 1552)])
def test_pad_only_where_d_is_off_16(d, d16):
    assert ck.padded_width(d) == d16
    codes, qi, _ = _i8(d, 200, d, 3, -128, 128)
    pc, pq = ck._pad16(codes, qi)
    assert pc.shape == (200, d16) and pq.shape == (3, d16)
    assert (pc is codes) == (d == d16) and (pq is qi) == (d == d16)
    assert not pc[:, d:].any() and not pq[:, d:].any()
    assert torch.equal(ck.int8_scores_reference(pc, pq), ck.int8_scores_reference(codes, qi))


def test_width_checks_follow_int32_exactness():
    """D up to 2^17 - 1: |score| <= 128^2 * D < 2^31; W up to 2^12 - 1."""
    assert 128 * 128 * ck.MAX_D < 2**31 <= 128 * 128 * (ck.MAX_D + 1)
    for d in (100, 1536, ck.MAX_D):
        ck._check(torch.zeros((2, d), dtype=torch.int8), torch.zeros((1, d), dtype=torch.int8),
                  None)
    with pytest.raises(ValueError, match="exact int32"):
        d = ck.MAX_D + 1
        ck._check(torch.zeros((2, d), dtype=torch.int8), torch.zeros((1, d), dtype=torch.int8),
                  None)
    ck._check_words(torch.zeros((2, 48), dtype=torch.int32), torch.zeros((1, 48), dtype=torch.int32))
    with pytest.raises(ValueError):
        ck._check_words(torch.zeros((2, 4096), dtype=torch.int32),
                        torch.zeros((1, 4096), dtype=torch.int32))


def test_plain_versions_stay_exact_above_d_1024():
    """At D = 1536 an fp32 matmul would round |score| > 2^24; the plain
    versions sum in float64 there and equal numpy's int64 product."""
    rng = np.random.default_rng(5)
    n, d = 1100, 1536
    codes = np.where(rng.random((n, d)) < 0.5, -127, 127).astype(np.int8)
    codes[:, :1000] = 127  # scores near 127^2 x 1536 ~ 2.5e7 > 2^24
    qi = np.full((4, d), 127, np.int8)
    qi[:, 1500] = -126
    dots = qi.astype(np.int64) @ codes.astype(np.int64).T
    assert np.abs(dots).max() > 2**24
    np.testing.assert_array_equal(ck.int8_scores_reference(T(codes), T(qi)).numpy(), dots)
    s, r = ck.int8_scan_topk_reference(T(codes), T(qi), None, 700)
    order = np.argsort(-dots, axis=1, kind="stable")[:, :700]
    np.testing.assert_array_equal(r.numpy(), order)
    np.testing.assert_array_equal(s.numpy(), np.take_along_axis(dots, order, 1).astype(np.float32))
    bs, br = ck.blockmax2_reference(T(codes), T(qi), None)
    assert br.shape == (4, 2 * 3)
    for q in range(4):
        for t in range(3):
            seg = dots[q, 512 * t:512 * (t + 1)]
            top = np.argsort(-seg, kind="stable")[:2]
            assert [br[q, t], br[q, 3 + t]] == list(512 * t + top)


def _corpus(seed, n, d, b=16):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = corpus[rng.integers(0, n, b)] + 0.2 * rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = rng.random(n) > 0.1
    lo, hi = jq.calibrate_int8_ranges(jnp.asarray(corpus))
    codes = np.asarray(jq.quantize_int8(jnp.asarray(corpus), lo, hi))
    sc, of = (np.asarray(a) for a in jq.int8_scale_offset(lo, hi))
    return corpus, q, mask, codes, sc, of


@pytest.mark.parametrize("d", [1536, 100])
@pytest.mark.parametrize("kc", [40, 960])
def test_int8_two_stage_at_wide_and_odd_d_matches_jax(d, kc):
    corpus, q, mask, codes, sc, of = _corpus(d + kc, 4096, d)
    js, ji = jsim.two_stage_topk(jnp.asarray(corpus), jnp.asarray(q), jnp.asarray(mask), 10,
                                 kc, "int8", int8_codes=jnp.asarray(codes),
                                 int8_scale=jnp.asarray(sc), int8_offset=jnp.asarray(of),
                                 select="f32")
    ts, ti = tsim.two_stage_topk(T(corpus), T(q), T(mask), 10, kc, "int8", int8_codes=T(codes),
                                 int8_scale=T(sc), int8_offset=T(of), select="f32")
    assert_rows_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy(),
                      f"two_stage D={d} kc={kc}")


# -- the quality preset and deep engine searches, against the JAX package -----

N, D, S = 4096, 64, 256


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((32, D)).astype(np.float32)
    vecs = centers[rng.integers(0, 32, N)] + 0.7 * rng.standard_normal((N, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (N, 24)) % 2000]
    levels = np.zeros(N, np.int8)
    langs = np.zeros(N, np.int32)
    lens = np.asarray([len(t.split()) for t in texts], np.float32)
    je = JaxEngine(D, initial_capacity=N)
    te = DeviceVectorIndex(D, initial_capacity=N, device="cpu")
    for eng in (je, te):
        for s in range(0, N, 1024):
            eng.append(vecs[s:s + 1024], levels[s:s + 1024], langs[s:s + 1024],
                       lens[s:s + 1024])
        eng.invalidate(np.asarray([2, 700, 4000]))
    jb, tb = JaxBM25(sketch_dim=S), BM25Index(sketch_dim=S, device="cpu")
    jb.bulk_build(list(range(N)), texts)
    tb.bulk_build(list(range(N)), texts)
    qidx = rng.integers(0, N, 12)
    q = vecs[qidx] + 0.25 * rng.standard_normal((12, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = [" ".join(texts[i].split()[:6]) for i in qidx]
    return JaxHybrid(je, jb), HybridSearcher(te, tb), q, qt


def _quality_args():
    cfg = config_from_dict(QUALITY)
    r = cfg.retrieval
    return dict(dense_k=r.dense_top_k, bm25_k=r.bm25_top_k, fused_k=r.fused_top_k,
                fused_depth=resolve_fused_depth(r),
                rescore_multiplier=cfg.quantization.rescore_multiplier)


def test_quality_preset_literals_are_the_shipped_file():
    """This file's and chip_smoke.py's copies of the preset (the card's
    machine has no PyYAML) equal config.quality-optimized.example.yaml."""
    import importlib.util
    from pathlib import Path

    import yaml

    repo = Path(__file__).resolve().parent.parent
    with open(repo / "config.quality-optimized.example.yaml") as fh:
        shipped = yaml.safe_load(fh)
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.QUALITY_OPTIMIZED_PRESET == shipped
    assert all(shipped[sec][key] == v for sec in QUALITY for key, v in QUALITY[sec].items())


def test_quality_preset_reaches_kc_960():
    kw = _quality_args()
    assert kw["fused_depth"] == 120 and kw["rescore_multiplier"] == 8.0
    assert tsim.stage1_route(round(kw["fused_depth"] * kw["rescore_multiplier"])) == "product"


@pytest.mark.parametrize("bm25_mode", ["sketch", "pages"])
def test_quality_preset_search_rows_matches_jax(world, monkeypatch, bm25_mode):
    """int8 mode, kc = bm_kc = 960 on both legs: every leg exactly, through
    the exact-product route (no scan launched)."""
    jh, th, q, qt = world
    scan = _Spy(monkeypatch, "int8_scan_topk")
    kw = dict(_quality_args(), mode="int8", bm25_mode=bm25_mode)
    ref, got = jh.search_rows(q, qt, **kw), th.search_rows(q, qt, **kw)
    assert_result_match(ref, got, f"quality preset {bm25_mode}")
    assert scan.calls == 0
    assert (got["fused"][1][:, 0] >= 0).all() and got["fused"][1].shape == (12, 30)


def test_quality_preset_binary_search_rows_matches_jax(world):
    """Binary mode: the dense leg's Hamming stage 1 at kc = 960 under the
    boundary-tie rule, the sketch leg exactly."""
    jh, th, q, qt = world
    kw = dict(_quality_args(), mode="binary", bm25_mode="sketch")
    ref, got = jh.search_rows(q, qt, **kw), th.search_rows(q, qt, **kw)
    raw, mask = _stage1_raw(jh.engine, q.astype(np.float16).astype(np.float32))
    assert_binary_rows_match(ref["dense"][1], ref["dense"][0], got["dense"][1],
                             got["dense"][0], raw, mask, 960, "quality binary dense")
    assert_rows_match(ref["bm25"][1], ref["bm25"][0], got["bm25"][1], got["bm25"][0],
                      "quality binary bm25")


def test_quality_preset_steps_under_a_small_budget(world, monkeypatch):
    """A budget of 5 queries per step gives the one-step results exactly:
    12 queries, padded to the 16-query bucket, in 4 steps on each leg."""
    _, th, q, qt = world
    kw = dict(_quality_args(), mode="int8", bm25_mode="sketch")
    full = th.search_rows(q, qt, **kw)
    n = th.engine.capacity
    _budget(monkeypatch, 5 * n * tsim.SCORE_BYTES_PER_CELL + n)
    scores = _Spy(monkeypatch, "int8_scores")
    stepped = th.search_rows(q, qt, **kw)
    assert scores.calls == 2 * 4
    for leg in full:
        np.testing.assert_array_equal(stepped[leg][1], full[leg][1])
        np.testing.assert_array_equal(stepped[leg][0], full[leg][0])


def test_standalone_bm25_sketch_search_steps_under_a_small_budget(world, monkeypatch):
    """`BM25Index.search_rows_batch` (no hybrid searcher, no engine) at
    top_k 65 x 8.0 = kc 520 > 512: the exact-product route under a budget of
    4 queries per step gives the one-step results exactly, 12 queries in 3
    steps, and no scan."""
    _, th, _, qt = world
    bm, n = th.bm25, th.engine.capacity
    kw = dict(top_k=65, num_rows=n, method="sketch", rescore_multiplier=8.0)
    full = bm.search_rows_batch(qt, **kw)
    _budget(monkeypatch, 4 * n * tsim.SCORE_BYTES_PER_CELL)
    scan, scores = _Spy(monkeypatch, "int8_scan_topk"), _Spy(monkeypatch, "int8_scores")
    stepped = bm.search_rows_batch(qt, **kw)
    assert (scan.calls, scores.calls) == (0, 3)
    np.testing.assert_array_equal(stepped[1], full[1])
    np.testing.assert_array_equal(stepped[0], full[0])
    assert (full[1][:, 0] >= 0).all()


@pytest.mark.parametrize("mode", ["int8", "binary"])
def test_engine_search_top_k_129_matches_jax(world, mode):
    """top_k = 129 at the default multiplier 4.0: kc = 516 > 512."""
    jh, th, q, _ = world
    js, jr = jh.engine.search(q, 129, mode=mode)
    ts, tr = th.engine.search(q, 129, mode=mode)
    assert tr.shape == (12, 129)
    if mode == "int8":
        assert_rows_match(jr, js, tr, ts, "engine int8 top_k 129")
    else:
        raw, mask = _stage1_raw(jh.engine, q)
        assert_binary_rows_match(jr, js, tr, ts, raw, mask, 516, "engine binary top_k 129")


# -- C2: B x N >= 2^31 in the pages scatter ----------------------------------

class _IndexPuts(TorchDispatchMode):
    """Records the index dtypes of every index_put on the way."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.startswith(("index_put", "_index_put_impl")):
            self.calls.append([i.dtype for i in args[1] if i is not None])
        return func(*args, **(kwargs or {}))


def test_pages_scatter_at_2048_by_2_20_uses_2d_int64_indices():
    """B = 2048 queries over a 2^20-row corpus: B x N = 2^31 cells, past
    int32 flat offsets. On the meta device (shapes only, no memory) the
    scatter runs with two int64 index tensors (query, row), no flat index."""
    b, n, pages = 2048, 1 << 20, 64
    meta = torch.device("meta")
    post_rows = torch.empty(pages * tbm.PAGE_SIZE, dtype=torch.int32, device=meta)
    post_tf = torch.empty(pages * tbm.PAGE_SIZE, dtype=torch.float32, device=meta)
    page_start = torch.empty(pages, dtype=torch.int32, device=meta)
    page_len = torch.empty(pages, dtype=torch.int32, device=meta)
    page_qidx = torch.empty(pages, dtype=torch.int32, device=meta)
    page_idf = torch.empty(pages, dtype=torch.float32, device=meta)
    doc_lens = torch.empty(n, dtype=torch.float32, device=meta)
    avgdl = torch.empty((), dtype=torch.float32, device=meta)
    mask = torch.empty(n, dtype=torch.bool, device=meta)
    rec = _IndexPuts()
    with rec:
        scores = tbm.bm25_pages_scores(post_rows, post_tf, page_start, page_len, page_qidx,
                                       page_idf, doc_lens, avgdl, mask, b, n)
    assert scores.shape == (b, n) and scores.numel() >= 2**31
    assert rec.calls and all(c == [torch.int64, torch.int64] for c in rec.calls), rec.calls
