"""Parity of the PyTorch port's ops with the JAX package (CPU).

Each case feeds the same numpy inputs, made from a seed, to the JAX function
and to its counterpart in `radiant_rag_tpu_torch` (device="cpu": the plain
PyTorch versions of the kernels). The Pallas kernels run in interpret mode,
as tests/test_pallas.py runs them. Tolerance: tests/_torch_parity.py
(exact rows and ranks; scores rtol 1e-5 / atol 1e-6); integer kernel
outputs must be exactly equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from radiant_rag_tpu.ops import bm25 as jbm
from radiant_rag_tpu.ops import fusion as jfu
from radiant_rag_tpu.ops import pallas_kernels as pk
from radiant_rag_tpu.ops import quantize as jq
from radiant_rag_tpu.ops import similarity as jsim
from radiant_rag_tpu_torch.ops import bm25 as tbm
from radiant_rag_tpu_torch.ops import cuda_kernels as ck
from radiant_rag_tpu_torch.ops import fusion as tfu
from radiant_rag_tpu_torch.ops import quantize as tq
from radiant_rag_tpu_torch.ops import similarity as tsim

from _torch_parity import assert_rows_match

T = torch.from_numpy


def _tie_heavy(seed, n, d, b, lo=-3, hi=4):
    """Narrow-range int8 codes with duplicated rows, a masked span and a
    fully dead 512-row tile: ties at the selection boundary are common."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(lo, hi, (n, d), dtype=np.int8)
    codes[50] = codes[10]
    codes[n - 3] = codes[10]
    qi = rng.integers(lo, hi, (b, d), dtype=np.int8)
    mask = np.ones(n, bool)
    mask[100:200] = False
    mask[512:1024] = False
    return codes, qi, mask


def _oracle_topk(codes, qi, mask, k):
    """numpy: stable argsort of the masked int64 dots (lowest row first)."""
    dots = qi.astype(np.int64) @ codes.astype(np.int64).T
    dots = np.where(mask[None, :], dots, -(2**62))
    order = np.argsort(-dots, axis=1, kind="stable")[:, :k]
    return order, dots


@pytest.mark.parametrize("k", [40, 160])
def test_scan_topk_reference_matches_pallas(k):
    codes, qi, mask = _tie_heavy(1, 4 * pk.TILE_N, 64, 8)
    js, ji = pk.int8_scan_topk_pallas(jnp.asarray(codes), jnp.asarray(qi),
                                      jnp.asarray(mask), k, interpret=True)
    ts, ti = ck.int8_scan_topk_reference(T(codes), T(qi), T(mask), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_blockmax2_reference_matches_pallas():
    codes, qi, mask = _tie_heavy(2, 8 * pk.BLOCKMAX_TILE, 64, 8)
    mask[4 * pk.BLOCKMAX_TILE + 1:5 * pk.BLOCKMAX_TILE] = False  # one valid row left
    js, jr = pk.blockmax2_pallas(jnp.asarray(codes), jnp.asarray(qi), jnp.asarray(mask),
                                 interpret=True)
    ts, tr = ck.blockmax2_reference(T(codes), T(qi), T(mask))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n,b,k", [(3001, 1, 160), (700, 3, 256), (100, 2, 160)])
def test_scan_topk_reference_ragged_matches_oracle(n, b, k):
    """N that no tile divides, B = 1, k above the number of valid rows."""
    codes, qi, _ = _tie_heavy(3, n, 32, b)
    mask = np.ones(n, bool)
    mask[::7] = False
    ts, ti = ck.int8_scan_topk_reference(T(codes), T(qi), T(mask), k)
    kk = min(k, int(mask.sum()))
    order, dots = _oracle_topk(codes, qi, mask, kk)
    np.testing.assert_array_equal(ti.numpy()[:, :kk], order)
    np.testing.assert_array_equal(ts.numpy()[:, :kk], np.take_along_axis(dots, order, 1))
    assert (ti.numpy()[:, kk:] == -1).all() and (ts.numpy()[:, kk:] == ck.NEG).all()


def test_blockmax2_reference_ragged_matches_oracle():
    n, b, tile = 1300, 3, ck.BLOCKMAX_TILE
    codes, qi, _ = _tie_heavy(4, n, 32, b)
    mask = np.ones(n, bool)
    mask[1025:1299] = False  # the ragged last tile keeps rows 1024 and 1299
    ts, tr = ck.blockmax2_reference(T(codes), T(qi), T(mask))
    nt = 3
    assert ts.shape == (b, 2 * nt)
    dots = np.where(mask[None, :], qi.astype(np.int64) @ codes.astype(np.int64).T, -(2**62))
    for q in range(b):
        for t in range(nt):
            seg = dots[q, t * tile:(t + 1) * tile]
            order = np.argsort(-seg, kind="stable")[:2]
            for slot, o in enumerate(order):
                assert tr[q, slot * nt + t] == t * tile + o
                assert ts[q, slot * nt + t] == seg[o]


def test_wrappers_take_the_plain_version_on_cpu():
    codes, qi, mask = _tie_heavy(5, 2048, 32, 4)
    before = (ck.int8_scan_topk.launches, ck.blockmax2.launches)
    s, r = ck.int8_scan_topk(T(codes), T(qi), T(mask), 40)
    rs, rr = ck.int8_scan_topk_reference(T(codes), T(qi), T(mask), 40)
    assert torch.equal(s, rs) and torch.equal(r, rr)
    s, r = ck.blockmax2(T(codes), T(qi), T(mask))
    rs, rr = ck.blockmax2_reference(T(codes), T(qi), T(mask))
    assert torch.equal(s, rs) and torch.equal(r, rr)
    assert (ck.int8_scan_topk.launches, ck.blockmax2.launches) == before


# -- quantize -----------------------------------------------------------------

def test_quantize_bit_equal():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3000, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[:, 5] = 0.25  # a degenerate dim
    jlo, jhi = jq.calibrate_int8_ranges(jnp.asarray(x[:1000]))
    tlo, thi = tq.calibrate_int8_ranges(T(x[:1000]))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tq.quantize_int8(T(x), tlo, thi).numpy(),
                                  np.asarray(jq.quantize_int8(jnp.asarray(x), jlo, jhi)))
    js, jo = jq.int8_scale_offset(jlo, jhi)
    ts, to = tq.int8_scale_offset(tlo, thi)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    codes = rng.integers(-128, 128, (50, 64)).astype(np.int8)
    np.testing.assert_allclose(tq.dequantize_int8(T(codes), tlo, thi).numpy(),
                               np.asarray(jq.dequantize_int8(jnp.asarray(codes), jlo, jhi)),
                               rtol=1e-6, atol=1e-7)
    for d in (64, 40):
        assert tq.packed_words(d) == jq.packed_words(d)
        words = tq.pack_binary(T(x[:, :d].copy())).numpy().view(np.uint32)
        np.testing.assert_array_equal(words, np.asarray(jq.pack_binary(jnp.asarray(x[:, :d]))))


# -- similarity ---------------------------------------------------------------

def _corpus(seed, n=4096, d=64, b=24):
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


def test_topk_first_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(8)
    x = rng.integers(-3, 4, (16, 300)).astype(np.float32) * 0.5
    x[0, :7] = -0.0
    x[1, 10:20] = -1e30
    for k in (1, 10, 150):
        js, ji = jax.lax.top_k(jnp.asarray(x), k)
        ts, ti = tsim.topk_first(T(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_sort_candidates_by_row():
    cand = np.asarray([[5, -1, 3, 0, -1], [-1, -1, -1, -1, -1], [9, 8, 7, 6, 5]], np.int32)
    np.testing.assert_array_equal(tsim.sort_candidates_by_row(T(cand)).numpy(),
                                  np.asarray(jsim.sort_candidates_by_row(jnp.asarray(cand))))


@pytest.mark.parametrize("select", ["f32", "blockmax"])
def test_int8_scan_topk_matches_jax(select):
    corpus, q, mask, codes, sc, of = _corpus(9)
    js, ji = jsim.int8_scan_topk(jnp.asarray(codes), jnp.asarray(q), jnp.asarray(sc),
                                 jnp.asarray(of), jnp.asarray(mask), 40, select)
    ts, ti = tsim.int8_scan_topk(T(codes), T(q), T(sc), T(of), T(mask), 40, select)
    js, ji = np.asarray(js), np.asarray(ji)
    ji = np.where(js > jsim.NEG_INF / 2, ji, -1)  # JAX keeps masked rows' ids
    assert_rows_match(ji, js, ti.numpy(), ts.numpy(), f"int8_scan_topk {select}")


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "fp32_free"])
@pytest.mark.parametrize("select", ["f32", "blockmax"])
def test_two_stage_topk_matches_jax(fp32, select):
    corpus, q, mask, codes, sc, of = _corpus(10)
    stored = corpus if fp32 else np.zeros((0, corpus.shape[1]), np.float32)
    js, ji = jsim.two_stage_topk(jnp.asarray(stored), jnp.asarray(q), jnp.asarray(mask), 10,
                                 40, "int8", int8_codes=jnp.asarray(codes),
                                 int8_scale=jnp.asarray(sc), int8_offset=jnp.asarray(of),
                                 select=select)
    ts, ti = tsim.two_stage_topk(T(stored), T(q), T(mask), 10, 40, "int8", int8_codes=T(codes),
                                 int8_scale=T(sc), int8_offset=T(of), select=select)
    assert_rows_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy(),
                      f"two_stage {select} fp32={fp32}")


def test_two_stage_hamming_not_ported():
    """The Hamming stage 1 was pinned here as unported; it is ported now, so
    this holds it against JAX where kc covers every row (no boundary tie
    can differ), and an unknown stage 1 still raises."""
    corpus, q, mask, codes, sc, of = _corpus(10, n=512, b=2)
    words = np.asarray(jq.pack_binary(jnp.asarray(corpus)))
    qwords = np.asarray(jq.pack_binary(jnp.asarray(q)))
    js, ji = jsim.two_stage_topk(jnp.asarray(corpus), jnp.asarray(q), None, 5, 512, "hamming",
                                 binary_codes=jnp.asarray(words), qbinary=jnp.asarray(qwords))
    ts, ti = tsim.two_stage_topk(T(corpus), T(q), None, 5, 512, "hamming",
                                 binary_codes=T(words.view(np.int32)),
                                 qbinary=T(qwords.view(np.int32)))
    assert_rows_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy(), "hamming")
    with pytest.raises(ValueError, match="unknown stage1"):
        tsim.two_stage_topk(T(corpus), T(q), None, 5, 20, "pq", int8_codes=T(codes))


def test_exact_topk_matches_jax():
    corpus, q, mask, *_ = _corpus(11)
    js, ji = jsim.exact_topk(jnp.asarray(corpus), jnp.asarray(q), jnp.asarray(mask), 10)
    ts, ti = tsim.exact_topk(T(corpus), T(q), T(mask), 10)
    assert_rows_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy(), "exact")


def test_blockmax_select_small_corpus_fallback_matches_jax():
    """Not a whole number of 512-row tiles: the monolithic bf16 selection.
    The selected bf16 scores equal JAX's; among equal bf16 scores the port
    takes the lowest rows (JAX's approx_max_k over bf16 orders ties
    otherwise), so rows are held to the lowest-row oracle."""
    corpus, q, mask, codes, sc, of = _corpus(12, n=768)
    qi, _ = tsim.quantize_queries(T(q), T(sc))
    js, ji = jsim.blockmax_select(jnp.asarray(codes), jnp.asarray(qi.numpy()),
                                  jnp.asarray(mask), 40)
    ts, ti = tsim.blockmax_select(T(codes), qi, T(mask), 40)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    raw = qi.numpy().astype(np.int64) @ codes.astype(np.int64).T
    bf = torch.from_numpy(raw.astype(np.float32)).to(torch.bfloat16).float().numpy()
    bf = np.where(mask[None, :], bf, -3e38)
    order = np.argsort(-bf, axis=1, kind="stable")[:, :40]
    np.testing.assert_array_equal(ti.numpy(), order)


# -- BM25 ops -----------------------------------------------------------------

def _postings(seed, n_docs=3000, n_post=20_000):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_docs, n_post).astype(np.int32)
    tfs = rng.integers(1, 5, n_post).astype(np.float32)
    doc_lens = rng.integers(5, 60, n_docs).astype(np.float32)
    return rng, rows, tfs, doc_lens


@pytest.mark.parametrize("masked", [True, False])
def test_bm25_pages_scores_matches_jax(masked):
    rng, rows, tfs, doc_lens = _postings(13)
    pg = 32
    start = rng.integers(0, len(rows) - 2048, pg).astype(np.int32)
    plen = rng.integers(0, 2048, pg).astype(np.int32)
    plen[-4:] = 0  # dead pages
    qidx = rng.integers(0, 6, pg).astype(np.int32)
    idf = rng.random(pg).astype(np.float32) * 3
    mask = rng.random(len(doc_lens)) > 0.2 if masked else None
    avgdl = np.float32(31.5)
    js = jbm.bm25_pages_scores(jnp.asarray(rows), jnp.asarray(tfs), jnp.asarray(start),
                               jnp.asarray(plen), jnp.asarray(qidx), jnp.asarray(idf),
                               jnp.asarray(doc_lens), jnp.asarray(avgdl),
                               None if mask is None else jnp.asarray(mask), 6, len(doc_lens))
    ts = tbm.bm25_pages_scores(T(rows), T(tfs), T(start), T(plen), T(qidx), T(idf),
                               T(doc_lens), torch.tensor(avgdl), None if mask is None else T(mask),
                               6, len(doc_lens))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


def test_bm25_candidate_rescore_matches_jax():
    rng = np.random.default_rng(14)
    n, width, b, kc, t = 2000, 16, 6, 40, 8
    dm_tids = np.full((n, width), -1, np.int32)
    dm_tfs = np.zeros((n, width), np.int32)
    for r in range(n):
        m = rng.integers(1, width + 1)
        dm_tids[r, :m] = rng.choice(300, m, replace=False)
        dm_tfs[r, :m] = rng.integers(1, 6, m)
    doc_lens = rng.integers(5, 80, n).astype(np.float32)
    cand = rng.integers(-1, n, (b, kc)).astype(np.int32)
    q_tids = np.where(rng.random((b, t)) < 0.8, rng.integers(0, 300, (b, t)), -1).astype(np.int32)
    q_idfs = np.where(q_tids >= 0, rng.random((b, t)) * 4, 0).astype(np.float32)
    avgdl = np.float32(40.25)
    js = jbm.bm25_candidate_rescore(jnp.asarray(dm_tids), jnp.asarray(dm_tfs),
                                    jnp.asarray(doc_lens), jnp.asarray(avgdl), jnp.asarray(cand),
                                    jnp.asarray(q_tids), jnp.asarray(q_idfs))
    ts = tbm.bm25_candidate_rescore(T(dm_tids), T(dm_tfs), T(doc_lens), torch.tensor(avgdl),
                                    T(cand), T(q_tids), T(q_idfs))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("select", ["f32", "blockmax"])
def test_bm25_sketch_select_matches_jax(select):
    rng = np.random.default_rng(15)
    n, s, b = 4096, 256, 12
    sketch = np.where(rng.random((n, s)) < 0.05, rng.integers(-127, 128, (n, s)), 0).astype(np.int8)
    qind = np.zeros((b, s), np.int8)
    for q in range(b):
        qind[q, rng.choice(s, 6, replace=False)] = rng.choice([-1, 1], 6)
    mask = rng.random(n) > 0.05
    scale = np.float32(0.0173)
    js, ji = jbm.bm25_sketch_select(jnp.asarray(sketch), jnp.asarray(scale), jnp.asarray(qind),
                                    jnp.asarray(mask), 40, select)
    ts, ti = tbm.bm25_sketch_select(T(sketch), torch.tensor(scale), T(qind), T(mask), 40,
                                    select)
    assert_rows_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy(), "sketch")


# -- fusion -------------------------------------------------------------------

def _runs(seed, b=9, k1=10, k2=14, pool=40):
    rng = np.random.default_rng(seed)
    runs, scores = [], []
    for k in (k1, k2):
        ids = np.stack([rng.choice(pool, k, replace=False) for _ in range(b)]).astype(np.int32)
        ids[rng.random((b, k)) < 0.15] = -1
        runs.append(ids)
        scores.append(np.sort(rng.random((b, k)).astype(np.float32), axis=1)[:, ::-1].copy())
    return rng, runs, scores


def test_rrf_fusions_match_jax():
    rng, runs, scores = _runs(16)
    w = rng.random((9, 2)).astype(np.float32)
    jr = tuple(jnp.asarray(r) for r in runs)
    tr = tuple(T(r) for r in runs)
    for jout, tout in (
            (jfu.rrf_fuse(jr, k=15), tfu.rrf_fuse(tr, k=15)),
            (jfu.weighted_rrf_fuse(jr, jnp.asarray(w), k=15),
             tfu.weighted_rrf_fuse(tr, T(w), k=15)),
            (jfu.score_fuse(jr, tuple(jnp.asarray(s) for s in scores), jnp.asarray(w), k=15),
             tfu.score_fuse(tr, tuple(T(s) for s in scores), T(w), k=15))):
        assert_rows_match(np.asarray(jout[1]), np.asarray(jout[0]), tout[1].numpy(),
                          tout[0].numpy(), "fusion")


def test_calibrated_leg_weights_match_jax():
    for mrrs in ([0.4, 0.7], [0.0, 0.0], [0.9, 0.1], [0.5, 0.5]):
        np.testing.assert_allclose(tfu.calibrated_leg_weights(mrrs),
                                   jfu.calibrated_leg_weights(mrrs))
