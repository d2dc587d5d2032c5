"""Parity of the port's binary path with the JAX package (CPU): the Hamming
and int8-scores plain versions against the Pallas kernels (interpret mode),
the binary stage 1, and binary engine and hybrid searches.

Tolerance: tests/_torch_parity.py (exact rows and ranks; scores rtol 1e-5 /
atol 1e-6), with one more stated exception for the binary stage 1. Its raw
score 32 W - 2 * Hamming takes at most 32 W + 1 values, so many rows tie at
a query's kc-th stage-1 score. The port keeps the lowest rows among them
(the rule of the Pallas kernels and lax.top_k); the JAX package's CPU path
(`approx_max_k` over bf16 per 8192-row chunk) keeps another subset, and
orders ties otherwise. So a row may differ between the two packages only
because of a row whose stage-1 score equals its query's kc-th stage-1 score
(recomputed here in numpy): that row itself, or a row it pushed off the end
of the other result (`assert_binary_rows_match`). Where kc covers every
live row, results are compared exactly. A test with tie-heavy codes pins
the JAX side of that difference, so that it stays recorded.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiant_rag_tpu.index.bm25 import BM25Index as JaxBM25
from radiant_rag_tpu.index.engine import DeviceVectorIndex as JaxEngine
from radiant_rag_tpu.index.hybrid import HybridSearcher as JaxHybrid
from radiant_rag_tpu.index.hybrid import resolve_fused_depth as jax_resolve_fused_depth
from radiant_rag_tpu.ops import pallas_kernels as pk
from radiant_rag_tpu.ops import quantize as jq
from radiant_rag_tpu.ops import similarity as jsim
from radiant_rag_tpu_torch.config import RetrievalConfig
from radiant_rag_tpu_torch.index.bm25 import BM25Index
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
from radiant_rag_tpu_torch.index.hybrid import HybridSearcher, resolve_fused_depth
from radiant_rag_tpu_torch.ops import cuda_kernels as ck
from radiant_rag_tpu_torch.ops import similarity as tsim

from _torch_parity import assert_rows_match

T = torch.from_numpy


def _popcount_raw(codes: np.ndarray, qcodes: np.ndarray) -> np.ndarray:
    """(B, N) int64 raw = 32 W - 2 * Hamming, in numpy."""
    x = np.bitwise_xor(qcodes[:, None, :], codes[None, :, :])
    h = np.unpackbits(x.view(np.uint8), axis=-1).reshape(x.shape[0], x.shape[1], -1)
    return 32 * codes.shape[1] - 2 * h.sum(-1).astype(np.int64)


def _lexsort_topk(raw: np.ndarray, mask: np.ndarray, k: int) -> np.ndarray:
    """Rows of the top-k per query: raw descending, then row ascending."""
    out = np.full((raw.shape[0], k), -1, np.int64)
    live = np.nonzero(mask)[0]
    for q in range(raw.shape[0]):
        order = live[np.lexsort((live, -raw[q, live]))][:k]
        out[q, :len(order)] = order
    return out


def _kth(raw_q: np.ndarray, mask: np.ndarray, kc: int):
    """A query's kc-th best live stage-1 score, or None when kc covers
    every live row (then no boundary tie can differ)."""
    live = np.sort(raw_q[mask])[::-1]
    return None if kc >= len(live) else live[kc - 1]


def assert_binary_rows_match(ref_rows, ref_scores, got_rows, got_scores, raw, mask, kc,
                             what=""):
    """The binary-path rule of the module doc, per query: every returned row
    scores at least the kc-th stage-1 score; the rows strictly above it come
    in the same order with the same scores in both results, one list a
    prefix of the other (a tied row in one result pushes strict rows off
    its end); with no boundary, the rows match exactly."""
    for q in range(ref_rows.shape[0]):
        kth = _kth(raw[q], mask, kc)
        r, g = ref_rows[q], got_rows[q]
        if kth is None:
            assert_rows_match(r[None], ref_scores[q][None], g[None], got_scores[q][None],
                              f"{what} q{q}")
            continue
        for row in set(r[r >= 0]) | set(g[g >= 0]):
            assert raw[q, row] >= kth, (f"{what} q{q}: row {row} below the kc-th stage-1 "
                                        f"score ({raw[q, row]} < {kth})", r, g)
        fr = [i for i, x in enumerate(r) if x >= 0 and raw[q, x] > kth]
        fg = [i for i, x in enumerate(g) if x >= 0 and raw[q, x] > kth]
        p = min(len(fr), len(fg))
        assert_rows_match(r[fr[:p]][None], ref_scores[q][fr[:p]][None], g[fg[:p]][None],
                          got_scores[q][fg[:p]][None], f"{what} q{q} strict rows")


# -- kernels' plain versions against the Pallas kernels ------------------------

@pytest.mark.parametrize("w", [1, 4, 12, 13, 24, 32])
def test_hamming_references_match_pallas(w):
    rng = np.random.default_rng(w)
    n, b = 2 * pk.TILE_N, 8
    codes = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    q = rng.integers(0, 2**32, (b, w), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(pk.hamming_scores_pallas(jnp.asarray(codes), jnp.asarray(q),
                                              interpret=True))
    ref_t = np.asarray(pk.hamming_scores_pallas_t(jnp.asarray(codes.T.copy()), jnp.asarray(q),
                                                  interpret=True))
    tc, tq = T(codes.view(np.int32)), T(q.view(np.int32))
    np.testing.assert_array_equal(ck.hamming_scores_reference(tc, tq).numpy(), ref)
    np.testing.assert_array_equal(ck.hamming_scores_t_reference(tc.T.contiguous(), tq).numpy(),
                                  ref_t)
    before = (ck.hamming_scores.launches, ck.hamming_scores_t.launches)
    np.testing.assert_array_equal(ck.hamming_scores(tc, tq).numpy(), ref)  # CPU: plain
    assert (ck.hamming_scores.launches, ck.hamming_scores_t.launches) == before


@pytest.mark.parametrize("w", [1, 12, 13, 24, 32])
def test_sign_product_gives_hamming(w):
    """The identity the Hamming kernels compute by: with +1 for a set bit
    and -1 for a clear one, zero-padded to whole 64-bit ring slices as the
    tensor-core tile reads them, <s_q, s_c> = 32 W - 2 Hamming, which is
    the Pallas kernel's distance."""
    rng = np.random.default_rng(100 + w)
    n, b = pk.TILE_N, 5
    codes = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    q = rng.integers(0, 2**32, (b, w), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(pk.hamming_scores_pallas(jnp.asarray(codes), jnp.asarray(q), interpret=True))
    tc, tq = T(codes.view(np.int32)), T(q.view(np.int32))
    pad = 32 * (-w % ck.SIGN_SLICE_WORDS)  # K bytes past 32 W in the last slice
    cs = torch.nn.functional.pad(ck.sign_matrix(tc), (0, pad))
    qs = torch.nn.functional.pad(ck.sign_matrix(tq), (0, pad))
    assert cs.shape == (n, 64 * -(-w // ck.SIGN_SLICE_WORDS)) and cs.dtype == torch.int8
    assert bool((cs[:, :32 * w].abs() == 1).all())
    dots = qs.to(torch.int64) @ cs.to(torch.int64).T
    np.testing.assert_array_equal(dots.numpy(), 32 * w - 2 * ref.astype(np.int64))
    np.testing.assert_array_equal(
        dots.numpy(), 32 * w - 2 * ck.hamming_scores_reference(tc, tq).numpy().astype(np.int64))
    # the scan's raw score is the product itself
    s, r = ck.hamming_scan_topk_reference(tc, tq, None, 7)
    np.testing.assert_array_equal(s.numpy(), np.take_along_axis(dots.numpy(), r.numpy(), 1))


def test_int8_scores_reference_matches_pallas():
    rng = np.random.default_rng(3)
    codes = rng.integers(-127, 128, (2 * pk.TILE_N, 384)).astype(np.int8)
    qi = rng.integers(-127, 128, (8, 384)).astype(np.int8)
    ref = np.asarray(pk.int8_scores_pallas(jnp.asarray(codes), jnp.asarray(qi), interpret=True))
    np.testing.assert_array_equal(ck.int8_scores_reference(T(codes), T(qi)).numpy(), ref)
    np.testing.assert_array_equal(ck.int8_scores(T(codes), T(qi)).numpy(), ref)


def test_int8_scan_topk_reference_matches_pallas_at_k360():
    """The repaired k: the sketch leg of the memory-optimized preset runs
    k = round(60 x 6.0) = 360."""
    rng = np.random.default_rng(4)
    codes = rng.integers(-3, 4, (2 * pk.TILE_N, 64)).astype(np.int8)
    codes[900:910] = codes[5]
    qi = rng.integers(-3, 4, (8, 64)).astype(np.int8)
    mask = rng.random(2 * pk.TILE_N) > 0.1
    js, ji = pk.int8_scan_topk_pallas(jnp.asarray(codes), jnp.asarray(qi), jnp.asarray(mask),
                                      360, interpret=True)
    ts, ti = ck.int8_scan_topk(T(codes), T(qi), T(mask), 360)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_scan_k_limits_are_set_by_shared_memory():
    # the int8 tile's shared memory does not depend on D; the presets reach
    # k = 240 and 360, and every k up to the cap fits a 32-query CTA
    for k in (240, 360, ck.INT8_SCAN_TOPK_MAX_K):
        assert ck.int8_scan_smem_bytes(ck.int8_scan_qb(k), k) <= ck.SMEM_MAX
    assert ck.int8_scan_smem_bytes(64, ck.INT8_SCAN_TOPK_MAX_K) > ck.SMEM_MAX
    # the Hamming scan runs the same tile and lists: its plan takes the same
    # shared size at every k it is asked for
    for k in (60, 240, 360, ck.INT8_SCAN_TOPK_MAX_K):
        plan = ck.int8_scan_plan(1 << 20, 2048, k, 132, 1)
        assert plan.smem == ck.int8_scan_smem_bytes(ck.int8_scan_qb(k), k) <= ck.SMEM_MAX
    assert ck.INT8_SCAN_TOPK_MAX_K == 512


# -- the binary stage 1 ----------------------------------------------------

def _tie_heavy_words(seed, n, d, b):
    """Sign words of few distinct patterns per word (ties at every k), a
    block of duplicate codes and a 10% mask."""
    rng = np.random.default_rng(seed)
    w = d // 32
    codes = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    codes &= np.uint32(0x0F0F0F0F)
    codes[n // 3:n // 3 + 12] = codes[7]
    q = rng.integers(0, 2**32, (b, w), dtype=np.uint64).astype(np.uint32)
    mask = rng.random(n) > 0.1
    return codes, q, mask


@pytest.mark.parametrize("d,k", [(384, 60), (384, 360), (256, 360)])
def test_hamming_scan_topk_matches_jax(d, k):
    codes, q, mask = _tie_heavy_words(d + k, 20_000, d, 6)
    js, ji = jsim.hamming_scan_topk(jnp.asarray(codes), jnp.asarray(q), jnp.asarray(mask), k)
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = tsim.hamming_scan_topk(T(codes.view(np.int32)), T(q.view(np.int32)), T(mask), k)
    ts, ti = ts.numpy(), ti.numpy()
    raw = _popcount_raw(codes, q)
    # the port's rows are the exact lexsort (score descending, row ascending)
    np.testing.assert_array_equal(ti, _lexsort_topk(raw, mask, k))
    for qq in range(q.shape[0]):
        # the same multiset of scores, bit for bit (raw / D in f32)
        np.testing.assert_array_equal(np.sort(ts[qq]), np.sort(js[qq]))
        kth = raw[qq, ti[qq, -1]]
        strict_t = {r for r in ti[qq] if raw[qq, r] > kth}
        strict_j = {r for r in ji[qq] if raw[qq, r] > kth}
        assert strict_t == strict_j
        assert all(raw[qq, r] == kth for r in set(ji[qq]) - set(ti[qq]))


def test_jax_boundary_ties_differ_from_lowest_row_rule():
    """Recorded in ROADMAP section C: among the rows tied at the k-th score,
    the JAX package's CPU binary stage 1 keeps a subset other than the
    lowest rows (and does not order ties by row); the port keeps the lowest."""
    codes, q, mask = _tie_heavy_words(11, 20_000, 384, 6)
    raw = _popcount_raw(codes, q)
    exact = _lexsort_topk(raw, mask, 360)
    _, ji = jsim.hamming_scan_topk(jnp.asarray(codes), jnp.asarray(q), jnp.asarray(mask), 360)
    ji = np.asarray(ji)
    assert any(set(ji[qq]) != set(exact[qq]) for qq in range(q.shape[0]))
    assert any(not np.array_equal(ji[qq], exact[qq]) for qq in range(q.shape[0]))
    _, ti = tsim.hamming_scan_topk(T(codes.view(np.int32)), T(q.view(np.int32)), T(mask), 360)
    np.testing.assert_array_equal(ti.numpy(), exact)


# -- engine and hybrid -----------------------------------------------------

D = 384


def _world(n, seed=0, store_fp32=True, sketch_dim=256):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, D)).astype(np.float32)
    vecs = centers[rng.integers(0, 32, n)] + 0.7 * rng.standard_normal((n, D)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (n, 24)) % 2000]
    levels = rng.integers(0, 2, n).astype(np.int8)
    langs = rng.integers(0, 3, n).astype(np.int32)
    lens = np.asarray([len(t.split()) for t in texts], np.float32)
    je = JaxEngine(D, initial_capacity=n, store_fp32=store_fp32)
    te = DeviceVectorIndex(D, initial_capacity=n, store_fp32=store_fp32, device="cpu")
    for eng in (je, te):
        for s in range(0, n, 1024):
            eng.append(vecs[s:s + 1024], levels[s:s + 1024], langs[s:s + 1024], lens[s:s + 1024])
        eng.invalidate(np.asarray([1, 4, 9]))
    jb, tb = JaxBM25(sketch_dim=sketch_dim), BM25Index(sketch_dim=sketch_dim, device="cpu")
    jb.bulk_build(list(range(n)), texts)
    tb.bulk_build(list(range(n)), texts)
    qidx = rng.integers(0, n, 13)
    q = vecs[qidx] + 0.25 * rng.standard_normal((13, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = [" ".join(texts[i].split()[:6]) for i in qidx]
    return JaxHybrid(je, jb), HybridSearcher(te, tb), q, qt


def _stage1_raw(eng, q, level_code=-1, lang_code=-1):
    """numpy stage-1 scores of the JAX engine's words, and its live mask."""
    words = np.asarray(eng.codes)
    qwords = np.asarray(jq.pack_binary(jnp.asarray(q)))
    mask = np.asarray(eng.valid).copy()
    if level_code >= 0:
        mask &= np.asarray(eng.level).astype(np.int32) == level_code
    if lang_code >= 0:
        mask &= np.asarray(eng.lang) == lang_code
    return _popcount_raw(words, qwords), mask


@pytest.mark.parametrize("store_fp32", [True, False], ids=["fp32", "fp32_free"])
@pytest.mark.parametrize("n", [200, 3000])
def test_engine_binary_search_matches_jax(store_fp32, n):
    jh, th, q, _ = _world(n, seed=n, store_fp32=store_fp32)
    je, te = jh.engine, th.engine
    for k, mult, filters in ((10, 6.0, (-1, -1)), (60, 6.0, (-1, -1)), (10, 4.0, (1, 2))):
        kw = dict(rescore_multiplier=mult, level_code=filters[0], lang_code=filters[1])
        js, jr = je.search(q, k, mode="binary", **kw)
        ts, tr = te.search(q, k, mode="binary", **kw)
        raw, mask = _stage1_raw(je, q, *filters)
        kc = min(max(k, int(round(k * mult))), je.capacity)
        assert_binary_rows_match(jr, js, tr, ts, raw, mask, kc, f"n={n} k={k} {filters}")
    # padded query rows (B = 5 in the 8-bucket) never leak out
    js, jr = je.search(q[:5], 10, mode="binary")
    ts, tr = te.search(q[:5], 10, mode="binary")
    assert tr.shape == (5, 10)
    assert_binary_rows_match(jr, js, tr, ts, *_stage1_raw(je, q[:5]), 40, "padded")


def test_default_arguments_match_jax():
    """Both packages default to mode="binary" in engine.search and
    HybridSearcher.search_rows; default calls give the same results."""
    jh, th, q, qt = _world(30, seed=5)  # kc = 40 covers the 27 live rows: exact
    js, jr = jh.engine.search(q, 10)
    ts, tr = th.engine.search(q, 10)
    assert_rows_match(jr, js, tr, ts, "engine defaults")
    ref, got = jh.search_rows(q, qt), th.search_rows(q, qt)
    for leg in ref:
        assert_rows_match(ref[leg][1], ref[leg][0], got[leg][1], got[leg][0], f"hybrid {leg}")
    assert jax_resolve_fused_depth(RetrievalConfig()) == resolve_fused_depth(RetrievalConfig())
    assert resolve_fused_depth(RetrievalConfig(fused_depth=7)) == 7


@pytest.mark.parametrize("store_fp32", [True, False], ids=["fp32", "fp32_free"])
@pytest.mark.parametrize("bm25_mode", ["sketch", "pages"])
def test_hybrid_binary_matches_jax_exactly_where_kc_covers_the_corpus(store_fp32, bm25_mode):
    """200 docs, fused depth 60 x multiplier 6.0: kc = min(360, 256) covers
    every row, so every leg matches exactly; with a level / lang filter and
    padded query rows."""
    jh, th, q, qt = _world(200, seed=1, store_fp32=store_fp32)
    for kw in (dict(fused_depth=60, rescore_multiplier=6.0),
               dict(fused_depth=60, rescore_multiplier=6.0, level_code=1, lang_code=2)):
        for qq, tt in ((q, qt), (q[:5], qt[:5])):
            ref = jh.search_rows(qq, tt, mode="binary", bm25_mode=bm25_mode, **kw)
            got = th.search_rows(qq, tt, mode="binary", bm25_mode=bm25_mode, **kw)
            for leg in ref:
                assert_rows_match(ref[leg][1], ref[leg][0], got[leg][1], got[leg][0],
                                  f"{bm25_mode} {kw} {leg}")


@pytest.mark.parametrize("bm25_mode", ["sketch", "pages"])
def test_hybrid_binary_matches_jax_up_to_boundary_ties(bm25_mode):
    """3000 docs: the dense leg under the boundary-tie rule, the BM25 leg
    exactly, and the fused leg exactly on every query whose two stage-1
    candidate sets agree."""
    jh, th, q, qt = _world(3000, seed=2)
    je = jh.engine
    qq = q.astype(np.float16).astype(np.float32) if bm25_mode == "sketch" else q
    raw, mask = _stage1_raw(je, qq)
    qwords = np.asarray(jq.pack_binary(jnp.asarray(qq)))
    for depth, mult in ((60, 6.0), (0, 4.0)):
        kw = dict(mode="binary", bm25_mode=bm25_mode, fused_depth=depth, rescore_multiplier=mult)
        ref, got = jh.search_rows(q, qt, **kw), th.search_rows(q, qt, **kw)
        dk = max(10, depth)
        kc = min(max(dk, int(round(dk * mult))), je.capacity)
        assert_binary_rows_match(ref["dense"][1], ref["dense"][0], got["dense"][1],
                                 got["dense"][0], raw, mask, kc, f"dense depth {depth}")
        assert_rows_match(ref["bm25"][1], ref["bm25"][0], got["bm25"][1], got["bm25"][0],
                          f"bm25 depth {depth}")
        _, jc = jsim.hamming_scan_topk(je.codes, jnp.asarray(qwords), je.valid, kc)
        _, tc = tsim.hamming_scan_topk(th.engine.codes, T(qwords.view(np.int32)),
                                       th.engine.valid, kc)
        same = [i for i in range(len(q)) if set(np.asarray(jc)[i]) == set(tc.numpy()[i])]
        if depth == 0:
            assert same, "no query with equal candidate sets: the fused check has no teeth"
        for i in same:
            assert_rows_match(ref["fused"][1][i:i + 1], ref["fused"][0][i:i + 1],
                              got["fused"][1][i:i + 1], got["fused"][0][i:i + 1],
                              f"fused depth {depth} q{i}")
