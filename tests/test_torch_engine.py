"""Parity of the port's DeviceVectorIndex with the JAX package (CPU).

Both engines take the same appends (seeded numpy vectors); the stored int8
codes, sign words and calibration must be bit-identical, and searches must
agree under tests/_torch_parity.py's tolerance (exact rows and ranks,
scores rtol 1e-5 / atol 1e-6).
"""

import numpy as np
import pytest

from radiant_rag_tpu.index.engine import DeviceVectorIndex as JaxEngine
from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex, _round_capacity

from _torch_parity import assert_rows_match


def _data(seed, n, d=64):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    levels = rng.integers(0, 3, n).astype(np.int8)
    langs = rng.integers(0, 4, n).astype(np.int32)
    lens = rng.integers(5, 50, n).astype(np.float32)
    q = vecs[rng.integers(0, n, 19)] + 0.3 * rng.standard_normal((19, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return vecs, levels, langs, lens, q


def _pair(seed=0, n=3000, chunk=700, **kw):
    vecs, levels, langs, lens, q = _data(seed, n)
    j = JaxEngine(64, initial_capacity=1024, **kw)
    t = DeviceVectorIndex(64, initial_capacity=1024, device="cpu", **kw)
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        rj = j.append(vecs[sl], levels[sl], langs[sl], lens[sl])
        rt = t.append(vecs[sl], levels[sl], langs[sl], lens[sl])
        np.testing.assert_array_equal(rt, rj)
    return j, t, q


@pytest.mark.parametrize("store_fp32", [True, False], ids=["fp32", "fp32_free"])
def test_append_state_bit_equal(store_fp32):
    j, t, _ = _pair(1, store_fp32=store_fp32)
    assert (t.capacity, t.count) == (j.capacity, j.count)
    np.testing.assert_array_equal(t.i8.numpy(), np.asarray(j.i8))
    np.testing.assert_array_equal(t.codes.numpy().view(np.uint32), np.asarray(j.codes))
    np.testing.assert_array_equal(t.i8_lo.numpy(), np.asarray(j.i8_lo))
    np.testing.assert_array_equal(t.i8_hi.numpy(), np.asarray(j.i8_hi))
    np.testing.assert_array_equal(t.vecs.numpy(), np.asarray(j.vecs))
    for name in ("valid", "level", "lang", "doc_len"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.memory_bytes() == j.memory_bytes()
    assert t.resident_bytes() == j.resident_bytes()


@pytest.mark.parametrize("mode,select", [("exact", ""), ("int8", "f32"), ("int8", "blockmax")])
@pytest.mark.parametrize("filters", [(-1, -1), (1, -1), (-1, 2), (0, 3)])
def test_search_matches_jax(mode, select, filters):
    j, t, q = _pair(2, stage1_select=select)
    j.invalidate(np.asarray([3, 77, 1500]))
    t.invalidate(np.asarray([3, 77, 1500]))
    level_code, lang_code = filters
    js, jr = j.search(q, 10, mode=mode, level_code=level_code, lang_code=lang_code)
    ts, tr = t.search(q, 10, mode=mode, level_code=level_code, lang_code=lang_code)
    assert tr.dtype == np.int64 and ts.shape == (19, 10)
    assert_rows_match(jr, js, tr, ts, f"{mode} {select} {filters}")
    assert not np.isin(tr, [3, 77, 1500]).any()


def test_fp32_free_search_and_small_k_pad_match():
    j, t, q = _pair(3, n=200, chunk=200, store_fp32=False)
    for k in (5, 300):  # 300 > capacity 256: padded with -1
        js, jr = j.search(q, k, mode="int8")
        ts, tr = t.search(q, k, mode="int8")
        assert_rows_match(jr, js, tr, ts, f"fp32-free k={k}")


def test_recalibrate_and_external_ranges_match():
    j, t, q = _pair(4, n=500, chunk=500)
    rng = np.random.default_rng(4)
    lo = -np.abs(rng.standard_normal(64)).astype(np.float32) * 0.3
    hi = np.abs(rng.standard_normal(64)).astype(np.float32) * 0.3
    j.set_int8_ranges(lo, hi)
    t.set_int8_ranges(lo, hi)
    np.testing.assert_array_equal(t.i8.numpy(), np.asarray(j.i8))
    j.recalibrate()
    t.recalibrate()
    np.testing.assert_array_equal(t.i8.numpy(), np.asarray(j.i8))


def test_grow_and_reserve_match():
    j, t, _ = _pair(5, n=300, chunk=300)
    for eng in (j, t):
        eng.reserve(70_000)
    assert t.capacity == j.capacity == _round_capacity(70_000)
    vecs, levels, langs, lens, _ = _data(6, 100)
    for eng in (j, t):
        eng.append(vecs, levels, langs, lens)
    np.testing.assert_array_equal(t.i8.numpy(), np.asarray(j.i8))
    for n in (1, 256, 5000, 65536, 65537, 10_000_000):
        from radiant_rag_tpu.index.engine import _round_capacity as jround

        assert _round_capacity(n) == jround(n)


def test_to_host_from_host_roundtrip():
    _, t, q = _pair(7, n=900, chunk=450)
    t.invalidate(np.asarray([10, 11]))
    state = t.to_host()
    assert state["vecs"].shape == (900, 64) and not state["valid"][10]
    t2 = DeviceVectorIndex.from_host(state, device="cpu")
    for name in ("i8", "valid", "level", "lang", "doc_len"):
        np.testing.assert_array_equal(getattr(t2, name)[:900].numpy(),
                                      getattr(t, name)[:900].numpy())
    s1, r1 = t.search(q, 10)
    s2, r2 = t2.search(q, 10)
    np.testing.assert_array_equal(r1, r2)


def test_bucket_gate_and_unported_modes():
    _, t, q = _pair(8, n=300, chunk=300)
    assert t.max_query_bucket() == DeviceVectorIndex.QUERY_BUCKETS[-1]
    assert t._bucket_of(5) == 8
    # a (B, N) path is gated by what residency leaves of the device
    t.usable_bytes = t.resident_bytes() + 64 * t.capacity * 24
    assert t.max_query_bucket(score_gated=True) == 64
    with pytest.raises(ValueError, match="exceeds max bucket"):
        t._bucket_of(65, t.max_query_bucket(score_gated=True))
    s_big, r_big = t.search(np.concatenate([q] * 5), 10, mode="exact")  # chunked at 64
    s, r = t.search(q, 10, mode="exact")
    np.testing.assert_array_equal(r_big, np.concatenate([r] * 5))
    # binary is ported (not score-gated: no (B, N) buffer); graph without a
    # built graph is the int8 search, as in the JAX package
    s_bin, r_bin = t.search(np.concatenate([q] * 5), 10, mode="binary")
    np.testing.assert_array_equal(r_bin, np.concatenate([t.search(q, 10, mode="binary")[1]] * 5))
    s_g, r_g = t.search(q, 10, mode="graph")
    s_8, r_8 = t.search(q, 10, mode="int8")
    np.testing.assert_array_equal(r_g, r_8)
    np.testing.assert_array_equal(s_g, s_8)
