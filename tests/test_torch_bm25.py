"""Parity of the port's BM25Index build and query prep with the JAX package.

Both packages build their index independently from the same texts (native
bulk build and the Python add path); the host tables, the signed impact
sketch, the doc-major tables, the bins / signs, the router and the page
table must come out identical. Tolerance: exact (integer and host-float
tables computed by the same numpy code).
"""

import numpy as np
import pytest
import torch

from radiant_rag_tpu.index.bm25 import BM25Index as JaxBM25
from radiant_rag_tpu_torch.index.bm25 import BM25Index, tokenize
from radiant_rag_tpu_torch.utils.hashing import stable_hash32


def _texts(seed, n=2000, vocab=1500, width=24):
    rng = np.random.default_rng(seed)
    zipf = rng.zipf(1.3, size=(n, width)) % vocab
    return [" ".join(f"w{t}" for t in row) for row in zipf], rng


def _pair(texts, native=True, **kw):
    j = JaxBM25(**kw)
    t = BM25Index(device="cpu", **kw)
    if native:
        assert j.bulk_build(list(range(len(texts))), texts)
        assert t.bulk_build(list(range(len(texts))), texts)
    else:
        for row, text in enumerate(texts):
            j.add_document(row, text)
            t.add_document(row, text)
    return j, t


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_tables_equal_after_independent_builds(native):
    texts, _ = _texts(1)
    j, t = _pair(texts, native, sketch_dim=256)
    n = 2048
    j._finalize_csr()
    t._finalize_csr()
    assert t.terms == j.terms and t.df == j.df
    np.testing.assert_array_equal(t._term_start, j._term_start)
    np.testing.assert_array_equal(t._term_idf, j._term_idf)
    np.testing.assert_array_equal(t._host_post_rows, j._host_post_rows)
    np.testing.assert_array_equal(t._host_post_tf, j._host_post_tf)
    np.testing.assert_array_equal(t._dev_post_rows.numpy(), np.asarray(j._dev_post_rows))
    j.ensure_sketch(n)
    t.ensure_sketch(n)
    np.testing.assert_array_equal(t._sketch.numpy(), np.asarray(j._sketch))
    assert t._sketch_scale.item() == float(np.asarray(j._sketch_scale))
    np.testing.assert_array_equal(t._bins_per_term, j._bins_per_term)
    np.testing.assert_array_equal(t._signs_per_term, j._signs_per_term)
    j.ensure_doc_major(n)
    t.ensure_doc_major(n)
    np.testing.assert_array_equal(t._dm_tids.numpy(), np.asarray(j._dm_tids))
    np.testing.assert_array_equal(t._dm_tfs.numpy(), np.asarray(j._dm_tfs))
    np.testing.assert_array_equal(t._device_doc_lens(n).numpy(),
                                  np.asarray(j._device_doc_lens(n)))
    assert t.avgdl == j.avgdl


def test_updates_and_removals_match():
    texts, rng = _texts(2, n=600)
    j, t = _pair(texts, sketch_dim=128)
    for idx in (j, t):
        idx.add_document(5, "w1 w2 w2 brand new words")  # update
        idx.add_document(900, "a fresh row w7 w7")  # new row
        idx.remove_document(17)
        idx._finalize_csr()
    np.testing.assert_array_equal(t._term_start, j._term_start)
    np.testing.assert_array_equal(t._host_post_rows, j._host_post_rows)
    np.testing.assert_array_equal(t._term_idf, j._term_idf)
    assert t.terms == j.terms and t.df == j.df and t.total_len == j.total_len


def test_tokenizer_and_hash_match():
    from radiant_rag_tpu.index.bm25 import tokenize as jtok
    from radiant_rag_tpu.utils.hashing import stable_hash32 as jhash

    for text in ("Hello, World! x y2 A1b2 naïve café 42", "", "ab cd-ef"):
        assert tokenize(text) == jtok(text)
    for term in ("w1", "s!w1", "naïve", ""):
        assert stable_hash32(term) == jhash(term)
        assert stable_hash32(term, seed=7) == jhash(term, seed=7)


def test_query_prep_and_router_match():
    texts, rng = _texts(3)
    j, t = _pair(texts, sketch_dim=256)
    j.ensure_sketch(2048)
    t.ensure_sketch(2048)
    common = [" ".join(texts[i].split()[:6]) for i in rng.integers(0, 2000, 40)]
    rare = ["w1499 w1498", "w1497 zzz", "w1496"]
    for batch in (common, rare, common[:3] + rare):
        jt, tt = j.query_tids(batch), t.query_tids(batch)
        np.testing.assert_array_equal(tt, jt)
        for a, c in zip(t.make_query_terms(batch, tids=tt), j.make_query_terms(batch, tids=jt)):
            np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(t.make_query_indicator(batch, tt),
                                      j.make_query_indicator(batch, jt))
        for n_docs in (2048, 1 << 20):
            assert t.routes_pages(batch, tt, num_docs=n_docs) == \
                j.routes_pages(batch, jt, num_docs=n_docs)
        jp, tp = j.make_pages(batch, jt), t.make_pages(batch, tt)
        for key in ("start", "len", "qidx", "idf"):
            np.testing.assert_array_equal(tp[key], jp[key])


def test_signed_indicator_equals_blob_scatter():
    """The port builds the (B, S) indicator on the host; the JAX sketch
    route scatter-adds the signed bin codes on the device. Colliding query
    terms add their signs in both."""
    import jax.numpy as jnp
    from radiant_rag_tpu.index.hybrid import _unpack_query_blob, pack_query_blob

    texts, rng = _texts(4)
    j, t = _pair(texts, sketch_dim=128)
    j.ensure_sketch(2048)
    t.ensure_sketch(2048)
    batch = [" ".join(texts[i].split()[:12]) for i in rng.integers(0, 2000, 16)]
    tids = j.query_tids(batch)
    q_tids, q_idfs = j.make_query_terms(batch, tids=tids)
    bins = j.make_query_bins(batch, tids)
    blob = pack_query_blob(np.zeros((16, 0), np.float32), q_tids, q_idfs, bins, 16, -1, -1,
                           np.asarray([0.5, 0.5], np.float32), 128)
    qind = _unpack_query_blob(jnp.asarray(blob), 16, 0, q_tids.shape[1], 128)[4]
    np.testing.assert_array_equal(t.make_query_indicator(batch, t.query_tids(batch)),
                                  np.asarray(qind))


@pytest.mark.parametrize("n_docs", [1 << 20, 4_000_000, 12_000_000])
def test_hbm_plan_matches(n_docs):
    texts, _ = _texts(5, n=300)
    j, t = _pair(texts)
    j.plan_hbm(n_docs)
    t.plan_hbm(n_docs)
    assert (t.sketch_dim, t.doc_major_width) == (j.sketch_dim, j.doc_major_width)
    j._finalize_csr()
    t._finalize_csr()
    assert t.device_bytes_projected(n_docs) == j.device_bytes_projected(n_docs)


def test_device_tables_live_on_the_index_device():
    texts, _ = _texts(6, n=200)
    t = BM25Index(device="cpu", sketch_dim=128)
    t.bulk_build(list(range(200)), texts)
    t.ensure_sketch(256)
    t.ensure_doc_major(256)
    for arr in (t._dev_post_rows, t._sketch, t._dm_tids, t._device_doc_lens(256)):
        assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"
