"""The port's DeviceReranker against the JAX package's (CPU), and the four
cases of `tests/test_device_rerank.py` on the port.

The device-packed [CLS] q [SEP] d [SEP] pairs must score as the
cross-encoder scores host-packed ids; the candidate order is the z-norm
blend's, stable (ties keep the lower slot, as `jnp.argsort` keeps them).
Tolerance: rows exact; logits rtol 1e-5 / atol 1e-5 in float32 (the
frameworks' float32 summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiant_rag_tpu.config import CrossEncoderConfig as JaxCEConfig
from radiant_rag_tpu.models.bert import BertConfig as JaxBertConfig
from radiant_rag_tpu.models.cross_encoder import CrossEncoder as JaxCrossEncoder
from radiant_rag_tpu.models.device_rerank import DeviceReranker as JaxReranker
from radiant_rag_tpu_torch.config import CrossEncoderConfig
from radiant_rag_tpu_torch.convert import cross_encoder_params_from_jax
from radiant_rag_tpu_torch.models.bert import BertConfig
from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
from radiant_rag_tpu_torch.models.device_rerank import DeviceReranker
from radiant_rag_tpu_torch.models.tokenizer import CLS_ID, SEP_ID

F32 = dict(rtol=1e-5, atol=1e-5)
ARCH = dict(vocab_size=300, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
TEXTS = [f"document number {i} about retrieval topic {i % 5} with extra detail token{i}"
         for i in range(24)]


@pytest.fixture(scope="module")
def ces():
    cfg = dict(max_seq_len=39, batch_size=8)
    jce = JaxCrossEncoder(JaxCEConfig(**cfg), bert_cfg=JaxBertConfig(dtype=jnp.float32, **ARCH),
                          seed=3)
    tce = CrossEncoder(CrossEncoderConfig(**cfg), bert_cfg=BertConfig(dtype=torch.float32, **ARCH),
                       params=cross_encoder_params_from_jax(jax.tree.map(np.asarray, jce.params)),
                       device="cpu")
    return jce, tce


def test_scores_match_host_path(ces):
    _, ce = ces
    rr = DeviceReranker(ce, q_len=8, d_len=28, pair_chunk=16)
    rr.build_table(TEXTS)
    queries = ["retrieval topic 3 detail", "document number 7"]
    rows = np.asarray([[3, 8, 13, 1], [7, 2, 9, -1]])
    scores, out_rows = rr.rerank_rows(queries, rows, top_k=4)
    for qi, q in enumerate(queries):
        cand = [int(r) for r in rows[qi] if r >= 0]
        q_ids = ce.tokenizer.tokenize_ids_batch([q], cap=8)[0]
        host = {}
        for r in cand:
            d_ids = ce.tokenizer.tokenize_ids_batch([TEXTS[r]], cap=28)[0]
            ids = [CLS_ID] + q_ids + [SEP_ID] + d_ids + [SEP_ID]
            pad = rr.L - len(ids)
            arr = torch.tensor([ids + [0] * pad], dtype=torch.int32)
            mask = torch.tensor([[1] * len(ids) + [0] * pad], dtype=torch.int32)
            types = torch.tensor([[0] * (len(q_ids) + 2) + [1] * (len(d_ids) + 1) + [0] * pad],
                                 dtype=torch.int32)
            host[r] = float(ce.forward(arr, mask, types)[0])
        dev = {int(r): float(s) for s, r in zip(scores[qi], out_rows[qi]) if r >= 0}
        assert set(dev) == set(cand)
        for r in cand:
            np.testing.assert_allclose(dev[r], host[r], **F32)
        vals = [dev[int(r)] for r in out_rows[qi] if r >= 0]
        assert vals == sorted(vals, reverse=True)


def test_invalid_rows_sort_last(ces):
    rr = DeviceReranker(ces[1], q_len=8, d_len=28, pair_chunk=8)
    rr.build_table(TEXTS)
    scores, out_rows = rr.rerank_rows(["topic"], np.asarray([[5, -1, 11, -1]]), top_k=4)
    assert set(int(r) for r in out_rows[0][:2]) == {5, 11}
    assert all(r == -1 for r in out_rows[0][2:])
    assert np.isneginf(scores[0][2:]).all()


def test_append_extends_table(ces):
    rr = DeviceReranker(ces[1], q_len=8, d_len=28, pair_chunk=8)
    rr.build_table(TEXTS[:10])
    rr.append(TEXTS[10:12])
    assert rr.n_rows == 12 and rr._table.shape == (12, 28)
    _, out_rows = rr.rerank_rows(["retrieval topic 0"], np.asarray([[10, 11, 0]]), top_k=3)
    assert set(int(r) for r in out_rows[0]) == {10, 11, 0}
    fresh = DeviceReranker(ces[1], q_len=8, d_len=28)
    fresh.append(TEXTS[:3])  # append before any build builds the table
    assert fresh.n_rows == 3


def test_prior_blend_degenerates_correctly(ces):
    """weight 0 = pure CE order; a huge weight = the incoming prior order."""
    rr = DeviceReranker(ces[1], q_len=8, d_len=28, pair_chunk=8)
    rr.build_table(TEXTS)
    rows = np.asarray([[2, 9, 15, 4]])
    prior = np.asarray([[4.0, 3.0, 2.0, 1.0]], np.float32)
    _, r0 = rr.rerank_rows(["retrieval topic"], rows, top_k=4)
    _, r1 = rr.rerank_rows(["retrieval topic"], rows, top_k=4, prior_scores=prior,
                           prior_weight=0.0)
    np.testing.assert_array_equal(r0, r1)
    _, r2 = rr.rerank_rows(["retrieval topic"], rows, top_k=4, prior_scores=prior,
                           prior_weight=1e6)
    np.testing.assert_array_equal(r2, rows)


def _both(ces, texts, table_dtype=np.int32, **kw):
    jce, tce = ces
    jr = JaxReranker(jce, q_len=8, d_len=28, pair_chunk=16, table_dtype=table_dtype)
    tr = DeviceReranker(tce, q_len=8, d_len=28, pair_chunk=16, table_dtype=table_dtype)
    jr.build_table(texts)
    tr.build_table(texts)
    return jr, tr


@pytest.mark.parametrize("table_dtype", [np.int32, np.int16])
@pytest.mark.parametrize("prior_weight", [0.0, 0.7])
def test_rerank_rows_matches_jax(ces, table_dtype, prior_weight):
    """B = 6 queries x K = 7 candidates (42 pairs: chunks of 16, the last
    padded), dead slots, a prior with -inf entries, top_k 5."""
    jr, tr = _both(ces, TEXTS + ["café résumé 中文", ""], table_dtype)
    rng = np.random.default_rng(7)
    rows = rng.integers(0, len(TEXTS) + 2, (6, 7))
    rows[1, 3:] = -1
    rows[4, 0] = -1
    prior = rng.standard_normal((6, 7)).astype(np.float32)
    prior[2, 1] = -np.inf
    queries = [f"retrieval topic {i} detail" for i in range(5)] + ["naïve query"]
    ref = jr.rerank_rows(queries, rows, top_k=5, prior_scores=prior, prior_weight=prior_weight)
    got = tr.rerank_rows(queries, rows, top_k=5, prior_scores=prior, prior_weight=prior_weight)
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1].dtype == np.int32 and got[0].dtype == np.float32
    live = ref[1] >= 0
    np.testing.assert_allclose(got[0][live], ref[0][live], **F32)
    assert np.isneginf(got[0][~live]).all()
    assert tr._table.dtype == torch.from_numpy(np.zeros(1, table_dtype)).dtype


def test_equal_logits_keep_slot_order_like_jax(ces):
    """Duplicate docs score equal logits: the stable order keeps them in
    slot order, as jnp.argsort does."""
    texts = ["the same document"] * 6 + TEXTS[:4]
    jr, tr = _both(ces, texts)
    rows = np.asarray([[3, 7, 0, 5, 1, 8, 2, 4], [9, 5, 4, 3, 2, 1, 0, 6]])
    ref = jr.rerank_rows(["same document", "topic"], rows, top_k=8)
    got = tr.rerank_rows(["same document", "topic"], rows, top_k=8)
    np.testing.assert_array_equal(got[1], ref[1])
    dup = [int(r) for r in got[1][0] if r in (3, 0, 5, 1, 2, 4)]
    assert dup == [3, 0, 5, 1, 2, 4]  # the six tied rows, in slot order


def test_fetch_false_and_small_batches(ces):
    _, tr = _both(ces, TEXTS)
    rows = np.asarray([[1, 2, 3]])
    unpack = tr.rerank_rows(["topic"], rows, top_k=2, fetch=False)
    assert callable(unpack)
    np.testing.assert_array_equal(unpack()[1], tr.rerank_rows(["topic"], rows, top_k=2)[1])
    seq, mask, types = tr.pack_pairs(torch.zeros((1, 8), dtype=torch.int32),
                                     torch.zeros((1,), dtype=torch.int32),
                                     torch.tensor([[0]]))
    assert seq.shape == (1, 1, tr.L) and int(mask.sum()) == int((seq != 0).sum())
    with pytest.raises(RuntimeError, match="build_table"):
        DeviceReranker(tr.ce).rerank_rows(["q"], rows)
