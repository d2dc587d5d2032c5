"""The plain reference against brute force at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from reference import calibration as rcal
from reference import dense as rd
from reference import encoder as renc
from reference import fusion as rfu
from reference import lexical as rlex
from reference import rerank as rrr
from reference.text import fnv1a32, hash_ids, single_token_words, sketch_bin, sketch_sign

CPU = torch.device("cpu")


def test_fnv_and_hash_ids():
    assert fnv1a32("") == 0x811C9DC5 and fnv1a32("a") == 0xE40C292C
    reserved = min(999, max(103, 30522 // 4))
    assert hash_ids("W12 w3", 30522) == [reserved + fnv1a32(w) % (30522 - reserved)
                                         for w in ("w12", "w3")]
    assert single_token_words(["w0", "w12"]) and not single_token_words(["a", "x-y"])


def test_stage1_and_rescore_brute_force():
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(-3, 4, (200, 16), generator=g).to(torch.int8)  # many ties
    q = torch.randint(-3, 4, (5, 16), generator=g).float()
    cand = rd.stage1(codes.float(), q, 12)
    sc = q.numpy() @ codes.numpy().astype(np.float32).T
    for i in range(5):
        order = sorted(range(200), key=lambda r: (-sc[i, r], r))[:12]
        assert cand[i].tolist() == sorted(order)
    vecs = torch.randn((200, 16), generator=g)
    qv = torch.randn((5, 16), generator=g)
    s, rows = rd.rescore(qv, cand, vecs, 4)
    for i in range(5):
        dots = [(float(vecs[r] @ qv[i]), r) for r in cand[i].tolist()]
        want = sorted(dots, key=lambda t: -t[0])[:4]
        assert rows[i].tolist() == [r for _, r in want]
        assert s[i].tolist() == pytest.approx([d for d, _ in want], abs=1e-5)


def test_int8_codes_and_queries():
    x = torch.tensor([[0.0, 1.0], [1.0, -1.0], [0.5, 0.0]])
    lo, hi = rd.int8_ranges(x)
    c = rd.int8_codes(x, lo, hi)
    # the midpoint lands just under x.5: the scale is (hi - lo) * f32(1/255)
    assert c[:, 0].tolist() == [-128, 127, -1] and c[:, 1].tolist() == [127, -128, -1]
    s, o = rd.scale_offset(lo, hi)
    assert torch.allclose(c.float() * s + o, x, atol=0.5 / 255 * 2 + 1e-6)
    qi = rd.int8_queries(torch.tensor([[0.2, -0.4]]), torch.tensor([1.0, 1.0]))
    assert qi.tolist() == [[64.0, -127.0]]


def _bm25_brute(words, query, k1, b):
    n, w = words.shape
    df = {}
    for row in words:
        for t in set(row.tolist()):
            df[t] = df.get(t, 0) + 1
    out = np.zeros(n)
    for d, row in enumerate(words):
        for t in set(query):
            tf = int((row == t).sum())
            if tf:
                idf = math.log((n - df[t] + 0.5) / (df[t] + 0.5) + 1.0)
                out[d] += idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * w / w))
    return out


@pytest.fixture(scope="module")
def lex():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 30, (120, 8))
    vocab = [f"w{i}" for i in range(30)]
    return words, vocab, rlex.build(words, vocab, {"k1": 1.5, "b": 0.75, "sketch_dim": 16}, CPU)


def test_bm25_exact_scores(lex):
    words, _, lx = lex
    query = [3, 7, 7, 11]
    tids = rlex.query_terms(lx, np.asarray([query]), 32)
    assert tids[0, :3].tolist() == [3, 7, 11] and (tids[0, 3:] == -1).all()
    got = rlex.exact_scores(lx, torch.from_numpy(tids), torch.arange(120)[None])[0]
    assert got.double().numpy() == pytest.approx(_bm25_brute(words, query, 1.5, 0.75), rel=1e-5)


def test_sketch_brute_force(lex):
    words, vocab, lx = lex
    brute = _bm25_brute  # the impact of one term alone
    sums = np.zeros((120, 16))
    for t in range(30):
        imp = brute(words, [t], 1.5, 0.75)
        sums[:, sketch_bin(vocab[t], 16)] += imp * sketch_sign(vocab[t])
    scale = np.abs(sums).max() / 127.0
    want = np.clip(np.round(sums / scale), -127, 127)
    assert np.abs(lx.sketch.numpy() - want).max() <= 1  # float32 impacts at a .5 boundary
    assert (lx.sketch.numpy() == want).mean() > 0.99


def test_sketch_leg_rescores_exactly(lex):
    words, _, lx = lex
    tids = rlex.query_terms(lx, np.asarray([[3, 7, 11], [5, 5, 9]]), 32)
    s, rows = rlex.sketch_leg(lx, tids, kc=120, k=5)
    for i, q in enumerate(([3, 7, 11], [5, 9])):
        exact = _bm25_brute(words, q, 1.5, 0.75)
        want = sorted(range(120), key=lambda r: (-exact[r], r))[:5]
        assert rows[i].tolist() == [r if exact[r] > 0 else -1 for r in want]


def test_fusion_brute_force():
    dense = torch.tensor([[4, 1, 9, -1]])
    lexical = torch.tensor([[1, 5, 4, 2]])
    s, rows = rfu.fuse("confidence", [dense, lexical], [torch.zeros(1, 4)] * 2, [0.25, 0.75],
                       60, 4)
    mass = {}
    for w, leg in ((0.25, dense[0].tolist()), (0.75, lexical[0].tolist())):
        for rank, r in enumerate(leg, 1):
            if r >= 0:
                mass[r] = mass.get(r, 0.0) + w / (60 + rank)
    first = {r: i for i, r in reversed(list(enumerate(dense[0].tolist() + lexical[0].tolist())))}
    want = sorted(mass, key=lambda r: (-mass[r], first[r]))[:4]
    assert rows[0].tolist() == want
    assert s[0].tolist() == pytest.approx([mass[r] for r in want], rel=1e-6)
    assert rfu.calibrated_weights([0.0, 0.8]) == pytest.approx([0.005 / 1.005, 1 / 1.005])


def test_score_fusion_brute_force():
    dense = torch.tensor([[4, 1, 9, -1]])
    d_s = torch.tensor([[0.9, 0.7, 0.4, -1e30]])
    lexical = torch.tensor([[1, 5, 4, 2]])
    l_s = torch.tensor([[12.0, 9.0, 3.0, 2.5]])
    w = [0.3, 0.7]
    s, rows = rfu.fuse("score", [dense, lexical], [d_s, l_s], w, 60, 4)
    mass = {}
    for wt, leg, sc in ((w[0], dense[0].tolist(), d_s[0].tolist()),
                        (w[1], lexical[0].tolist(), l_s[0].tolist())):
        live = [(r, x) for r, x in zip(leg, sc) if r >= 0]
        mu = sum(x for _, x in live) / len(live)
        sd = math.sqrt(sum((x - mu) ** 2 for _, x in live) / len(live) + 1e-12)
        zmin = min((x - mu) / sd for _, x in live)
        for r, x in live:
            mass[r] = mass.get(r, 0.0) + wt * ((x - mu) / sd - zmin + 0.05)
    first = {r: i for i, r in reversed(list(enumerate(dense[0].tolist() + lexical[0].tolist())))}
    want = sorted((r for r in mass if r >= 0), key=lambda r: (-mass[r], first[r]))[:4]
    assert rows[0].tolist() == want
    assert s[0].tolist() == pytest.approx([mass[r] for r in want], rel=1e-5)


def test_calibration_probes_are_the_ports():
    """The reference's probes equal the port's (its ICT spans and
    paraphrases of the same rows, drawn by the same generator)."""
    from radiant_rag_tpu_torch.parallel.data import make_paraphrase_query, make_pseudo_query

    rng = np.random.default_rng(3)
    words = rng.integers(0, 500, (300, 48))
    vocab = [f"w{k}" for k in range(500)]
    texts = [" ".join(vocab[t] for t in row) for row in words]
    targets, spans = rcal.probes(words, 64, 11, 0.5)
    port = np.random.default_rng(11)
    rows = list(range(300))
    port.shuffle(rows)
    want = []
    for r in rows[:64]:
        t = texts[r]
        want.append(make_paraphrase_query(t, port, max_words=8) if port.random() < 0.5
                    else make_pseudo_query(t, port, max_words=8))
    assert targets.tolist() == rows[:64]
    assert list(rcal.texts_of(spans, vocab)) == want


def test_calibration_mrr():
    rows = np.array([[3, 1, 2], [-1, 5, 7], [0, 9, 8]])
    assert rcal.mrr(rows, np.array([1, 7, 4]), range(3)) == pytest.approx((1 / 2 + 1 / 2) / 3)


def test_encoder_batch_equals_one_at_a_time():
    h, heads, ff = 16, 2, 32
    cfg = {"num_attention_heads": heads, "num_hidden_layers": 2, "vocab_size": 2000,
           "query_max_seq_len": 32}
    g = torch.Generator().manual_seed(3)

    def r(*s):
        return torch.randn(s, generator=g) * 0.2

    P = {"word_emb.weight": r(2000, h), "pos_emb.weight": r(64, h), "type_emb.weight": r(2, h),
         "emb_ln.weight": torch.ones(h), "emb_ln.bias": torch.zeros(h)}
    for i in range(2):
        for part in ("query", "key", "value", "out"):
            P[f"layer_{i}.attention.{part}.weight"] = r(h, h)
            P[f"layer_{i}.attention.{part}.bias"] = r(h)
        P[f"layer_{i}.mlp_in.weight"], P[f"layer_{i}.mlp_in.bias"] = r(ff, h), r(ff)
        P[f"layer_{i}.mlp_out.weight"], P[f"layer_{i}.mlp_out.bias"] = r(h, ff), r(h)
        for ln in ("attn_ln", "mlp_ln"):
            P[f"layer_{i}.{ln}.weight"], P[f"layer_{i}.{ln}.bias"] = torch.ones(h), torch.zeros(h)
    texts = ["w1 w2", "w3 w4 w5 w6 w7", "w8"]
    batch = renc.embed_texts(P, cfg, texts, CPU)
    alone = torch.cat([renc.embed_texts(P, cfg, [t], CPU) for t in texts])
    assert torch.allclose(batch, alone, atol=1e-6)
    assert torch.allclose(batch.norm(dim=1), torch.ones(3), atol=1e-6)


def test_blend_brute_force():
    logits = torch.tensor([[1.0, 2.0, 0.5, 9.0]])
    prior = torch.tensor([[0.3, 0.1, 0.2, 7.0]])
    live = torch.tensor([[True, True, True, False]])
    got = rrr.blend(logits, prior, live, 1.0)[0]

    def z(x):
        x = np.asarray(x[:3])
        return (x - x.mean()) / np.sqrt(x.var() + 1e-9)

    want = z([1.0, 2.0, 0.5]) + z([0.3, 0.1, 0.2])
    assert got[:3].tolist() == pytest.approx(want.tolist(), rel=1e-5)
    assert got[3] == float("-inf")
