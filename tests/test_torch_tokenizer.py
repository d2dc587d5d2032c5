"""The port's tokenizers against the JAX package's: ids and `encode_batch`
arrays equal, exactly, on ASCII and non-ASCII text, through the native
bridge (`native/tokenizer.cpp`) and through Python."""

import random
import string

import numpy as np
import pytest

from radiant_rag_tpu.models import tokenizer as jtok
from radiant_rag_tpu_torch.index import native
from radiant_rag_tpu_torch.models import tokenizer as ttok

CHARS = (string.ascii_letters + string.digits + string.punctuation
         + " \t\n\r\x0b\x0c\x1c\x1d\x1e\x1f")
WP_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown", "fox", "jump",
            "##ed", "##ing", "##s", "over", "lazy", "dog", "un", "##believ", "##able", ",",
            ".", "!", "7", "##7", "caf", "##é"]


def _texts(seed, n=48):
    rng = random.Random(seed)
    out = ["".join(rng.choice(CHARS) for _ in range(rng.randrange(0, 160))) for _ in range(n)]
    return out + ["", "   ", "hello, WORLD!!", "a" * 300, "café résumé 中文 naïve",
                  "The quick brown fox jumped over the lazy dog!", "unbelievable jumps, 77.",
                  "zzz unknownword the", "reallyreallylongword fox", "MiXeD CaSe 42!"]


def _wp_vocab():
    return {w: i for i, w in enumerate(WP_WORDS)}


@pytest.mark.parametrize("vocab", [300, 8192, 30522])
def test_hash_tokenizer_ids_match_jax(vocab):
    t, j = ttok.HashTokenizer(vocab), jtok.HashTokenizer(vocab)
    assert t._reserved == j._reserved == min(999, max(103, vocab // 4))
    texts = _texts(vocab)
    assert [t.tokenize_ids(x) for x in texts] == [j.tokenize_ids(x) for x in texts]
    for cap in (5, 512):
        assert t.tokenize_ids_batch(texts, cap) == j.tokenize_ids_batch(texts, cap)


def test_wordpiece_ids_match_jax():
    t = ttok.WordPieceTokenizer(_wp_vocab(), max_chars_per_word=12)
    j = jtok.WordPieceTokenizer(_wp_vocab(), max_chars_per_word=12)
    texts = _texts(1)
    assert [t.tokenize_ids(x) for x in texts] == [j.tokenize_ids(x) for x in texts]
    assert t.tokenize_ids_batch(texts, 64) == j.tokenize_ids_batch(texts, 64)
    assert t.tokenize_ids("unbelievable") == [15, 16, 17]
    assert t.tokenize_ids("xyzzy fox") == [1, 7]  # an unmatched word is one [UNK]


def test_native_bridge_equals_python():
    """Native ids over ASCII texts are byte-identical to the Python path, and
    mixed batches keep their order (non-ASCII texts go through Python)."""
    if native.get_tok_lib() is None:
        pytest.skip("no C++ compiler: only the Python path exists here")
    texts = _texts(2)
    h = ttok.HashTokenizer(30522)
    assert h.tokenize_ids_batch(texts, 40) == [h.tokenize_ids(x)[:40] for x in texts]
    ascii_texts = [x for x in texts if x.isascii()]
    assert native.hash_tokenize_batch(ascii_texts, 30522, h._reserved, 40) == \
        [h.tokenize_ids(x)[:40] for x in ascii_texts]
    wp = ttok.WordPieceTokenizer(_wp_vocab(), max_chars_per_word=12)
    assert wp.tokenize_ids_batch(texts, 64) == [wp.tokenize_ids(x)[:64] for x in texts]
    assert isinstance(wp._native, native.NativeWordPiece)
    assert wp._native.tokenize_batch([], 8) == []


def test_python_path_without_the_native_library(monkeypatch):
    monkeypatch.setattr(native, "get_tok_lib", lambda: None)
    texts = _texts(3)
    h, j = ttok.HashTokenizer(8192), jtok.HashTokenizer(8192)
    assert h.tokenize_ids_batch(texts, 16) == j.tokenize_ids_batch(texts, 16)
    wp = ttok.WordPieceTokenizer(_wp_vocab())
    assert wp.tokenize_ids_batch(texts, 16) == [wp.tokenize_ids(x)[:16] for x in texts]
    assert wp._native is None


@pytest.mark.parametrize("max_len", [16, 40, 64, 384])
def test_encode_batch_matches_jax(max_len):
    """Single texts and pairs, including the proportional pair truncation
    (query short, doc short, both long)."""
    texts = _texts(max_len, n=20)
    long_a = " ".join(f"q{i}" for i in range(300))
    long_b = " ".join(f"d{i}" for i in range(300))
    qs = texts[:15] + [long_a, "short", long_a]
    ds = texts[15:30] + ["short", long_b, long_b]
    for vocab in (300, 30522):
        t, j = ttok.HashTokenizer(vocab), jtok.HashTokenizer(vocab)
        for got, ref in ((t.encode_batch(texts, max_len), j.encode_batch(texts, max_len)),
                         (t.encode_batch(qs, max_len, pairs=ds),
                          j.encode_batch(qs, max_len, pairs=ds))):
            for g, r in zip(got, ref):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, r)
    wp_t = ttok.WordPieceTokenizer(_wp_vocab())
    wp_j = jtok.WordPieceTokenizer(_wp_vocab())
    for g, r in zip(wp_t.encode_batch(qs, max_len, pairs=ds), wp_j.encode_batch(qs, max_len,
                                                                               pairs=ds)):
        np.testing.assert_array_equal(g, r)


def test_buckets_and_load_tokenizer(tmp_path):
    assert ttok.LENGTH_BUCKETS == jtok.LENGTH_BUCKETS
    assert (ttok.PAD_ID, ttok.UNK_ID, ttok.CLS_ID, ttok.SEP_ID) == \
        (jtok.PAD_ID, jtok.UNK_ID, jtok.CLS_ID, jtok.SEP_ID)
    for n in range(0, 600, 7):
        for max_len in (16, 40, 64, 256, 512):
            assert ttok.bucket_length(n, max_len) == jtok.bucket_length(n, max_len)
    assert isinstance(ttok.load_tokenizer("", 300), ttok.HashTokenizer)
    assert isinstance(ttok.load_tokenizer(str(tmp_path), 300), ttok.HashTokenizer)
    (tmp_path / "vocab.txt").write_text("\n".join(WP_WORDS) + "\n", encoding="utf-8")
    wp = ttok.load_tokenizer(str(tmp_path), 300)
    assert isinstance(wp, ttok.WordPieceTokenizer) and wp.vocab == _wp_vocab()
    assert wp.vocab_size == len(WP_WORDS)
    with pytest.raises(ValueError):
        ttok.HashTokenizer(100)


def test_no_native_tokenizer_switch_takes_the_python_path_as_jax(monkeypatch):
    """RADIANT_NO_NATIVE_TOKENIZER turns the native bridge off in both
    packages (read at its first load); the ids stay the JAX package's."""
    from radiant_rag_tpu.index import native as jnative

    monkeypatch.setenv("RADIANT_NO_NATIVE_TOKENIZER", "1")
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_tok_lib", None)
        monkeypatch.setattr(mod, "_tok_failed", False)
    assert native.get_tok_lib() is None and jnative.get_tok_lib() is None
    assert native._tok_failed
    texts = _texts(4)
    h, j = ttok.HashTokenizer(8192), jtok.HashTokenizer(8192)
    assert h.tokenize_ids_batch(texts, 16) == j.tokenize_ids_batch(texts, 16)
    wp = ttok.WordPieceTokenizer(_wp_vocab())
    assert wp._native is None
    assert wp.tokenize_ids_batch(texts, 16) == \
        jtok.WordPieceTokenizer(_wp_vocab()).tokenize_ids_batch(texts, 16)
