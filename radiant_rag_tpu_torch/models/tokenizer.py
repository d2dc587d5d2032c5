"""Host-side tokenization for the encoders.

The port's own copy of `radiant_rag_tpu/models/tokenizer.py`, id for id:

  WordPieceTokenizer  greedy longest-match-first WordPiece over a local
                      `vocab.txt` (BERT uncased semantics)
  HashTokenizer       alnum word split + FNV-1a hash into the id space, for
                      deployments without a vocabulary file

Both run ASCII texts through the native bridge (`index/native.py`, built
from `native/tokenizer.cpp`) and other texts through Python; the two give
the same ids. Sequence lengths are bucketed so the encoders see a small set
of shapes.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from radiant_rag_tpu_torch.utils.hashing import stable_hash32

PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.I)

LENGTH_BUCKETS = (16, 32, 64, 128, 256, 384, 512)


def bucket_length(n: int, max_len: int) -> int:
    for b in LENGTH_BUCKETS:
        if n <= b <= max_len:
            return b
    return max_len


class _BaseTokenizer:
    vocab_size: int = 30522

    def tokenize_ids(self, text: str) -> List[int]:  # without special tokens
        raise NotImplementedError

    def tokenize_ids_batch(self, texts: Sequence[str], cap: int) -> List[List[int]]:
        """Each text's ids, truncated to `cap` (subclasses take the native
        path for ASCII texts)."""
        return [self.tokenize_ids(t)[:cap] for t in texts]

    def _mixed_batch(self, texts: Sequence[str], cap: int, native_fn) -> List[List[int]]:
        """native_fn on the ASCII texts, Python on the rest, in order."""
        ascii_idx = [i for i, t in enumerate(texts) if t.isascii()]
        out: List[Optional[List[int]]] = [None] * len(texts)
        if ascii_idx:
            for i, ids in zip(ascii_idx, native_fn([texts[i] for i in ascii_idx], cap)):
                out[i] = ids
        return [ids if ids is not None else self.tokenize_ids(texts[i])[:cap]
                for i, ids in enumerate(out)]

    def encode_batch(self, texts: Sequence[str], max_len: int = 256,
                     pairs: Optional[Sequence[str]] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(input_ids, attention_mask, token_type_ids) int32, padded to one
        bucketed length. Pairs are packed [CLS] a [SEP] b [SEP], truncated
        proportionally to max_len - 3."""
        encoded: List[Tuple[List[int], List[int]]] = []
        a_ids = self.tokenize_ids_batch(texts, cap=max_len)
        b_ids = self.tokenize_ids_batch(pairs, cap=max_len) if pairs is not None else None
        for i in range(len(texts)):
            a = a_ids[i]
            if b_ids is not None:
                b = b_ids[i]
                budget = max_len - 3
                if len(a) + len(b) > budget:
                    half = budget // 2
                    if len(a) <= half:
                        b = b[:budget - len(a)]
                    elif len(b) <= half:
                        a = a[:budget - len(b)]
                    else:
                        a, b = a[:half], b[:budget - half]
                ids = [CLS_ID] + a + [SEP_ID] + b + [SEP_ID]
                types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
            else:
                ids = [CLS_ID] + a[:max_len - 2] + [SEP_ID]
                types = [0] * len(ids)
            encoded.append((ids, types))

        longest = max((len(ids) for ids, _ in encoded), default=1)
        blen = bucket_length(longest, max_len)
        n = len(texts)
        input_ids = np.full((n, blen), PAD_ID, np.int32)
        attn = np.zeros((n, blen), np.int32)
        type_ids = np.zeros((n, blen), np.int32)
        for i, (ids, types) in enumerate(encoded):
            ids, types = ids[:blen], types[:blen]
            input_ids[i, :len(ids)] = ids
            attn[i, :len(ids)] = 1
            type_ids[i, :len(types)] = types
        return input_ids, attn, type_ids


class HashTokenizer(_BaseTokenizer):
    """Deterministic hash tokenizer (no vocabulary file)."""

    def __init__(self, vocab_size: int = 30522) -> None:
        if vocab_size < 128:
            raise ValueError("HashTokenizer needs vocab_size >= 128 (special ids < 103)")
        self.vocab_size = vocab_size
        # ids below this are special or unused; scaled down for tiny vocabularies
        self._reserved = min(999, max(103, vocab_size // 4))

    def tokenize_ids(self, text: str) -> List[int]:
        span = self.vocab_size - self._reserved
        return [self._reserved + (stable_hash32(w) % span)
                for w in _WORD_RE.findall(text.lower())]

    def tokenize_ids_batch(self, texts: Sequence[str], cap: int) -> List[List[int]]:
        from radiant_rag_tpu_torch.index import native

        if native.get_tok_lib() is None:
            return super().tokenize_ids_batch(texts, cap)
        return self._mixed_batch(texts, cap, lambda batch, c: native.hash_tokenize_batch(
            batch, self.vocab_size, self._reserved, c))


class WordPieceTokenizer(_BaseTokenizer):
    """Greedy longest-match-first WordPiece (BERT uncased semantics)."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 100) -> None:
        self.vocab = vocab
        self.vocab_size = max(vocab.values()) + 1
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.unk_id = vocab.get("[UNK]", UNK_ID)
        self._native = None  # the native vocabulary, built at first use

    @classmethod
    def from_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as fh:
            return cls({line.rstrip("\n"): i for i, line in enumerate(fh)})

    def tokenize_ids_batch(self, texts: Sequence[str], cap: int) -> List[List[int]]:
        from radiant_rag_tpu_torch.index import native

        if self._native is None and native.get_tok_lib() is not None:
            self._native = native.NativeWordPiece(self.vocab, self.unk_id, self.lowercase,
                                                  self.max_chars_per_word)
        if self._native is None:
            return super().tokenize_ids_batch(texts, cap)
        return self._mixed_batch(texts, cap, self._native.tokenize_batch)

    def tokenize_ids(self, text: str) -> List[int]:
        if self.lowercase:
            text = text.lower()
        out: List[int] = []
        for word in _WORD_RE.findall(text):
            if len(word) > self.max_chars_per_word:
                out.append(self.unk_id)
                continue
            start, word_ids = 0, []
            while start < len(word):
                end, cur = len(word), None
                while start < end:
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    cur = self.vocab.get(piece)
                    if cur is not None:
                        break
                    end -= 1
                if cur is None:
                    word_ids = [self.unk_id]
                    break
                word_ids.append(cur)
                start = end
            out.extend(word_ids)
        return out


def load_tokenizer(model_dir: str = "", vocab_size: int = 30522) -> _BaseTokenizer:
    """WordPiece from `model_dir/vocab.txt` when it exists, else the hash tokenizer."""
    if model_dir:
        vocab_path = Path(model_dir) / "vocab.txt"
        if vocab_path.is_file():
            return WordPieceTokenizer.from_vocab_file(str(vocab_path))
    return HashTokenizer(vocab_size)
