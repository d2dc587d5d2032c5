"""ctypes bridges to the native (C++) BM25 bulk build and the model tokenizers.

The port's own bridges to the shared sources `native/bm25_build.cpp` (bulk
BM25 build, query term ids) and `native/tokenizer.cpp` (FNV-1a hash and
greedy WordPiece tokenizers over ASCII texts), read, never edited. Each is
compiled with `g++ -O3` at first use into `build/native/` at the root of the
checkout, named by a hash of its source. Without a compiler the callers take
their Python paths (`index/bm25.py`, `models/tokenizer.py`), which give the
same ids.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "bm25_build.cpp"
_TOK_SRC = _ROOT / "native" / "tokenizer.cpp"
_BUILD_DIR = _ROOT / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_tok_lib: Optional[ctypes.CDLL] = None
_tok_failed = False


def _compile(src: Path) -> Optional[Path]:
    """g++-compile one source into a shared object named by its hash."""
    if not src.is_file():
        return None
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    so = _BUILD_DIR / f"{src.stem}_{digest}.so"
    if so.is_file():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        logger.info("native %s unavailable (%s); using the python path", src.stem, exc)
        return None
    os.replace(tmp, so)
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _compile(_SRC)
        if so is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        lib.bm25_build.restype = ctypes.c_void_p
        lib.bm25_build.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_void_p]
        lib.bm25_build_free.restype = None
        lib.bm25_build_free.argtypes = [ctypes.c_void_p]
        for name in ("bm25_num_terms", "bm25_num_postings",
                     "bm25_term_bytes_len", "bm25_doc_terms_len"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name, restype in (
            ("bm25_term_bytes", ctypes.c_void_p),
            ("bm25_term_offsets", ctypes.POINTER(ctypes.c_int64)),
            ("bm25_df", ctypes.POINTER(ctypes.c_int64)),
            ("bm25_term_start", ctypes.POINTER(ctypes.c_int64)),
            ("bm25_post_rows", ctypes.POINTER(ctypes.c_int32)),
            ("bm25_post_tfs", ctypes.POINTER(ctypes.c_float)),
            ("bm25_doc_lens", ctypes.POINTER(ctypes.c_int32)),
            ("bm25_doc_term_start", ctypes.POINTER(ctypes.c_int64)),
            ("bm25_doc_term_ids", ctypes.POINTER(ctypes.c_int32)),
            ("bm25_doc_term_tfs", ctypes.POINTER(ctypes.c_int32)),
        ):
            getattr(lib, name).restype = restype
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.bm25_query_ctx_new.restype = ctypes.c_void_p
        lib.bm25_query_ctx_new.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.bm25_query_ctx_free.restype = None
        lib.bm25_query_ctx_free.argtypes = [ctypes.c_void_p]
        lib.bm25_query_tids.restype = ctypes.c_int64
        lib.bm25_query_tids.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def _pack_blobs(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    blobs = [t.encode("utf-8", errors="replace") for t in texts]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return b"".join(blobs), offsets


class QueryTokenizer:
    """Native query tokenize-to-term-ids over a frozen vocabulary snapshot:
    (B, max_terms) int32 unique in-vocab term ids per query, -1 pad, with
    the semantics of `index/bm25.tokenize`."""

    def __init__(self, lib: ctypes.CDLL, terms: Sequence[str]) -> None:
        self._lib = lib
        self._blob, offsets = _pack_blobs(terms)  # kept alive for the C side
        self._offsets = offsets
        self._handle = lib.bm25_query_ctx_new(
            ctypes.cast(ctypes.c_char_p(self._blob), ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p), len(terms))

    def tids_batch(self, texts: Sequence[str], cap_tokens: int, max_terms: int) -> np.ndarray:
        blob, offsets = _pack_blobs(texts)
        out = np.full((len(texts), max_terms), -1, np.int32)
        self._lib.bm25_query_tids(
            self._handle, ctypes.cast(ctypes.c_char_p(blob), ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p), len(texts), cap_tokens, max_terms,
            out.ctypes.data_as(ctypes.c_void_p))
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.bm25_query_ctx_free(self._handle)
            self._handle = None

    def __del__(self) -> None:
        self.close()


def make_query_tokenizer(terms: Sequence[str]) -> Optional[QueryTokenizer]:
    lib = get_lib()
    return None if lib is None else QueryTokenizer(lib, terms)


class NativeBM25Build:
    """Result of a native bulk build (numpy copies of the C arrays)."""

    def __init__(self, terms: List[str], df: np.ndarray, term_start: np.ndarray,
                 post_rows: np.ndarray, post_tfs: np.ndarray, doc_lens: np.ndarray,
                 doc_term_start: np.ndarray, doc_term_ids: np.ndarray,
                 doc_term_tfs: np.ndarray) -> None:
        self.terms = terms
        self.df = df
        self.term_start = term_start
        self.post_rows = post_rows
        self.post_tfs = post_tfs
        self.doc_lens = doc_lens
        self.doc_term_start = doc_term_start
        self.doc_term_ids = doc_term_ids
        self.doc_term_tfs = doc_term_tfs


def bulk_build(texts: Sequence[str], rows: Sequence[int]) -> Optional[NativeBM25Build]:
    """Run the native builder; None when the native path is unavailable."""
    lib = get_lib()
    if lib is None or not texts:
        return None
    buf, offsets = _pack_blobs(texts)
    rows_arr = np.asarray(rows, np.int32)
    handle = lib.bm25_build(ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p),
                            offsets.ctypes.data_as(ctypes.c_void_p), len(texts),
                            rows_arr.ctypes.data_as(ctypes.c_void_p))
    if not handle:
        return None
    try:
        t = lib.bm25_num_terms(handle)
        p = lib.bm25_num_postings(handle)
        nb = lib.bm25_term_bytes_len(handle)
        dt = lib.bm25_doc_terms_len(handle)
        n = len(texts)

        def arr(fn, count, dtype):
            if count == 0:
                return np.zeros(0, dtype)
            return np.ctypeslib.as_array(fn(handle), shape=(count,)).astype(dtype, copy=True)

        term_bytes = ctypes.string_at(lib.bm25_term_bytes(handle), nb)
        term_offsets = arr(lib.bm25_term_offsets, t + 1, np.int64)
        terms = [term_bytes[term_offsets[i]:term_offsets[i + 1]].decode("utf-8")
                 for i in range(t)]
        return NativeBM25Build(
            terms=terms,
            df=arr(lib.bm25_df, t, np.int64),
            term_start=arr(lib.bm25_term_start, t + 1, np.int64),
            post_rows=arr(lib.bm25_post_rows, p, np.int32),
            post_tfs=arr(lib.bm25_post_tfs, p, np.float32),
            doc_lens=arr(lib.bm25_doc_lens, n, np.int32),
            doc_term_start=arr(lib.bm25_doc_term_start, n + 1, np.int64),
            doc_term_ids=arr(lib.bm25_doc_term_ids, dt, np.int32),
            doc_term_tfs=arr(lib.bm25_doc_term_tfs, dt, np.int32),
        )
    finally:
        lib.bm25_build_free(handle)


# --------------------------------------------------------------------------- #
# Tokenizer bridge (native/tokenizer.cpp)
# --------------------------------------------------------------------------- #

def get_tok_lib() -> Optional[ctypes.CDLL]:
    """The native tokenizer (compiled on first use); None without a compiler
    or when RADIANT_NO_NATIVE_TOKENIZER is set (the Python path then
    tokenizes, as in the JAX package)."""
    global _tok_lib, _tok_failed
    with _lock:
        if _tok_lib is not None or _tok_failed:
            return _tok_lib
        if os.environ.get("RADIANT_NO_NATIVE_TOKENIZER"):
            _tok_failed = True
            return None
        so = _compile(_TOK_SRC)
        if so is None:
            _tok_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        lib.tok_hash_batch.restype = None
        lib.tok_hash_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.wp_new.restype = ctypes.c_void_p
        lib.wp_new.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.wp_free.restype = None
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_tokenize_batch.restype = None
        lib.wp_tokenize_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        _tok_lib = lib
        return _tok_lib


def _ragged(out_ids: np.ndarray, out_lens: np.ndarray) -> List[List[int]]:
    return [out_ids[i, :out_lens[i]].tolist() for i in range(len(out_lens))]


def hash_tokenize_batch(texts: Sequence[str], vocab_size: int, reserved: int,
                        max_ids: int) -> Optional[List[List[int]]]:
    """FNV-1a hash token ids of ASCII texts, at most max_ids each; None when
    the native path is unavailable. Callers route non-ASCII texts to Python."""
    lib = get_tok_lib()
    if lib is None or not texts:
        return None
    buf, offsets = _pack_blobs(texts)
    n = len(texts)
    out_ids = np.empty((n, max_ids), np.int32)
    out_lens = np.empty((n,), np.int32)
    lib.tok_hash_batch(ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p),
                       offsets.ctypes.data_as(ctypes.c_void_p), n, vocab_size, reserved,
                       max_ids, out_ids.ctypes.data_as(ctypes.c_void_p),
                       out_lens.ctypes.data_as(ctypes.c_void_p))
    return _ragged(out_ids, out_lens)


class NativeWordPiece:
    """A native greedy-WordPiece vocabulary, built once and reused."""

    def __init__(self, vocab: Dict[str, int], unk_id: int, lowercase: bool,
                 max_chars_per_word: int) -> None:
        lib = get_tok_lib()
        if lib is None:
            raise RuntimeError("native tokenizer unavailable")
        self._lib = lib
        terms = list(vocab)
        ids = np.asarray([vocab[t] for t in terms], np.int32)
        buf, offsets = _pack_blobs(terms)
        self._handle = lib.wp_new(ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p),
                                  offsets.ctypes.data_as(ctypes.c_void_p), len(terms),
                                  ids.ctypes.data_as(ctypes.c_void_p), unk_id,
                                  1 if lowercase else 0, max_chars_per_word)

    def tokenize_batch(self, texts: Sequence[str], max_ids: int) -> List[List[int]]:
        if not texts:
            return []
        buf, offsets = _pack_blobs(texts)
        n = len(texts)
        out_ids = np.empty((n, max_ids), np.int32)
        out_lens = np.empty((n,), np.int32)
        self._lib.wp_tokenize_batch(self._handle,
                                    ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p),
                                    offsets.ctypes.data_as(ctypes.c_void_p), n, max_ids,
                                    out_ids.ctypes.data_as(ctypes.c_void_p),
                                    out_lens.ctypes.data_as(ctypes.c_void_p))
        return _ragged(out_ids, out_lens)

    def close(self) -> None:
        if self._handle:
            self._lib.wp_free(self._handle)
            self._handle = None

    def __del__(self) -> None:
        self.close()
