"""ctypes bridge to the native (C++) bulk BM25 builder and query tokenizer.

The port's own bridge to the shared source `native/bm25_build.cpp` (read,
never edited). It is compiled with `g++ -O3` at first use into
`build/native/` at the root of the checkout, named by a hash of the source.
Without a compiler the callers take their Python paths (`index/bm25.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "bm25_build.cpp"
_BUILD_DIR = _ROOT / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _compile() -> Optional[Path]:
    if not _SRC.is_file():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    so = _BUILD_DIR / f"bm25_build_{digest}.so"
    if so.is_file():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        logger.info("native bm25 builder unavailable (%s); using the python path", exc)
        return None
    os.replace(tmp, so)
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _compile()
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
