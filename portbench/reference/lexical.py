"""The BM25 leg, from the corpus words.

  terms     each corpus word is one term (text.single_token_words holds it)
  idf       ln((n - df + 0.5) / (df + 0.5) + 1), in float64, kept as float32
  impact    idf tf (k1 + 1) / max(tf + k1 (1 - b + b dl / avgdl), 1e-6), float32
  sketch    per (doc, bin): the float64 sum of impact x sign over the doc's
            terms in that bin; one scale, max |sum| / 127; codes
            round(sum / scale) clamped to +-127 (int8)
  query     its distinct terms (at most max_query_terms, in order); the
            indicator adds each term's sign at its bin
  route     the pages route when every query is rare (its terms' postings
            <= pages_route_threshold) or holds a term in at most
            disc_route_df_frac of the docs, within max pages and B x N
            cells; else the sketch route
  sketch    stage 1: the indicator's integer product with the sketch, the
  route     kc best (ties to the lower row) with a positive score, in row
            order; then their exact BM25 (the sum of the query terms'
            impacts) and the k best, ties to the lower row, kept where > 0
  pages     exact BM25 over each query's postings, rare terms first, at
  route     most max_postings per query; the k best, kept where > 0

Scores are float32 in the port's operation order (float32 arithmetic
rounds the same whichever program computes it) so equal sums stay equal;
`Precision.lexical == "bfloat16"` rounds the impacts (the control).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from reference.dense import NEG_INF, top_rows, topk_first
from reference.precision import FULL, Precision, tf32_off, rounded
from reference.text import sketch_bin, sketch_sign

PAGE_SIZE = 2048


@dataclasses.dataclass
class Lexicon:
    n: int
    k1: float
    b: float
    idf: np.ndarray  # (V,) float32 per word index
    df: np.ndarray  # (V,) int64
    avgdl: float
    doc_len: float  # every doc's token count
    tf_words: torch.Tensor  # (N, W) int64 word index of each token (device)
    sketch: torch.Tensor  # (N, S) int8 (device)
    bins: np.ndarray  # (V,) int64
    signs: np.ndarray  # (V,) int8
    postings: Dict[int, np.ndarray]  # word -> sorted rows (built on demand)
    words_host: np.ndarray


def build(words: np.ndarray, vocab: Sequence[str], cfg: Dict, device) -> Lexicon:
    n, w = words.shape
    k1, b, s_dim = float(cfg["k1"]), float(cfg["b"]), int(cfg["sketch_dim"])
    srt = np.sort(words, axis=1)
    first = np.ones_like(srt, dtype=bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    # tf of each distinct (doc, word): run lengths of the sorted row
    pos = np.nonzero(first.reshape(-1))[0]
    ends = np.append(pos[1:], srt.size)
    tf = (ends - pos).astype(np.float32)
    term = srt.reshape(-1)[pos].astype(np.int64)
    doc = pos // w
    v = len(vocab)
    df = np.bincount(term, minlength=v).astype(np.int64)
    idf = np.log((n - df.astype(np.float64) + 0.5) / (df.astype(np.float64) + 0.5)
                 + 1.0).astype(np.float32)
    avgdl = float(w)  # every doc holds its words_per_doc tokens
    bins = np.asarray([sketch_bin(t, s_dim) for t in vocab], np.int64)
    signs = np.asarray([sketch_sign(t) for t in vocab], np.int8)
    dl = np.full(tf.shape, float(w), np.float32)  # float32 arrays: the port's arithmetic
    denom = tf + k1 * (1.0 - b + b * dl / max(avgdl, 1e-6))
    imp = (idf[term] * tf * (k1 + 1.0) / np.maximum(denom, 1e-6)) * signs[term]
    flat = torch.from_numpy(doc * s_dim + bins[term]).to(device)
    sums = torch.zeros((n * s_dim,), dtype=torch.float64, device=device)
    sums.index_add_(0, flat, torch.from_numpy(imp.astype(np.float64)).to(device))
    scale = max(float(sums.abs().max()) / 127.0, 1e-6)
    sketch = torch.round(sums / scale).clamp_(-127, 127).to(torch.int8).view(n, s_dim)
    del sums, flat
    return Lexicon(n=n, k1=k1, b=b, idf=idf, df=df, avgdl=avgdl, doc_len=float(w),
                   tf_words=torch.from_numpy(words.astype(np.int64)).to(device),
                   sketch=sketch, bins=bins, signs=signs,
                   postings={}, words_host=words)


def query_terms(lex: Lexicon, query_words: np.ndarray, max_terms: int) -> np.ndarray:
    """(B, max_terms) distinct word indices per query in first-seen order, -1 pad."""
    out = np.full((query_words.shape[0], max_terms), -1, np.int64)
    for i, row in enumerate(query_words):
        seen: List[int] = []
        for t in row[:max_terms].tolist():
            if t not in seen:
                seen.append(t)
        out[i, :len(seen)] = seen
    return out


def routes_pages(lex: Lexicon, tids: np.ndarray, cfg: Dict, num_rows: int) -> bool:
    per = np.where(tids >= 0, lex.df[np.maximum(tids, 0)], 0)
    small = per.sum(axis=1) <= int(cfg["bm25_pages_route_threshold"])
    cap = max(1.0, float(cfg["disc_route_df_frac"]) * lex.n)
    disc = ((per > 0) & (per <= cap)).any(axis=1)
    if not bool(np.all(small | disc)):
        return False
    if int(np.ceil(per / PAGE_SIZE).sum()) > int(cfg["pages_route_max_pages"]):
        return False
    return tids.shape[0] * num_rows <= int(cfg["pages_route_max_cells"])


def _impact(lex: Lexicon, tids: torch.Tensor, tf: torch.Tensor, prec: Precision):
    idf = torch.from_numpy(lex.idf).to(tf.device)[tids.clamp_min(0)]
    dl = torch.tensor(lex.doc_len, dtype=torch.float32, device=tf.device)
    avgdl = torch.tensor(lex.avgdl, dtype=torch.float32, device=tf.device)
    denom = tf + lex.k1 * (1.0 - lex.b + lex.b * dl / avgdl.clamp_min(1e-6))
    imp = idf * tf * (lex.k1 + 1.0) / denom.clamp_min(1e-6)
    return rounded(torch.where(tids >= 0, imp, 0.0), prec.lexical)


def exact_scores(lex: Lexicon, tids: torch.Tensor, rows: torch.Tensor,
                 prec: Precision = FULL) -> torch.Tensor:
    """(B, K) exact BM25 of rows (-1: NEG_INF) for (B, T) query terms."""
    doc = lex.tf_words[rows.clamp_min(0)]  # (B, K, W)
    tf = (doc[:, :, :, None] == tids[:, None, None, :]).sum(2).to(torch.float32)  # (B, K, T)
    sc = rounded(_impact(lex, tids[:, None, :].expand_as(tf), tf, prec).sum(-1), prec.lexical)
    return torch.where(rows >= 0, sc, NEG_INF)


def indicator(lex: Lexicon, tids: np.ndarray) -> np.ndarray:
    out = np.zeros((tids.shape[0], lex.sketch.shape[1]), np.float32)
    qi, pos = np.nonzero(tids >= 0)
    np.add.at(out, (qi, lex.bins[tids[qi, pos]]), lex.signs[tids[qi, pos]].astype(np.float32))
    return out


def sketch_leg(lex: Lexicon, tids: np.ndarray, kc: int, k: int, prec: Precision = FULL,
               block: int = 128):
    """The sketch route: (scores (B, k) float32, rows (B, k) int64, -1 kept empty)."""
    dev = lex.sketch.device
    sk = lex.sketch.to(torch.float32)
    ind = torch.from_numpy(indicator(lex, tids)).to(dev)
    cands = []
    with tf32_off():
        for s0 in range(0, ind.shape[0], block):
            raw, rows = top_rows(ind[s0:s0 + block] @ sk.T, kc)
            rows = torch.where(raw > 0, rows, -1)
            big = torch.where(rows < 0, 1 << 40, rows)
            srt = torch.sort(big, dim=1).values
            cands.append(torch.where(srt >= 1 << 40, -1, srt))
    cand = torch.cat(cands)
    t = torch.from_numpy(tids).to(dev)
    ex = exact_scores(lex, t, cand, prec)
    top_s, pos = topk_first(ex, k)
    rows = cand.gather(1, pos)
    return top_s, torch.where(top_s > 0.0, rows, -1)


def _postings(lex: Lexicon, word: int) -> np.ndarray:
    p = lex.postings.get(word)
    if p is None:
        p = np.nonzero((lex.words_host == word).any(axis=1))[0]
        lex.postings[word] = p
    return p


def pages_leg(lex: Lexicon, tids: np.ndarray, k: int, max_postings: int,
              prec: Precision = FULL):
    """The pages route: exact BM25 over each query's kept postings."""
    dev = lex.sketch.device
    scores = torch.zeros((tids.shape[0], lex.n), dtype=torch.float32, device=dev)
    for qi, row in enumerate(tids):
        terms = sorted([int(t) for t in row if t >= 0], key=lambda t: int(lex.df[t]))
        budget = max_postings
        for t in terms:
            if budget <= 0:
                break
            rows = _postings(lex, t)[:budget]
            budget -= len(rows)
            r = torch.from_numpy(rows).to(dev)
            tf = (lex.tf_words[r] == t).sum(1).to(torch.float32)
            tt = torch.full_like(r, t)
            scores[qi].index_add_(0, r, _impact(lex, tt, tf, prec))
    scores = torch.where(scores > 0.0, scores, NEG_INF)
    top_s, rows = topk_first(scores, k)
    return top_s, torch.where(top_s > 0.0, rows, -1)
