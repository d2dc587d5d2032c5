"""Device BM25 scoring: exact page-table scoring and the impact-sketch scan.

Counterpart of `radiant_rag_tpu/ops/bm25.py`. BM25 as in the reference:
  idf(t)   = ln((n - df + 0.5) / (df + 0.5) + 1)
  score(d) = sum_t idf * tf (k1 + 1) / (tf + k1 (1 - b + b dl_d / avgdl))

  bm25_score_topk           exact BM25 + top-k from host-gathered padded
                            postings (the simple reference form)
  bm25_pages_scores         exact (B, N) scores from the device CSR postings
                            and a host page table, by a 2-D scatter-add
  bm25_pages_score_topk     the same + top-k
  bm25_sketch_select        stage 1: a (B, S) signed int8 query indicator
                            times the (N, S) int8 impact sketch, with the
                            candidate selection in the same kernel as the
                            dense leg's
  bm25_candidate_rescore    exact BM25 of the candidates over the doc-major
                            (N, L) term tables, as a (B, KC, L, T) equality
                            join: the PyTorch form of stage 2's scoring
  bm25_sketch_rescore_topk  both stages + top-k (returned scores are exact)

Stage 2, the candidates' exact BM25 and its top-k, is one CUDA kernel on the
card, `cuda_kernels.bm25_rescore_topk` (csrc/bm25_rescore_topk.cu); on the
CPU it is its plain version `cuda_kernels.bm25_rescore_topk_reference`:
the candidates sorted by row, `bm25_candidate_rescore`, `topk_first`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from radiant_rag_tpu_torch.ops import cuda_kernels as ck
from radiant_rag_tpu_torch.ops.similarity import NEG_INF, scan_select, topk_first

PAGE_SIZE = 2048
_RESCORE_CELLS = 1 << 27  # (B, KC, L, T) compare cells per rescore step


def _impact(idf: torch.Tensor, tfs: torch.Tensor, dl: torch.Tensor,
            avgdl: torch.Tensor, k1: float, b: float) -> torch.Tensor:
    """Per-posting BM25 contribution, in the JAX package's operation order."""
    denom = tfs + k1 * (1.0 - b + b * dl / avgdl.clamp_min(1e-6))
    return idf * tfs * (k1 + 1.0) / denom.clamp_min(1e-6)


def bm25_score_topk(rows: torch.Tensor, tfs: torch.Tensor, idfs: torch.Tensor,
                    doc_lens: torch.Tensor, avgdl: torch.Tensor,
                    mask: Optional[torch.Tensor], k: int, num_docs: int,
                    k1: float = 1.5, b: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, P) padded postings (rows -1 = pad, tfs, their terms' idfs) ->
    (scores (B, k), rows (B, k) int32, -1 where the score is not > 0).
    Rows at or past num_docs are dropped, as the JAX scatter drops them."""
    keep = (rows >= 0) & (rows < num_docs)
    safe = torch.where(keep, rows, 0).long()
    contrib = _impact(idfs, tfs, doc_lens[safe], avgdl, k1, b)
    contrib = torch.where(keep, contrib, 0.0)
    scores = torch.zeros((rows.shape[0], num_docs), dtype=torch.float32, device=rows.device)
    scores.scatter_add_(1, safe, contrib)
    if mask is not None:
        scores = torch.where(mask[None, :], scores, NEG_INF)
    top_s, top_i = topk_first(scores, k)
    return top_s, torch.where(top_s > 0.0, top_i, -1).to(torch.int32)


def bm25_pages_scores(post_rows: torch.Tensor, post_tf: torch.Tensor,
                      page_start: torch.Tensor, page_len: torch.Tensor,
                      page_qidx: torch.Tensor, page_idf: torch.Tensor,
                      doc_lens: torch.Tensor, avgdl: torch.Tensor,
                      mask: Optional[torch.Tensor], b_queries: int, num_docs: int,
                      k1: float = 1.5, b: float = 0.75) -> torch.Tensor:
    """Dense (B, N) BM25 scores; rows no posting reached are NEG_INF when no
    mask is given, masked rows NEG_INF otherwise. The scatter uses 2-D
    (query, row) indices, so B * N >= 2^31 needs no flat offset."""
    ptot = post_rows.shape[0]
    offs = torch.arange(PAGE_SIZE, device=post_rows.device, dtype=torch.int64)[None, :]
    idx = (page_start.long()[:, None] + offs).clamp_max(ptot - 1)
    valid = offs < page_len.long()[:, None]
    rows = post_rows[idx].long()  # (Pg, PAGE)
    tfs = post_tf[idx]
    dl = doc_lens[rows.clamp_max(num_docs - 1)]
    contrib = _impact(page_idf[:, None], tfs, dl, avgdl, k1, b)
    contrib = torch.where(valid, contrib, 0.0)
    q_i = torch.where(valid, page_qidx.long()[:, None].expand_as(rows), 0)
    r_i = torch.where(valid, rows, 0)
    scores = torch.zeros((b_queries, num_docs), dtype=torch.float32, device=post_rows.device)
    scores.index_put_((q_i.reshape(-1), r_i.reshape(-1)), contrib.reshape(-1), accumulate=True)
    if mask is not None:
        return torch.where(mask[None, :], scores, NEG_INF)
    return torch.where(scores > 0.0, scores, NEG_INF)


def bm25_pages_score_topk(post_rows, post_tf, page_start, page_len, page_qidx, page_idf,
                          doc_lens, avgdl, mask, b_queries: int, num_docs: int, k: int,
                          k1: float = 1.5, b: float = 0.75
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page-table BM25 + top-k; (scores (B, k), rows (B, k) int32, -1 pad)."""
    scores = bm25_pages_scores(post_rows, post_tf, page_start, page_len, page_qidx, page_idf,
                               doc_lens, avgdl, mask, b_queries, num_docs, k1, b)
    top_s, top_i = topk_first(scores, k)
    return top_s, torch.where(top_s > 0.0, top_i, -1).to(torch.int32)


def bm25_sketch_select(sketch: torch.Tensor, scale: torch.Tensor, qind: torch.Tensor,
                       mask: Optional[torch.Tensor], k: int, select: str = ""
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sketch-scan candidates: (scores f32 = raw * scale, rows i32); rows are
    -1 where the doc shares no query bin (raw <= 0) or was masked."""
    raw_s, cand = scan_select(sketch, qind, mask, k, select)
    valid = (raw_s > NEG_INF / 2) & (raw_s > 0)
    top_s = torch.where(valid, raw_s * scale, NEG_INF)
    return top_s, torch.where(valid, cand, -1).to(torch.int32)


def bm25_candidate_rescore(doc_tids: torch.Tensor, doc_tfs: torch.Tensor,
                           doc_lens: torch.Tensor, avgdl: torch.Tensor,
                           cand: torch.Tensor, q_tids: torch.Tensor,
                           q_idfs: torch.Tensor, k1: float = 1.5, b: float = 0.75
                           ) -> torch.Tensor:
    """EXACT BM25 of (B, KC) candidate rows: the candidates' doc-major term
    rows are matched against the query's term ids (an equality join over
    (B, KC, L, T), taken a block of queries at a time to bound memory)."""
    safe = cand.clamp_min(0).long()
    bq, kc = cand.shape
    width, t = doc_tids.shape[1], q_tids.shape[1]
    step = max(1, _RESCORE_CELLS // max(1, kc * width * t))
    tf_parts = []
    for q0 in range(0, max(bq, 1), step):
        d_tids = doc_tids[safe[q0:q0 + step]]  # (b, KC, L)
        d_tfs = doc_tfs[safe[q0:q0 + step]].to(torch.float32)
        qt = q_tids[q0:q0 + step]
        eq = (d_tids[:, :, :, None] == qt[:, None, None, :]) & (d_tids[:, :, :, None] >= 0)
        tf_parts.append(torch.where(eq, d_tfs[:, :, :, None], 0.0).sum(dim=2))
    tf = torch.cat(tf_parts)  # (B, KC, T)
    dl = doc_lens[safe]
    contrib = _impact(q_idfs[:, None, :], tf, dl[:, :, None], avgdl, k1, b)
    contrib = torch.where(q_tids[:, None, :] >= 0, contrib, 0.0)
    scores = contrib.sum(dim=-1)
    return torch.where(cand >= 0, scores, NEG_INF)


def bm25_sketch_rescore_topk(sketch: torch.Tensor, scale: torch.Tensor, qind: torch.Tensor,
                             dm_tids: torch.Tensor, dm_tfs: torch.Tensor,
                             doc_lens: torch.Tensor, avgdl: torch.Tensor,
                             q_tids: torch.Tensor, q_idfs: torch.Tensor,
                             mask: Optional[torch.Tensor], k: int, kc: int,
                             k1: float = 1.5, b: float = 0.75, select: str = ""
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage BM25: the sketch scan's kc candidates, their exact BM25,
    top-k (the rescore's ties go to the lowest row)."""
    _s1, cand = bm25_sketch_select(sketch, scale, qind, mask, kc, select)
    return ck.bm25_rescore_topk(dm_tids, dm_tfs, doc_lens, avgdl, cand, q_tids, q_idfs, k,
                                k1, b)
