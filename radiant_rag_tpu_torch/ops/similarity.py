"""Similarity scans + top-k over a device-resident corpus.

Counterpart of `radiant_rag_tpu/ops/similarity.py`:

  exact_topk         fp32 cosine scan (matmul) + top-k: the recall oracle
                     and mode="exact"
  hamming_scan_topk  binary stage 1: XOR + popcount over packed sign words
                     and the candidate selection in one CUDA kernel
                     (`ops/cuda_kernels.hamming_scan_topk`), no (B, N) scores
  int8_scan_topk     asymmetric int8 stage 1: the query is scale-folded and
                     quantized to int8; the scan and the candidate selection
                     run in one CUDA kernel (`ops/cuda_kernels.int8_scan_topk`)
                     that never materializes (B, N) scores, or in the
                     block-max kernel under select="blockmax"
  two_stage_topk     stage 1 -> row-sorted candidates -> rescore -> top-k

Selection policies. The JAX package selects stage-1 candidates over a
materialized (B, N) buffer, in f32 or rounded to bf16 to halve that buffer
("bf16", "bf16_chunked"). The fused kernel has no such buffer, so every one
of "", "f32", "bf16" and "bf16_chunked" runs it, and its results equal the
JAX "f32" policy: the bf16 rounding of candidate scores is not reproduced.
"blockmax" runs the per-512-row-tile top-2 kernel. The binary stage 1
takes `select` and ignores it, as the JAX package's chunked Hamming scan
does ("blockmax" has no binary counterpart there either); it selects
exactly, lowest row first among ties.

Stage-1 depth. The fused scans keep per-query lists in shared memory, up to
k = `cuda_kernels.INT8_SCAN_TOPK_MAX_K`. Deeper selections (the
quality-optimized preset's kc = 960) take the exact-product route
(`stage1_route`): the (b, N) int32 product from the score kernel
(`cuda_kernels.int8_scores` or `hamming_scores`), a block of queries at a
time sized to the card's free memory (`product_query_block` of
`route_budget`), then an exact top-k over (score, row) keys -- the JAX
"f32" policy itself. The route is chosen by k before any launch; nothing
falls back.

Every top-k here breaks ties by the lowest index, as `lax.top_k` does
(`topk_first`); `torch.topk` promises no order among equal values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from radiant_rag_tpu_torch.ops import cuda_kernels as ck

NEG_INF = -1e30
SELECT_NEG = -3e38  # masked slot of the bf16 selection (blockmax small-N fallback)
FUSED_SELECTS = ("", "f32", "bf16", "bf16_chunked")
_BIG_ROW = 2**30
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))
# Peak transient bytes per (query, row) cell of a (B, N) score path: an f32
# or int32 score matrix, its masked copy and the int64 order keys of the
# top-k. The engine's gate and the exact-product route budget by it.
SCORE_BYTES_PER_CELL = 24
ROUTE_SLACK_BYTES = 2 << 30  # free card memory the exact-product route leaves
CPU_ROUTE_BYTES = 16 << 30  # its budget off the card (test-size runs)


def _f32_order(x: torch.Tensor) -> torch.Tensor:
    """int32 that orders like the f32 values of x in `lax.top_k`'s total
    order (-0.0 below +0.0): the sign-magnitude bits with the magnitude
    flipped for negative values."""
    bits = x.to(torch.float32, copy=True).view(torch.int32)
    flip = bits >> 31
    flip &= 0x7FFFFFFF
    bits ^= flip
    return bits


def topk_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim of a 2-D tensor, ties by the lowest index
    (`lax.top_k`'s rule), without a host sync: a top-k over unique int64
    keys (value order in the high 32 bits, the index reversed in the low).
    Transient memory: 16 bytes per element (in-place key arithmetic)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    keys = _f32_order(x).to(torch.int64)
    keys.mul_(1 << 32).add_((1 << 32) - 1 - idx)
    top = torch.topk(keys, k, dim=-1).values
    sel = (1 << 32) - 1 - torch.remainder(top, 1 << 32)
    return x.gather(-1, sel), sel


def _masked(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return scores
    return torch.where(mask[None, :], scores, NEG_INF)


def exact_topk(corpus: torch.Tensor, queries: torch.Tensor,
               mask: Optional[torch.Tensor], k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k: one fp32 matmul + top-k. (scores f32, rows i32)."""
    q = queries.to(corpus.dtype).to(torch.float32)
    scores = _masked(q @ corpus.to(torch.float32).T, mask)
    top_s, top_i = topk_first(scores, k)
    return top_s, top_i.to(torch.int32)


def sort_candidates_by_row(cand: torch.Tensor) -> torch.Tensor:
    """Sort (B, KC) candidate rows ascending, -1 pads last. The rescore's
    top-k then breaks ties by the lowest row, like a full-matrix top-k."""
    c = torch.where(cand < 0, _BIG_ROW, cand.to(torch.int32))
    c = torch.sort(c, dim=1).values
    return torch.where(c >= _BIG_ROW, -1, c)


def _bf16_select(scores_raw: torch.Tensor, mask: Optional[torch.Tensor], k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's "bf16" `select_topk`: selection over the raw accumulator rounded
    to bf16 (values returned in f32); masked slots <= SELECT_NEG / 2."""
    s = scores_raw.to(torch.bfloat16).to(torch.float32)
    if mask is not None:
        s = torch.where(mask[None, :], s, SELECT_NEG)
    top_s, top_i = topk_first(s, k)
    return top_s, top_i.to(torch.int32)


def quantize_queries(queries: torch.Tensor, scale: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the per-dim dequant scale into the queries and quantize them
    symmetrically to int8: (qi (B, D) int8, per-query scale sq (B, 1))."""
    qs = queries * scale[None, :]
    qmax = qs.abs().max(dim=1, keepdim=True).values + 1e-12
    sq = qmax * INV_127  # XLA's rewrite of qmax / 127 under jit
    qi = torch.round(qs / sq).clamp(-127, 127).to(torch.int8)
    return qi, sq


def blockmax_select(codes: torch.Tensor, qi: torch.Tensor,
                    mask: Optional[torch.Tensor], k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates from the per-tile top-2 kernel, then top-k over the
    (B, 2*NT) tile winners by position. Corpora that are not a whole number
    (>= 2) of 512-row tiles take the monolithic bf16 selection, as in the
    JAX package; its ties go to the lowest row here, where the JAX
    package's `approx_max_k` over bf16 orders them otherwise. Returns (raw
    scores f32, rows i32; empty slots NEG_INF, -1)."""
    n = codes.shape[0]
    if n % ck.BLOCKMAX_TILE != 0 or n // ck.BLOCKMAX_TILE < 2:
        raw = qi.to(torch.float32) @ codes.to(torch.float32).T  # exact integers
        raw_s, top_i = _bf16_select(raw, mask, k)
        valid = raw_s > SELECT_NEG / 2
        return torch.where(valid, raw_s, NEG_INF), torch.where(valid, top_i, -1)
    tile_s, tile_rows = ck.blockmax2(codes, qi, mask)
    nt2 = tile_s.shape[1]
    s = torch.where(tile_rows >= 0, tile_s, NEG_INF)
    kk = min(k, nt2)
    top_s, sel = topk_first(s, kk)
    top_i = tile_rows.gather(1, sel)
    if kk < k:
        top_s = torch.nn.functional.pad(top_s, (0, k - kk), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, k - kk), value=-1)
    top_i = torch.where(top_s > NEG_INF / 2, top_i, -1)
    return top_s, top_i


def stage1_route(k: int) -> str:
    """How a fused stage 1 selects k candidates: "scan" (the scan -> top-k
    kernel, whose lists hold k <= INT8_SCAN_TOPK_MAX_K) or "product" (the
    exact (B, N) product a block of queries at a time, then the top-k)."""
    return "scan" if k <= ck.INT8_SCAN_TOPK_MAX_K else "product"


def product_query_block(n: int, b: int, budget: int) -> int:
    """Queries per step of the exact-product route over n rows: as many of
    the b as fit `budget` bytes at SCORE_BYTES_PER_CELL per (query, row)
    cell, at least 1."""
    return max(1, min(b, budget // max(1, n * SCORE_BYTES_PER_CELL)))


def route_budget(device: torch.device) -> int:
    """Bytes the exact-product route may hold on `device`, measured when the
    route runs: on a card, its free memory plus what PyTorch's allocator
    holds unused, less ROUTE_SLACK_BYTES for fragmentation and the outputs;
    elsewhere (test-size runs on the CPU) CPU_ROUTE_BYTES."""
    if device.type != "cuda":
        return CPU_ROUTE_BYTES
    free, _total = torch.cuda.mem_get_info(device)
    unused = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return max(0, free + unused - ROUTE_SLACK_BYTES)


def _product_topk(scores, q: torch.Tensor, mask: Optional[torch.Tensor], n: int, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact-product route: `scores(q block)` -> (b, N) exact int32
    scores, a block of queries at a time within `route_budget`, then the
    top-k over unique int64 keys (score in the high 32 bits, the row
    reversed in the low: score descending, row ascending). Masked rows and
    slots past N are empty: (-3e38, -1), as the scan kernel returns them."""
    step = product_query_block(n, q.shape[0], route_budget(q.device))
    low = (1 << 32) - 1 - torch.arange(n, device=q.device, dtype=torch.int64)
    dead = None if mask is None else ~mask.bool()[None, :]
    kk = min(k, n)
    outs_s, outs_r = [], []
    for q0 in range(0, max(q.shape[0], 1), step):
        keys = torch.add(low, scores(q[q0:q0 + step]), alpha=1 << 32)  # one int64 pass
        if dead is not None:
            keys.masked_fill_(dead, torch.iinfo(torch.int64).min)
        top = torch.topk(keys, kk, dim=1).values
        empty = top == torch.iinfo(torch.int64).min
        outs_s.append(torch.where(empty, ck.NEG, (top >> 32).to(torch.float32)))
        outs_r.append(torch.where(empty, -1, (1 << 32) - 1 - (top & 0xFFFFFFFF)).to(torch.int32))
    top_s, top_i = torch.cat(outs_s), torch.cat(outs_r)
    if kk < k:
        top_s = torch.nn.functional.pad(top_s, (0, k - kk), value=ck.NEG)
        top_i = torch.nn.functional.pad(top_i, (0, k - kk), value=-1)
    return top_s, top_i


def scan_select(codes: torch.Tensor, qi: torch.Tensor, mask: Optional[torch.Tensor],
                k: int, select: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 candidate selection over int8 codes under `select`; returns
    raw integer scores (f32) and rows, empty slots <= NEG_INF / 2 with -1."""
    if select == "blockmax":
        return blockmax_select(codes, qi, mask, k)
    if select not in FUSED_SELECTS:
        raise ValueError(f"unknown stage-1 select policy: {select!r}")
    if stage1_route(k) == "scan":
        return ck.int8_scan_topk(codes, qi, mask, k)
    return _product_topk(lambda qb: ck.int8_scores(codes, qb), qi, mask, codes.shape[0], k)


def hamming_scan_topk(codes: torch.Tensor, qcodes: torch.Tensor,
                      mask: Optional[torch.Tensor], k: int, select: str = ""
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary Hamming scan over (N, W) packed sign words: scores are
    (D - 2 * hamming) / D with D = 32 W, the cosine of the sign vectors, so
    stage-1 scores share the rescore's scale. Empty slots NEG_INF, -1.
    `select` is accepted and ignored (see module doc)."""
    top = codes.shape[1] * 32
    inv_dim = float(torch.tensor(1.0 / top, dtype=torch.float32))
    if stage1_route(k) == "scan":
        raw_s, top_i = ck.hamming_scan_topk(codes, qcodes, mask, k)
    else:  # raw = 32 W - 2 * hamming, in place on the distances
        raw_s, top_i = _product_topk(lambda qb: ck.hamming_scores(codes, qb).mul_(-2).add_(top),
                                     qcodes, mask, codes.shape[0], k)
    valid = raw_s > NEG_INF / 2
    top_s = torch.where(valid, raw_s * inv_dim, NEG_INF)  # XLA's reciprocal rewrite of / D
    return top_s, top_i


def int8_scan_topk(codes: torch.Tensor, queries: torch.Tensor, scale: torch.Tensor,
                   offset: torch.Tensor, mask: Optional[torch.Tensor], k: int,
                   select: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric int8 scan: score(q, c) = sum_d (q_d s_d) c_d + q . o.
    Selection runs on the raw accumulator (order-invariant: sq > 0), then
    the affine dequant gives the candidates' approximate scores."""
    qi, sq = quantize_queries(queries, scale)
    raw_s, top_i = scan_select(codes, qi, mask, k, select)
    const = queries @ offset  # (B,)
    valid = raw_s > NEG_INF / 2
    top_s = torch.where(valid, raw_s * sq + const[:, None], NEG_INF)
    return top_s, top_i.to(torch.int32)


def two_stage_topk(corpus: torch.Tensor, queries: torch.Tensor,
                   mask: Optional[torch.Tensor], k: int, k_candidates: int, stage1: str,
                   binary_codes: Optional[torch.Tensor] = None,
                   qbinary: Optional[torch.Tensor] = None,
                   int8_codes: Optional[torch.Tensor] = None,
                   int8_scale: Optional[torch.Tensor] = None,
                   int8_offset: Optional[torch.Tensor] = None, select: str = ""
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 scan ("hamming" over sign words, or "int8") -> row-sorted
    candidates -> rescore -> top-k.

    The rescore is fp32 against the stored vectors, or (fp32-free mode, an
    empty `corpus`) against the dequantized int8 codes."""
    if stage1 == "hamming":
        s1, cand = hamming_scan_topk(binary_codes, qbinary, mask, k_candidates, select)
    elif stage1 == "int8":
        s1, cand = int8_scan_topk(int8_codes, queries, int8_scale, int8_offset, mask,
                                  k_candidates, select)
    else:
        raise ValueError(f"unknown stage1: {stage1}")
    cand = torch.where(s1 > NEG_INF / 2, cand, -1)
    cand = sort_candidates_by_row(cand)
    safe = cand.clamp_min(0).long()
    if corpus.shape[0] > 0:
        cand_vecs = corpus[safe].to(torch.float32)  # (B, kc, D)
    else:
        cand_i8 = int8_codes[safe].to(torch.float32)
        cand_vecs = cand_i8 * int8_scale[None, None, :] + int8_offset[None, None, :]
    rescored = torch.einsum("bd,bkd->bk", queries, cand_vecs)
    rescored = torch.where(cand >= 0, rescored, NEG_INF)
    top_s, local_i = topk_first(rescored, k)
    return top_s, cand.gather(1, local_i).to(torch.int32)
