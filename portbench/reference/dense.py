"""The dense leg: a two-stage search over quantised codes, then a rescore.

  int8 ranges  per dimension, the minimum and maximum of the calibration
               rows (a range under 1e-6 widened to 1e-6)
  int8 codes   round((x - lo) / s') - 128, clamped, s' = (hi - lo) * f32(1/255)
  dequant      q * s + o, s = (hi - lo) / 255, o = lo + 128 s
  int8 stage 1 queries scaled by s, quantised symmetrically to int8
               (sq = max |q s| * f32(1/127)); score = the integer product with
               the codes
  binary       sign words (x > 0); score = D - 2 Hamming distance
  selection    the k best scores, ties to the lower row
  rescore      candidates in row order, float32 dot with the stored vectors
               (or with the dequantised codes where no float32 vectors are
               stored); the k best, ties to the lower candidate

Integer scores are exact in float32 products (|score| < 2^24).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from reference.precision import FULL, Precision, tf32_off, tf32

NEG_INF = -1e30
INV_255 = float(torch.tensor(1.0 / 255.0, dtype=torch.float32))
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def int8_ranges(sample: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = sample.min(dim=0).values
    hi = sample.max(dim=0).values
    return lo, torch.where(hi - lo < 1e-6, lo + 1e-6, hi)


def int8_codes(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    q = torch.round((x - lo) / ((hi - lo) * INV_255)) - 128.0
    return q.clamp(-128.0, 127.0).to(torch.int8)


def scale_offset(lo: torch.Tensor, hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s = (hi - lo) / 255.0
    return s, lo + 128.0 * s


def sign_matrix(x: torch.Tensor) -> torch.Tensor:
    """+-1 float32 of x's sign bits (bit set where x > 0)."""
    return torch.where(x > 0, 1.0, -1.0)


def top_rows(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of integer-valued float32 scores, ties to the lower row:
    (scores, rows int64)."""
    n = scores.shape[1]
    low = (1 << 32) - 1 - torch.arange(n, device=scores.device, dtype=torch.int64)
    keys = scores.to(torch.int64) * (1 << 32) + low
    top = torch.topk(keys, min(k, n), dim=1).values
    return (top >> 32).to(torch.float32), (1 << 32) - 1 - (top & 0xFFFFFFFF)


def topk_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest float32 values along the last dim, ties to the lower
    index: a sort of (value, -index) with a stable descending sort."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, order), order


def stage1(codes_f: torch.Tensor, q_f: torch.Tensor, kc: int,
           block: int = 128) -> torch.Tensor:
    """(b, kc) candidate rows of the integer products q_f @ codes_f^T, in
    query blocks; rows sorted ascending."""
    out = []
    with tf32_off():
        for s0 in range(0, q_f.shape[0], block):
            _, rows = top_rows(q_f[s0:s0 + block] @ codes_f.T, kc)
            out.append(torch.sort(rows, dim=1).values)
    return torch.cat(out)


def int8_queries(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    qs = q * s[None, :]
    sq = (qs.abs().max(dim=1, keepdim=True).values + 1e-12) * INV_127
    return torch.round(qs / sq).clamp(-127, 127)


def rescore(q: torch.Tensor, cand: torch.Tensor, vectors: torch.Tensor,
            k: int, prec: Precision = FULL,
            dequant: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best candidates by the dot of q with the stored vectors (or,
    with `dequant` = (codes, s, o), the dequantised codes): (scores, rows)."""
    if dequant is None:
        cv = vectors[cand]
    else:
        codes, s, o = dequant
        cv = codes[cand].to(torch.float32) * s + o
    if prec.rescore == "tf32":
        cv, q = tf32(cv), tf32(q)
    with tf32_off():
        sc = torch.matmul(cv, q[:, :, None])[:, :, 0]
    top_s, pos = topk_first(sc, k)
    return top_s, cand.gather(1, pos)


def dot_scores(q: torch.Tensor, rows: torch.Tensor, vectors: torch.Tensor,
               dequant=None) -> torch.Tensor:
    """The reference's float64 score of each (query, row) pair, -inf where
    row < 0: the judge's measure of a returned row."""
    safe = rows.clamp_min(0)
    if dequant is None:
        cv = vectors[safe].double()
    else:
        codes, s, o = dequant
        cv = codes[safe].double() * s.double() + o.double()
    sc = (cv * q.double()[:, None, :]).sum(-1)
    return torch.where(rows >= 0, sc, float("-inf"))
