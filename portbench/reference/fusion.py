"""Fusion of the two legs, in the mode and with the leg weights that the
calibration (reference/calibration.py) chooses.

  candidates  the dense rows then the BM25 rows, each leg at its full
              depth; a repeat keeps its first place; the k best, ties to
              the earlier place
  confidence  weighted RRF: a row scores the sum over legs of
              w_leg / (rrf_k + rank)
  score       z-score interpolation: each leg's live scores z-normalised
              per query (population variance, + 1e-12) and shifted so the
              leg's worst live row sits at 0.05; a row scores the sum over
              the legs that hold it of w_leg x its shifted z
  equal       RRF with both weights 1
  weights     the calibration's rule for weighted RRF: each leg's
              self-retrieval MRR m -> m^2 + 0.002; a leg under 0.75 of the
              best MRR is cut to 0.005 x the best weight; normalised
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from reference.dense import NEG_INF, topk_first
from reference.precision import FULL, Precision, rounded


def calibrated_weights(mrrs: Sequence[float], floor: float = 0.002, gamma: float = 2.0,
                       gate: float = 0.75, tiebreak: float = 0.005):
    ws = [max(float(m), 0.0) ** gamma + floor for m in mrrs]
    best_m, best_w = max(mrrs), max(ws)
    if best_m > 0.0:
        ws = [tiebreak * best_w if m < gate * best_m else w for m, w in zip(mrrs, ws)]
    total = sum(ws)
    return [w / total for w in ws]


def _leg_mass(mode: str, rows: torch.Tensor, scores: torch.Tensor, rrf_k: int,
              prec: Precision) -> torch.Tensor:
    """(B, depth) what each slot of one leg gives the row it holds, 0 on
    empty slots."""
    live = rows >= 0
    if mode in ("confidence", "equal"):
        ranks = torch.arange(1, rows.shape[1] + 1, dtype=torch.float32, device=rows.device)
        inv = rounded(1.0 / (rrf_k + ranks), prec.fusion)
        return torch.where(live, inv[None, :], 0.0)
    s = scores.to(torch.float32)
    cnt = live.sum(1, keepdim=True).clamp_min(1)
    mu = torch.where(live, s, 0.0).sum(1, keepdim=True) / cnt
    var = torch.where(live, (s - mu) ** 2, 0.0).sum(1, keepdim=True) / cnt
    z = rounded((s - mu) / torch.sqrt(var + 1e-12), prec.fusion)
    zmin = torch.where(live, z, torch.inf).min(1, keepdim=True).values
    zmin = torch.where(torch.isfinite(zmin), zmin, 0.0)
    return torch.where(live, rounded(z - zmin + 0.05, prec.fusion), 0.0)


def fused_scores(mode: str, legs: Sequence[torch.Tensor], leg_scores: Sequence[torch.Tensor],
                 weights: Sequence[float], rrf_k: int, prec: Precision = FULL
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(candidates (B, sum of depths), their fused scores, NEG_INF on
    repeats and empty slots)."""
    if mode not in ("confidence", "score", "equal"):
        raise ValueError(f"fusion mode {mode!r}")
    cand = torch.cat(list(legs), dim=1)
    score = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    for w, rows, s in zip(weights, legs, leg_scores):
        mass = _leg_mass(mode, rows, s, rrf_k, prec)
        match = (cand[:, :, None] == rows[:, None, :]) & (rows[:, None, :] >= 0)
        contrib = rounded((match * mass[:, None, :]).sum(-1), prec.fusion)
        wt = torch.tensor(1.0 if mode == "equal" else w, dtype=torch.float32,
                          device=cand.device)
        score = rounded(score + rounded(contrib * wt, prec.fusion), prec.fusion)
    idx = torch.arange(cand.shape[1], device=cand.device)
    repeat = ((cand[:, :, None] == cand[:, None, :]) & (idx[None, :, None] > idx[None, None, :])
              ).any(-1)
    return cand, torch.where((cand >= 0) & ~repeat, score, NEG_INF)


def fuse(mode: str, legs: Sequence[torch.Tensor], leg_scores: Sequence[torch.Tensor],
         weights: Sequence[float], rrf_k: int, k: int, prec: Precision = FULL
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    cand, score = fused_scores(mode, legs, leg_scores, weights, rrf_k, prec)
    top_s, pos = topk_first(score, k)
    rows = cand.gather(1, pos)
    return top_s, torch.where(top_s > NEG_INF / 2, rows, -1)
