"""Reciprocal-rank fusion (RRF) and score fusion with dedup top-k.

Counterpart of `radiant_rag_tpu/ops/fusion.py`. Doc identity is the row index
in the index engine; -1 marks padding. Candidate lists are short (tens), so
the O(K^2) pairwise-equality dedup is cheap.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from radiant_rag_tpu_torch.ops.similarity import NEG_INF, topk_first


def _rrf_scores(runs: Sequence[torch.Tensor], cand: torch.Tensor, rrf_k: int,
                run_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-candidate RRF mass: sum over runs of w_r / (rrf_k + rank)."""
    score = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    for ri, ids in enumerate(runs):
        ranks = torch.arange(1, ids.shape[1] + 1, dtype=torch.float32, device=cand.device)
        weights = 1.0 / (rrf_k + ranks)
        match = (cand[:, :, None] == ids[:, None, :]) & (ids[:, None, :] >= 0)
        contrib = (match * weights[None, None, :]).sum(dim=-1)
        if run_weights is not None:
            contrib = contrib * run_weights[:, ri][:, None]
        score = score + contrib
    return score


def _dedup_topk(cand: torch.Tensor, score: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the first occurrence of each row, top-k by score (lowest
    position first among equal scores)."""
    k_total = cand.shape[1]
    eq_prior = cand[:, :, None] == cand[:, None, :]
    idx = torch.arange(k_total, device=cand.device)
    lower = idx[None, :, None] > idx[None, None, :]  # j < i
    is_dup = (eq_prior & lower).any(dim=-1)
    valid = (cand >= 0) & ~is_dup
    score = torch.where(valid, score, NEG_INF)
    top_s, top_i = topk_first(score, k)
    top_rows = cand.gather(1, top_i)
    top_rows = torch.where(top_s > NEG_INF / 2, top_rows, -1)
    return top_s, top_rows.to(torch.int32)


def rrf_fuse(runs: Sequence[torch.Tensor], k: int, rrf_k: int = 60
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equal-weight RRF: score(doc) = sum over runs of 1 / (rrf_k + rank)."""
    cand = torch.cat(list(runs), dim=1)
    return _dedup_topk(cand, _rrf_scores(runs, cand, rrf_k), k)


def weighted_rrf_fuse(runs: Sequence[torch.Tensor], run_weights: torch.Tensor, k: int,
                      rrf_k: int = 60) -> Tuple[torch.Tensor, torch.Tensor]:
    """RRF with per-(query, run) weights (B, n_runs)."""
    cand = torch.cat(list(runs), dim=1)
    return _dedup_topk(cand, _rrf_scores(runs, cand, rrf_k, run_weights), k)


def score_fuse(runs: Sequence[torch.Tensor], run_scores: Sequence[torch.Tensor],
               run_weights: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query z-normalized score interpolation over the union of runs.
    Each run's live scores are z-normalized and shifted so its worst live
    candidate sits at 0.05: a candidate a leg retrieved always outranks one
    it did not, and a run's own order survives any weights."""
    cand = torch.cat(list(runs), dim=1)
    total = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    for ri, (ids, s) in enumerate(zip(runs, run_scores)):
        live = ids >= 0
        cnt = live.sum(dim=1, keepdim=True).clamp_min(1)
        mu = torch.where(live, s, 0.0).sum(dim=1, keepdim=True) / cnt
        var = torch.where(live, (s - mu) ** 2, 0.0).sum(dim=1, keepdim=True) / cnt
        z = (s - mu) * torch.rsqrt(var + 1e-12)
        zmin = torch.where(live, z, torch.inf).min(dim=1, keepdim=True).values
        zmin = torch.where(torch.isfinite(zmin), zmin, 0.0)
        z = torch.where(live, z - zmin + 0.05, 0.0)
        match = (cand[:, :, None] == ids[:, None, :]) & live[:, None, :]
        contrib = (match * z[:, None, :]).sum(dim=-1)
        total = total + run_weights[:, ri][:, None] * contrib
    return _dedup_topk(cand, total, k)


def calibrated_leg_weights(leg_mrrs, floor: float = 0.002, gamma: float = 2.0,
                           gate: float = 0.75, tiebreak: float = 0.005):
    """Measured per-leg quality (self-retrieval MRRs) -> RRF weights (host).

    Weights go as mrr**gamma + floor; a leg below `gate` x the best leg's MRR
    is demoted to `tiebreak` x the best weight, so it can only order docs
    the good leg did not rank."""
    ws = [max(float(m), 0.0) ** gamma + floor for m in leg_mrrs]
    best_m = max(leg_mrrs)
    best_w = max(ws)
    if best_m > 0.0:
        ws = [tiebreak * best_w if m < gate * best_m else w
              for m, w in zip(leg_mrrs, ws)]
    total = sum(ws)
    return [w / total for w in ws]
