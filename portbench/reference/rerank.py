"""The rerank blend: z(cross-encoder logit) + prior_weight x z(prior score)
over each query's live candidates (population variance, + 1e-9), in
descending order, ties to the earlier slot."""

from __future__ import annotations

import torch

from reference.precision import FULL, Precision, rounded


def blend(logits: torch.Tensor, prior: torch.Tensor, live: torch.Tensor,
          prior_weight: float, prec: Precision = FULL) -> torch.Tensor:
    """(B, K) blended scores, -inf on dead slots."""
    lv = live.float()
    denom = lv.sum(1, keepdim=True).clamp_min(1.0)

    def z(x):
        x = torch.where(live, x, 0.0)
        mean = (x * lv).sum(1, keepdim=True) / denom
        var = (((x - mean) ** 2) * lv).sum(1, keepdim=True) / denom
        return (x - mean) / torch.sqrt(var + 1e-9)

    out = rounded(z(logits) + prior_weight * z(prior), prec.fusion)
    return torch.where(live, out, float("-inf"))
