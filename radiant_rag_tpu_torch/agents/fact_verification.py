"""Fact verification: extract atomic claims, verify each against context.

Capability parity with reference `agents/fact_verification.py:118-644`
(a plain class there, not a BaseAgent — same here): LLM claim extraction,
per-claim verification with status SUPPORTED/PARTIAL/NOT_SUPPORTED/
CONTRADICTED, an overall score, and an optional LLM-corrected answer the
orchestrator may substitute (`orchestrator.py:651-655`).

The port's copy of `radiant_rag_tpu/agents/fact_verification.py`, unchanged.
"""

from __future__ import annotations

import enum
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from radiant_rag_tpu_torch.agents.base import DocScore

logger = logging.getLogger(__name__)


class ClaimStatus(enum.Enum):
    SUPPORTED = "supported"
    PARTIAL = "partial"
    NOT_SUPPORTED = "not_supported"
    CONTRADICTED = "contradicted"


@dataclass
class VerifiedClaim:
    claim: str
    status: ClaimStatus
    evidence: str = ""
    confidence: float = 0.0


@dataclass
class VerificationReport:
    claims: List[VerifiedClaim] = field(default_factory=list)
    overall_score: float = 1.0
    corrected_answer: str = ""

    @property
    def needs_correction(self) -> bool:
        return any(c.status in (ClaimStatus.NOT_SUPPORTED, ClaimStatus.CONTRADICTED)
                   for c in self.claims)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "overall_score": self.overall_score,
            "corrected": bool(self.corrected_answer),
            "claims": [
                {"claim": c.claim, "status": c.status.value,
                 "evidence": c.evidence[:200], "confidence": c.confidence}
                for c in self.claims
            ],
        }


_STATUS_WEIGHT = {
    ClaimStatus.SUPPORTED: 1.0,
    ClaimStatus.PARTIAL: 0.5,
    ClaimStatus.NOT_SUPPORTED: 0.0,
    ClaimStatus.CONTRADICTED: -0.5,
}


class FactVerificationAgent:
    def __init__(self, llm, max_claims: int = 10, correct_answer: bool = True) -> None:
        self.llm = llm
        self.max_claims = max_claims
        self.correct_answer = correct_answer

    def verify(self, answer: str, docs: List[DocScore], query: str = "") -> VerificationReport:
        claims = self.extract_claims(answer)
        if not claims:
            return VerificationReport()
        context = "\n\n".join(f"[{i}] {d.content[:1500]}" for i, (d, _s) in enumerate(docs[:8], 1))
        verified = self.verify_claims(claims, context)
        score = self.overall_score(verified)
        report = VerificationReport(claims=verified, overall_score=score)
        if self.correct_answer and report.needs_correction:
            report.corrected_answer = self.correct(answer, verified, context, query)
        return report

    def extract_claims(self, answer: str) -> List[str]:
        """Atomic factual claims (reference `fact_verification.py:157-239`)."""
        arr = self.llm.chat_json([{
            "role": "user",
            "content": (
                "Extract the atomic factual claims from this answer — each a "
                "single verifiable statement. Ignore hedges and meta-text. "
                f"Return a JSON array of at most {self.max_claims} strings.\n\n"
                f"Answer:\n{answer}"
            ),
        }], expect=list)
        return [str(c).strip() for c in (arr or []) if str(c).strip()][: self.max_claims]

    def verify_claims(self, claims: List[str], context: str) -> List[VerifiedClaim]:
        """Verify all claims in one LLM call (batched; the reference loops)."""
        numbered = "\n".join(f"{i+1}. {c}" for i, c in enumerate(claims))
        arr = self.llm.chat_json([{
            "role": "user",
            "content": (
                "For each claim, check it against the context. Return a JSON array "
                "(same order) of objects {\"status\": \"supported\"|\"partial\"|"
                "\"not_supported\"|\"contradicted\", \"evidence\": string quote or \"\", "
                "\"confidence\": float 0-1}.\n\n"
                f"Claims:\n{numbered}\n\nContext:\n{context}"
            ),
        }], expect=list)
        out: List[VerifiedClaim] = []
        for i, claim in enumerate(claims):
            item = arr[i] if arr and i < len(arr) and isinstance(arr[i], dict) else {}
            status_s = str(item.get("status", "partial")).lower()
            try:
                status = ClaimStatus(status_s)
            except ValueError:
                status = ClaimStatus.PARTIAL
            try:
                conf = float(item.get("confidence", 0.5))
            except (TypeError, ValueError):
                conf = 0.5
            out.append(VerifiedClaim(claim=claim, status=status,
                                     evidence=str(item.get("evidence", "")),
                                     confidence=max(0.0, min(1.0, conf))))
        return out

    @staticmethod
    def overall_score(claims: List[VerifiedClaim]) -> float:
        """Weighted mean, clipped to [0,1] (reference `:470-498`)."""
        if not claims:
            return 1.0
        raw = sum(_STATUS_WEIGHT[c.status] for c in claims) / len(claims)
        return max(0.0, min(1.0, raw))

    def correct(self, answer: str, claims: List[VerifiedClaim], context: str, query: str) -> str:
        problems = "\n".join(
            f"- {c.claim} [{c.status.value}]"
            for c in claims if c.status in (ClaimStatus.NOT_SUPPORTED, ClaimStatus.CONTRADICTED)
        )
        try:
            return self.llm.chat([{
                "role": "user",
                "content": (
                    "Rewrite the answer removing or fixing the unsupported claims "
                    "below, using ONLY the context. Keep everything that was "
                    "correct.\n\n"
                    f"Question: {query}\n\nAnswer:\n{answer}\n\n"
                    f"Problematic claims:\n{problems}\n\nContext:\n{context}"
                ),
            }]).strip()
        except Exception as exc:
            logger.warning("answer correction failed: %s", exc)
            return ""
