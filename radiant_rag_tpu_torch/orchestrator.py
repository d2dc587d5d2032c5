"""RAGOrchestrator: the retrieval wiring of the multi-agent pipeline.

The port's counterpart of `radiant_rag_tpu/orchestrator.py`, as far as the
serving entry point reaches it: the fused `HybridSearcher` over the store's
engine and the BM25 index at the configured candidate-pool depth, and the
lazy fusion calibration that `fusion_weighting: auto` serves. The agentic
control loop (`run`, the agents, the LLM client, conversations) and the
metrics exporter come with ROADMAP queue A item 11; until then `run` raises.

Unlike the JAX package, a failure inside calibration raises: the JAX method
logs it and serves equal weights, which would hide a broken device path
behind another fusion config.
"""

from __future__ import annotations

import logging

from radiant_rag_tpu_torch.config import AppConfig
from radiant_rag_tpu_torch.index.hybrid import HybridSearcher, resolve_fused_depth

logger = logging.getLogger(__name__)

AGENTIC_NOT_PORTED = ("the agentic query pipeline (orchestrator run, agents, LLM client, "
                      "conversations) is not ported yet: ROADMAP queue A item 11")


class RAGOrchestrator:
    def __init__(self, config: AppConfig, store, bm25_index, local_models) -> None:
        self.config = config
        self.store = store
        self.local_models = local_models
        # the fused device retrieval path, over the store's engine; a store
        # without one (the numpy backend) has none
        self._hybrid = None
        if hasattr(store, "engine") and hasattr(bm25_index, "index"):
            self._hybrid = HybridSearcher(store.engine, bm25_index._index)
            # every search_rows through this searcher (serving, warmup,
            # calibration) fuses at retrieval.fused_depth (-1: 4 x fused_top_k)
            self._hybrid.default_fused_depth = resolve_fused_depth(config.retrieval)

    def run(self, query: str, conversation_id: str = "", **kwargs):
        raise NotImplementedError(AGENTIC_NOT_PORTED)

    def invalidate_fusion_calibration(self) -> None:
        """Re-calibrate the leg weights on the next query. Call after
        anything that changes a leg's quality out of band of corpus growth
        (an embedder hot-swap, a BM25 analyzer change)."""
        if self._hybrid is not None:
            self._hybrid.invalidate_calibration()

    def _ensure_fusion_calibration(self) -> None:
        """Calibrate the per-leg fusion against the live corpus when it is
        due (never yet, or after > 20% growth; `calibrate_fusion`). Skipped
        under fusion_weighting 'equal'."""
        hy = self._hybrid
        if hy is None or not hy.needs_calibration():
            return
        rcfg = self.config.retrieval
        if rcfg.fusion_weighting == "equal":
            return

        def text_of(row: int):
            doc_id = self.store.id_for_row(row)
            doc = self.store.get_doc(doc_id) if doc_id else None
            return doc.content if doc is not None else None

        hy.calibrate_fusion(self.local_models.embed, text_of, n_probes=rcfg.calibration_probes,
                            paraphrase_fraction=rcfg.calibration_paraphrase_fraction,
                            seeds=rcfg.calibration_seeds)
        logger.info("fusion calibration: %s", hy.last_calibration)

    def get_agent_stats(self) -> list:
        """The agents' stats: none are ported yet."""
        return []


class SimplifiedOrchestrator:
    """Minimal RAG (embed -> retrieve -> numbered context -> LLM); its LLM
    client comes with ROADMAP queue A item 11."""

    def run(self, query: str) -> str:
        raise NotImplementedError(AGENTIC_NOT_PORTED)
