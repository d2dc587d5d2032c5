"""Agent lifecycle framework.

Capability parity with reference `agents/base_agent.py`: `BaseAgent.run()`
wraps `_execute` with enabled-check, correlation id, metrics capture, hook
calls, and exception->fallback handling producing `AgentResult` with status
SUCCESS/PARTIAL/FAILED/SKIPPED (`base_agent.py:468-584`); `execute()` unwraps
or raises (`:438-466`); per-agent cumulative stats (`:610-645`); `LLMAgent`
and `RetrievalAgent` convenience bases (`:667-836`); Prometheus/OTel attribute
shims (`:109-141`).

The port's copy of `radiant_rag_tpu/agents/base_agent.py`, with one
change: a failure on the card is not degraded. Agents run their device
calls inside `DeviceStages` (under the device lock that the server's
searches share), which raises any failure there as a `DeviceStageError`;
`BaseAgent.run` re-raises it instead of calling `_on_error`, so it reaches
the caller of `RAGOrchestrator.run`. Every other failure (an `LLMError`,
JSON that does not parse) degrades exactly as in the JAX package.
`metrics_sink` is the exporter the orchestrator builds under `metrics.*`
(`utils/metrics_export.py`). The port exports every run the agent
executes, inside an agent span: a failed, degraded or raised run counts
an error as well as its metrics (the JAX package records successful and
degraded runs only, outside any span).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from radiant_rag_tpu_torch.agents.base import AgentContext
from radiant_rag_tpu_torch.utils.logging import StructuredLogger
from radiant_rag_tpu_torch.utils.metrics_export import guarded

logger = logging.getLogger(__name__)


class AgentStatus(enum.Enum):
    SUCCESS = "success"
    PARTIAL = "partial"
    FAILED = "failed"
    SKIPPED = "skipped"
    TIMEOUT = "timeout"


class AgentCategory(enum.Enum):
    PLANNING = "planning"
    QUERY_PROCESSING = "query_processing"
    RETRIEVAL = "retrieval"
    POST_RETRIEVAL = "post_retrieval"
    GENERATION = "generation"
    EVALUATION = "evaluation"
    VERIFICATION = "verification"
    UTILITY = "utility"


@dataclass
class AgentMetrics:
    agent_name: str = ""
    started: float = 0.0
    ended: float = 0.0
    llm_calls: int = 0
    retrieval_calls: int = 0
    confidence: Optional[float] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return max(0.0, (self.ended - self.started) * 1000.0)

    def to_prometheus_labels(self) -> Dict[str, str]:
        return {"agent": self.agent_name}

    def to_otel_attributes(self) -> Dict[str, Any]:
        return {
            "agent.name": self.agent_name,
            "agent.duration_ms": self.duration_ms,
            "agent.llm_calls": self.llm_calls,
            "agent.retrieval_calls": self.retrieval_calls,
            "agent.confidence": self.confidence if self.confidence is not None else -1.0,
        }


@dataclass
class AgentResult:
    data: Any
    success: bool
    status: AgentStatus
    error: str = ""
    warnings: List[str] = field(default_factory=list)
    metrics: AgentMetrics = field(default_factory=AgentMetrics)


class AgentError(Exception):
    pass


class DeviceStageError(RuntimeError):
    """A failure inside a device stage (an embed, a store or BM25 search, a
    cross-encoder rerank). Raised through `BaseAgent.run`, never degraded."""


class DeviceStages:
    """Runs the pipeline's device stages one at a time: each under `lock`
    (the lock the server's search batches and /health take), each failure
    raised as a `DeviceStageError` naming its stage. A stage holds the lock
    only for its own device work, never across an LLM call."""

    def __init__(self, lock=None) -> None:
        self.lock = lock if lock is not None else threading.RLock()

    @contextmanager
    def __call__(self, stage: str) -> Iterator[None]:
        with self.lock:
            try:
                yield
            except DeviceStageError:
                raise
            except Exception as exc:
                raise DeviceStageError(f"{stage}: {type(exc).__name__}: {exc}") from exc


class BaseAgent:
    """Subclasses set `name`, `category`, and implement `_execute`."""

    name: str = "base"
    category: AgentCategory = AgentCategory.UTILITY
    # Optional process-wide exporter sink (UnifiedMetrics); set by the
    # orchestrator when Prometheus/OTel export is configured. Every run()
    # reports its AgentMetrics through it (reference exports per-agent
    # executions/duration/confidence, `utils/metrics_export.py:95-201`).
    metrics_sink = None

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.log = StructuredLogger(f"agents.{self.name}")
        self._runs = 0
        self._failures = 0
        self._total_ms = 0.0

    # -- hooks (override as needed) ----------------------------------------
    def _before_execute(self, ctx: AgentContext, **kwargs: Any) -> None:
        pass

    def _execute(self, ctx: AgentContext, **kwargs: Any) -> Any:
        raise NotImplementedError

    def _after_execute(self, ctx: AgentContext, result: Any, **kwargs: Any) -> Any:
        return result

    def _on_error(self, ctx: AgentContext, exc: Exception, **kwargs: Any) -> Any:
        """Return a fallback value, or re-raise to mark FAILED."""
        raise exc

    # -- lifecycle ---------------------------------------------------------
    def run(self, ctx: AgentContext, **kwargs: Any) -> AgentResult:
        metrics = AgentMetrics(agent_name=self.name, started=time.time())
        self.log.correlation_id = ctx.run_id
        if not self.enabled:
            metrics.ended = time.time()
            return AgentResult(data=None, success=True, status=AgentStatus.SKIPPED,
                               metrics=metrics)
        sink = BaseAgent.metrics_sink
        with guarded(None if sink is None else lambda: sink.trace_agent(self.name, metrics)):
            try:
                result = self._run_enabled(ctx, metrics, **kwargs)
            except DeviceStageError:
                self._export(sink, metrics, failed=True)
                raise
            self._export(sink, metrics, failed=bool(result.error))
        return result

    def _run_enabled(self, ctx: AgentContext, metrics: AgentMetrics,
                     **kwargs: Any) -> AgentResult:
        self._runs += 1
        warnings: List[str] = []
        try:
            self._before_execute(ctx, **kwargs)
            data = self._execute(ctx, **kwargs)
            data = self._after_execute(ctx, data, **kwargs)
            status, success, error = AgentStatus.SUCCESS, True, ""
        except DeviceStageError:
            self._failures += 1  # a failure on the card: raised, never degraded
            metrics.ended = time.time()
            self._total_ms += metrics.duration_ms
            raise
        except Exception as exc:
            self.log.warning("%s failed: %s: %s", self.name, type(exc).__name__, exc)
            try:
                data = self._on_error(ctx, exc, **kwargs)
                status, success = AgentStatus.PARTIAL, True
                error = f"{type(exc).__name__}: {exc}"
                warnings.append(f"{self.name} degraded: {error}")
                self._failures += 1
            except Exception as exc2:
                self._failures += 1
                metrics.ended = time.time()
                self._total_ms += metrics.duration_ms
                return AgentResult(
                    data=None, success=False, status=AgentStatus.FAILED,
                    error=f"{type(exc2).__name__}: {exc2}", metrics=metrics,
                )
        metrics.ended = time.time()
        self._total_ms += metrics.duration_ms
        return AgentResult(data=data, success=success, status=status, error=error,
                           warnings=warnings, metrics=metrics)

    def _export(self, sink, metrics: AgentMetrics, failed: bool) -> None:
        """A finished run to the exporter: an error if it failed or
        degraded, then its metrics, as any run's."""
        if sink is None:
            return
        try:
            if failed:
                sink.record_error(self.name)
            sink.record_agent(metrics)
        except Exception:  # export must never break the pipeline
            pass

    def execute(self, ctx: AgentContext, **kwargs: Any) -> Any:
        """Run and unwrap, raising on failure (reference `base_agent.py:438`)."""
        result = self.run(ctx, **kwargs)
        if not result.success:
            raise AgentError(f"{self.name}: {result.error}")
        return result.data

    def get_stats(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "runs": self._runs,
            "failures": self._failures,
            "total_ms": self._total_ms,
            "avg_ms": self._total_ms / self._runs if self._runs else 0.0,
        }


class LLMAgent(BaseAgent):
    """Agent requiring an LLM client (reference `base_agent.py:667-760`)."""

    def __init__(self, llm, enabled: bool = True) -> None:
        super().__init__(enabled=enabled)
        if llm is None:
            raise ValueError(f"{self.name} requires an LLM client")
        self.llm = llm

    def _chat(self, messages: Sequence[Dict[str, str]], **kwargs: Any) -> str:
        return self.llm.chat(messages, **kwargs)

    def _chat_json(self, messages: Sequence[Dict[str, str]], **kwargs: Any):
        return self.llm.chat_json(messages, **kwargs)


class RetrievalAgent(BaseAgent):
    """Agent requiring a store + local models (reference `base_agent.py:763-836`)."""

    def __init__(self, store, local_models, enabled: bool = True,
                 device_stages: Optional[DeviceStages] = None) -> None:
        super().__init__(enabled=enabled)
        if store is None or local_models is None:
            raise ValueError(f"{self.name} requires store and local models")
        self.store = store
        self.local_models = local_models
        self.device_stage = device_stages or DeviceStages()

    def _embed(self, text: str) -> np.ndarray:
        return self.local_models.embed_single(text)

    def _embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        return self.local_models.embed(texts)

    def _retrieve(self, embedding: np.ndarray, **kwargs: Any):
        return self.store.retrieve_by_embedding(embedding, **kwargs)
