"""Per-run step metrics and history collection.

The port's copy of `radiant_rag_tpu/utils/metrics.py`, unchanged.
Capability parity with reference `radiant/utils/metrics.py`: `StepMetric`
(`metrics.py:18-51`), `RunMetrics.track_step` context manager auto-capturing
timing + exceptions (`metrics.py:108-126`), degraded-feature marking
(`metrics.py:133-136`), and a history `MetricsCollector` with per-step stats
(`metrics.py:221-288`).
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class StepMetric:
    name: str
    started: float = 0.0
    ended: float = 0.0
    ok: bool = True
    error: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return max(0.0, (self.ended - self.started) * 1000.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "duration_ms": self.duration_ms,
            "ok": self.ok,
            "error": self.error,
            "extra": dict(self.extra),
        }


class RunMetrics:
    """Collects step timings and degradations for one pipeline run."""

    def __init__(self, run_id: str = "") -> None:
        self.run_id = run_id
        self.started = time.time()
        self.steps: List[StepMetric] = []
        self.degraded: Dict[str, str] = {}
        # optional live observer: called (event, step_name, info) at phase
        # boundaries — the hook behind streaming progress (server /query/stream)
        self.observer: Any = None

    def _notify(self, event: str, name: str, info: Dict[str, Any]) -> None:
        if self.observer is None:
            return
        try:
            self.observer(event, name, info)
        except Exception:  # observers must never break the pipeline
            logger.debug("metrics observer failed", exc_info=True)

    @contextmanager
    def track_step(self, name: str, **extra: Any) -> Iterator[StepMetric]:
        """Context manager recording duration and any exception for `name`
        (reference `metrics.py:108-126`). Exceptions propagate."""
        step = StepMetric(name=name, started=time.time(), extra=dict(extra))
        self.steps.append(step)
        self._notify("step_start", name, dict(extra))
        try:
            yield step
        except Exception as exc:
            step.ok = False
            step.error = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            step.ended = time.time()
            self._notify("step_end", name, {
                "ok": step.ok, "error": step.error,
                "duration_ms": (step.ended - step.started) * 1000.0})

    def mark_degraded(self, feature: str, reason: str) -> None:
        """Record that a feature ran degraded (reference `metrics.py:133-136`)."""
        self.degraded[feature] = reason

    @property
    def total_duration_ms(self) -> float:
        return (time.time() - self.started) * 1000.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "run_id": self.run_id,
            "total_duration_ms": self.total_duration_ms,
            "steps": [s.to_dict() for s in self.steps],
            "degraded": dict(self.degraded),
        }


class MetricsCollector:
    """Keeps a bounded history of runs with per-step min/avg/max stats
    (reference `metrics.py:221-288`)."""

    def __init__(self, max_history: int = 100) -> None:
        self.max_history = max_history
        self.history: List[RunMetrics] = []

    def record(self, run: RunMetrics) -> None:
        self.history.append(run)
        if len(self.history) > self.max_history:
            self.history = self.history[-self.max_history :]

    def step_stats(self) -> Dict[str, Dict[str, float]]:
        agg: Dict[str, List[float]] = {}
        for run in self.history:
            for s in run.steps:
                agg.setdefault(s.name, []).append(s.duration_ms)
        return {
            name: {
                "count": float(len(v)),
                "min_ms": min(v),
                "avg_ms": sum(v) / len(v),
                "max_ms": max(v),
            }
            for name, v in agg.items()
        }

    def summary(self) -> Dict[str, Any]:
        return {
            "runs": len(self.history),
            "steps": self.step_stats(),
            "degraded_total": sum(len(r.degraded) for r in self.history),
        }
