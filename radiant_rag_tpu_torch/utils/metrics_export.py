"""Prometheus + OpenTelemetry metric and trace export.

The port's counterpart of `radiant_rag_tpu/utils/metrics_export.py`:
`PrometheusMetricsExporter` (per-agent execution and error counters, a
duration histogram on latency buckets, a confidence gauge, an active-runs
gauge, and optionally `prometheus_client`'s HTTP endpoint),
`OpenTelemetryExporter` (a span per agent carrying
`AgentMetrics.to_otel_attributes()`, sent to an OTLP endpoint when one is
set), the `UnifiedMetrics` facade over both and the process-wide
`get_metrics_exporter`. The orchestrator builds one when `metrics.
prometheus_enabled` or `metrics.otel_enabled` is set and hands it to
`BaseAgent.metrics_sink`, through which every agent run is recorded: each
runs inside an agent span (`trace_agent`), a failed or degraded run counts
an error (`record_error`), and each `RAGOrchestrator.run` holds the
active-runs gauge (`track_run`). A failure of an exporter never breaks a
run (`guarded`).

One deviation: the JAX exporters log and record nothing when their
library is missing. The port raises `ImportError` naming the package, as
it raises for any setting it cannot honour: a configuration that asks for
metrics gets them or an error. Both packages register their metrics in
`prometheus_client`'s default registry, which refuses a second exporter
of the same namespace in one process (a `ValueError`, raised as there).
"""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from typing import Any, Callable, ContextManager, Iterator, Optional

logger = logging.getLogger(__name__)

_LATENCY_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _missing(package: str, what: str, exc: ImportError) -> ImportError:
    return ImportError(f"{what} needs the {package} package, which is not installed ({exc}); "
                       "install it or turn the setting off")


class PrometheusMetricsExporter:
    """Agent metrics in `prometheus_client`'s default registry; `port`
    starts its HTTP endpoint (0: none)."""

    def __init__(self, port: int = 0, namespace: str = "radiant_tpu") -> None:
        try:
            from prometheus_client import Counter, Gauge, Histogram, start_http_server
        except ImportError as exc:
            raise _missing("prometheus_client", "metrics.prometheus_enabled", exc) from exc
        self._executions = Counter(
            f"{namespace}_agent_executions_total", "Agent executions", ["agent"])
        self._errors = Counter(
            f"{namespace}_agent_errors_total", "Agent errors", ["agent"])
        self._duration = Histogram(
            f"{namespace}_agent_duration_seconds", "Agent duration", ["agent"],
            buckets=_LATENCY_BUCKETS)
        self._confidence = Gauge(
            f"{namespace}_agent_confidence", "Last confidence", ["agent"])
        self._active = Gauge(
            f"{namespace}_active_runs", "Active pipeline runs")
        if port:
            start_http_server(port)

    def record_agent(self, metrics) -> None:
        labels = metrics.to_prometheus_labels()
        self._executions.labels(**labels).inc()
        self._duration.labels(**labels).observe(metrics.duration_ms / 1000.0)
        if metrics.confidence is not None:
            self._confidence.labels(**labels).set(metrics.confidence)

    def record_error(self, agent_name: str) -> None:
        self._errors.labels(agent=agent_name).inc()

    @contextmanager
    def track_run(self) -> Iterator[None]:
        self._active.inc()
        try:
            yield
        finally:
            self._active.dec()


class OpenTelemetryExporter:
    """A span per agent through the OpenTelemetry SDK; `endpoint` adds an
    OTLP (gRPC) span exporter."""

    def __init__(self, endpoint: str = "", service_name: str = "radiant-tpu") -> None:
        try:
            from opentelemetry import trace
            from opentelemetry.sdk.resources import Resource
            from opentelemetry.sdk.trace import TracerProvider
            from opentelemetry.sdk.trace.export import BatchSpanProcessor
        except ImportError as exc:
            raise _missing("opentelemetry-sdk", "metrics.otel_enabled", exc) from exc
        provider = TracerProvider(resource=Resource.create({"service.name": service_name}))
        if endpoint:
            try:
                from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
                    OTLPSpanExporter,
                )
            except ImportError as exc:
                raise _missing("opentelemetry-exporter-otlp", "metrics.otel_endpoint",
                               exc) from exc
            provider.add_span_processor(BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint)))
        trace.set_tracer_provider(provider)
        self._tracer = trace.get_tracer(service_name)

    @contextmanager
    def trace_agent(self, agent_name: str, metrics=None) -> Iterator[Any]:
        with self._tracer.start_as_current_span(f"agent.{agent_name}") as span:
            try:
                yield span
            finally:
                if metrics is not None:
                    for k, v in metrics.to_otel_attributes().items():
                        span.set_attribute(k, v)


class UnifiedMetrics:
    """Facade over both exporters."""

    def __init__(self, prometheus: Optional[PrometheusMetricsExporter] = None,
                 otel: Optional[OpenTelemetryExporter] = None) -> None:
        self.prometheus = prometheus
        self.otel = otel

    @classmethod
    def create(cls, prometheus_enabled: bool = False, prometheus_port: int = 0,
               otel_enabled: bool = False, otel_endpoint: str = "") -> "UnifiedMetrics":
        return cls(
            prometheus=PrometheusMetricsExporter(prometheus_port) if prometheus_enabled else None,
            otel=OpenTelemetryExporter(otel_endpoint) if otel_enabled else None,
        )

    def record_agent(self, metrics) -> None:
        if self.prometheus is not None:
            self.prometheus.record_agent(metrics)

    def record_error(self, agent_name: str) -> None:
        if self.prometheus is not None:
            self.prometheus.record_error(agent_name)

    @contextmanager
    def track_run(self) -> Iterator[None]:
        if self.prometheus is not None:
            with self.prometheus.track_run():
                yield
        else:
            yield

    @contextmanager
    def trace_agent(self, agent_name: str, metrics=None) -> Iterator[Any]:
        if self.otel is not None:
            with self.otel.trace_agent(agent_name, metrics) as span:
                yield span
        else:
            yield None


@contextmanager
def guarded(open_: Optional[Callable[[], ContextManager]]) -> Iterator[None]:
    """Run the body inside the exporter's context `open_()` (None: none).
    A failure of the exporter on entry or exit is logged and dropped; one
    of the body is raised as it is."""
    if open_ is None:
        yield
        return
    try:
        cm = open_()
        cm.__enter__()
    except Exception:  # export must never break the pipeline
        logger.warning("metrics export failed on entry", exc_info=True)
        yield
        return
    try:
        yield
    except BaseException as exc:
        try:
            cm.__exit__(type(exc), exc, exc.__traceback__)
        except Exception as exit_exc:  # the body's own exception is re-raised below
            if exit_exc is not exc:
                logger.warning("metrics export failed on exit", exc_info=True)
        raise
    try:
        cm.__exit__(None, None, None)
    except Exception:
        logger.warning("metrics export failed on exit", exc_info=True)


_global: Optional[UnifiedMetrics] = None
_lock = threading.Lock()


def get_metrics_exporter(**kwargs: Any) -> UnifiedMetrics:
    """The process-wide exporter, built by the first call's arguments."""
    global _global
    with _lock:
        if _global is None:
            _global = UnifiedMetrics.create(**kwargs)
        return _global
