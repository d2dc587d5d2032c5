"""The port's observability layer against the JAX package's (CPU): the
Prometheus and OpenTelemetry exporters, their wiring through the
orchestrator and `BaseAgent.metrics_sink`, and the profiling helpers.

Prometheus: both packages' exporters record the same samples for the same
agent metrics and the same pipeline run (read back with
`prometheus_client.REGISTRY.get_sample_value`). The default registry
refuses a second registration of a metric name in one process, and a test
file may share its worker with tests/test_utils.py (namespace
`radiant_test`), so every exporter here takes a namespace of its own and
unregisters its metrics afterwards. OpenTelemetry: without the SDK the
port raises `ImportError` naming the package where the JAX exporter
records nothing (checked where the SDK is missing); with a stand-in SDK
installed both record the same spans. Profiling mirrors tests/test_utils.py: the
`torch.profiler` trace holds the annotations and the operators under their
names, `device_timer` copies the first output to the host before the clock
stops, and a profiler that fails to start raises.
"""

import itertools
import json
import sys
import types
from contextlib import contextmanager

import pytest
import torch

from radiant_rag_tpu.agents.base_agent import AgentMetrics as JaxAgentMetrics
from radiant_rag_tpu.agents.base_agent import BaseAgent as JaxBaseAgent
from radiant_rag_tpu.utils import metrics_export as jexp
from radiant_rag_tpu.utils import profiling as jprof
from radiant_rag_tpu_torch.agents.base_agent import AgentMetrics, BaseAgent
from radiant_rag_tpu_torch.utils import metrics_export as texp
from radiant_rag_tpu_torch.utils import profiling as tprof

prometheus_client = pytest.importorskip("prometheus_client")
REGISTRY = prometheus_client.REGISTRY
_NAMES = itertools.count()
SERIES = ("agent_executions_total", "agent_errors_total", "agent_duration_seconds_count",
          "agent_duration_seconds_sum", "agent_confidence")


@pytest.fixture
def exporters():
    """A function making (JAX, port) Prometheus exporters of fresh
    namespaces; their metrics are unregistered afterwards."""
    made = []

    def make():
        n = next(_NAMES)
        pair = (jexp.PrometheusMetricsExporter(port=0, namespace=f"radiant_obs_j{n}"),
                texp.PrometheusMetricsExporter(port=0, namespace=f"radiant_obs_t{n}"))
        made.extend(pair)
        return pair, (f"radiant_obs_j{n}", f"radiant_obs_t{n}")

    yield make
    for exp in made:
        unregister(exp)


def unregister(exp):
    for attr in ("_executions", "_errors", "_duration", "_confidence", "_active"):
        if hasattr(exp, attr):
            REGISTRY.unregister(getattr(exp, attr))


def samples(namespace, agent):
    out = {s: REGISTRY.get_sample_value(f"{namespace}_{s}", {"agent": agent}) for s in SERIES}
    out["active_runs"] = REGISTRY.get_sample_value(f"{namespace}_active_runs")
    return out


def test_prometheus_exporter_records_as_jax(exporters):
    (jx, tx), (jn, tn) = exporters()
    for exp, cls in ((jx, JaxAgentMetrics), (tx, AgentMetrics)):
        exp.record_agent(cls(agent_name="probe", started=0.0, ended=0.1, confidence=0.8))
        exp.record_agent(cls(agent_name="probe", started=1.0, ended=1.25))
        exp.record_error("probe")
        with exp.track_run():
            inside = REGISTRY.get_sample_value(
                f"{jn if exp is jx else tn}_active_runs")
        assert inside == 1.0
    got, ref = samples(tn, "probe"), samples(jn, "probe")
    assert got == ref
    assert (got["agent_executions_total"], got["agent_errors_total"], got["agent_confidence"],
            got["active_runs"]) == (2.0, 1.0, 0.8, 0.0)
    assert got["agent_duration_seconds_sum"] == pytest.approx(0.35)


def test_a_second_registration_raises_in_both(exporters):
    (jx, tx), (jn, tn) = exporters()
    for mod, ns in ((jexp, jn), (texp, tn)):
        with pytest.raises(ValueError, match="Duplicated"):
            mod.PrometheusMetricsExporter(port=0, namespace=ns)


def test_missing_prometheus_client_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "prometheus_client", None)
    with pytest.raises(ImportError, match="prometheus_enabled.*prometheus_client"):
        texp.PrometheusMetricsExporter(port=0, namespace="radiant_obs_missing")
    assert jexp.PrometheusMetricsExporter(port=0, namespace="radiant_obs_missing").enabled is False


def test_otel_without_the_sdk_raises_naming_it():
    try:
        import opentelemetry.sdk  # noqa: F401
    except ImportError:
        pass
    else:  # pragma: no cover - a machine with the SDK
        pytest.skip("the OpenTelemetry SDK is installed here")
    with pytest.raises(ImportError, match="otel_enabled.*opentelemetry-sdk"):
        texp.OpenTelemetryExporter()
    with pytest.raises(ImportError, match="opentelemetry-sdk"):
        texp.UnifiedMetrics.create(otel_enabled=True)
    assert jexp.OpenTelemetryExporter().enabled is False  # the JAX exporter records nothing


@pytest.fixture
def otel_stub(monkeypatch):
    """A stand-in OpenTelemetry SDK (and trace API entry points) that keeps
    every span's name and attributes."""
    spans = []

    class Span:
        def __init__(self, name):
            self.name, self.attributes = name, {}
            spans.append(self)

        def set_attribute(self, key, value):
            self.attributes[key] = value

    class Tracer:
        @contextmanager
        def start_as_current_span(self, name):
            yield Span(name)

    class TracerProvider:
        def __init__(self, resource=None):
            self.resource, self.processors = resource, []

        def add_span_processor(self, processor):
            self.processors.append(processor)

    class Resource:
        @staticmethod
        def create(attrs):
            return dict(attrs)

    mods = {"opentelemetry.sdk": types.ModuleType("opentelemetry.sdk"),
            "opentelemetry.sdk.resources": types.SimpleNamespace(Resource=Resource),
            "opentelemetry.sdk.trace": types.SimpleNamespace(TracerProvider=TracerProvider),
            "opentelemetry.sdk.trace.export": types.SimpleNamespace(
                BatchSpanProcessor=lambda exporter: ("batch", exporter))}
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    trace = pytest.importorskip("opentelemetry.trace")
    monkeypatch.setattr(trace, "set_tracer_provider", lambda provider: None)
    monkeypatch.setattr(trace, "get_tracer", lambda name: Tracer())
    return spans


def test_otel_spans_match_jax_with_an_sdk(otel_stub):
    for mod, cls in ((jexp, JaxAgentMetrics), (texp, AgentMetrics)):
        um = mod.UnifiedMetrics.create(otel_enabled=True)
        with um.trace_agent("probe", cls(agent_name="probe", started=0.0, ended=0.5,
                                         llm_calls=2, confidence=0.4)) as span:
            assert span is otel_stub[-1]
        with um.trace_agent("bare"):
            pass
    jspans, tspans = otel_stub[:2], otel_stub[2:]
    assert [(s.name, s.attributes) for s in tspans] == [(s.name, s.attributes) for s in jspans]
    assert tspans[0].attributes["agent.llm_calls"] == 2 and tspans[1].attributes == {}
    with pytest.raises(ImportError, match="opentelemetry-exporter-otlp"):
        texp.OpenTelemetryExporter(endpoint="localhost:4317")


def test_unified_facade_and_process_exporter_match_jax(monkeypatch):
    for mod, cls in ((jexp, JaxAgentMetrics), (texp, AgentMetrics)):
        um = mod.UnifiedMetrics.create(prometheus_enabled=False, otel_enabled=False)
        assert (um.prometheus, um.otel) == (None, None)
        um.record_agent(cls(agent_name="x"))
        with um.trace_agent("x") as span:
            assert span is None
        monkeypatch.setattr(mod, "_global", None)
        first = mod.get_metrics_exporter()
        assert mod.get_metrics_exporter(prometheus_enabled=True) is first


def _orchestrator_counts(stacks, monkeypatch, make_exporter):
    """Each package's orchestrator over the stacks with `make_exporter(pkg)`
    wired in; one run; the per-agent execution counts it recorded."""
    from radiant_rag_tpu.orchestrator import RAGOrchestrator as JaxOrchestrator
    from radiant_rag_tpu_torch.orchestrator import RAGOrchestrator

    from _torch_agentic_world import llms, replace_sections

    monkeypatch.setattr(JaxBaseAgent, "metrics_sink", None)  # restored afterwards
    monkeypatch.setattr(BaseAgent, "metrics_sink", None)
    counts = []
    for key, make, client in (("j", JaxOrchestrator, llms()[0]),
                              ("t", RAGOrchestrator, llms()[1])):
        cfg, store, bm25, models = stacks[key]
        cfg, exporter, namespace = make_exporter(key, cfg)
        cfg = replace_sections(cfg, strategy_memory={"enabled": False})
        try:
            orch = make(cfg, store, bm25, models, client, metrics_exporter=exporter)
            base = JaxBaseAgent if key == "j" else BaseAgent
            assert base.metrics_sink is orch.metrics_exporter is not None
            result = orch.run("How do mitochondria produce the energy of the cell?")
            assert result.success
            agents = [a["name"] for a in orch.get_agent_stats()] + ["rerank"]
            counts.append({a: REGISTRY.get_sample_value(f"{namespace}_agent_executions_total",
                                                        {"agent": a}) for a in agents})
        finally:
            unregister(orch.metrics_exporter.prometheus)
    return counts


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    from _torch_agentic_world import make_stacks

    return make_stacks(tmp_path_factory.mktemp("obs"))


def test_orchestrator_records_every_agent_run_as_jax(stacks, monkeypatch):
    def given(key, cfg):
        ns = f"radiant_obs_orch_{key}{next(_NAMES)}"
        mod = jexp if key == "j" else texp
        return cfg, mod.UnifiedMetrics(prometheus=mod.PrometheusMetricsExporter(namespace=ns)), ns

    ref, got = _orchestrator_counts(stacks, monkeypatch, given)
    assert got == ref and got["planning"] == 1.0 and got["rerank"] >= 1.0


def test_metrics_config_builds_the_exporter_as_jax(stacks, monkeypatch):
    """metrics.prometheus_enabled builds the exporter in both packages (the
    default namespace, once per package, unregistered in between)."""
    from _torch_agentic_world import replace_sections

    def from_config(key, cfg):
        return (replace_sections(cfg, metrics={"prometheus_enabled": True,
                                               "prometheus_port": 0}), None, "radiant_tpu")

    ref, got = _orchestrator_counts(stacks, monkeypatch, from_config)
    assert got == ref and got["planning"] == 1.0
    cfg = replace_sections(stacks["t"][0], metrics={"otel_enabled": True})
    try:
        import opentelemetry.sdk  # noqa: F401
    except ImportError:
        from radiant_rag_tpu_torch.orchestrator import RAGOrchestrator

        with pytest.raises(ImportError, match="opentelemetry-sdk"):
            RAGOrchestrator(cfg, *stacks["t"][1:], None)


# ---------------------------------------------------------------- profiling
def test_device_timer_matches_jax_and_materializes():
    x = torch.ones((64, 64))
    got = tprof.device_timer(lambda: x @ x, iters=3, warmup=1)
    import jax.numpy as jnp

    xj = jnp.ones((64, 64))
    ref = jprof.device_timer(lambda: xj @ xj, iters=3, warmup=1)
    assert set(got) == set(ref) and got["iters"] == ref["iters"] == 3.0
    assert 0 <= got["min_ms"] <= got["median_ms"] <= got["max_ms"]
    copies = []

    class Out(torch.Tensor):
        def cpu(self, *a, **kw):
            copies.append(1)
            return super().cpu(*a, **kw)

    def fn():
        return {"rows": [x.as_subclass(Out), 7], "n": 3}

    tprof.device_timer(fn, iters=4, warmup=2)
    assert len(copies) == 6  # the first output copied each call, warm-up included
    assert tprof.device_timer(lambda: [[("doc", 0.5)]], iters=2)["iters"] == 2.0  # host output


def test_profiler_trace_holds_the_annotations_and_ops(tmp_path):
    with tprof.profiler_trace(str(tmp_path / "tr")) as prof:
        with tprof.annotate("phase.retrieval"):
            torch.ones(32, 32) @ torch.ones(32, 32)
        with jprof.annotate("region"):  # the JAX helper is safe anywhere
            pass
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "phase.retrieval" in names and "aten::mm" in names
    assert any(e.key == "phase.retrieval" for e in prof.key_averages())


def test_a_profiler_that_fails_to_start_raises(monkeypatch, tmp_path):
    import torch.profiler

    class Broken:
        def __init__(self, *a, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    ran = []
    with pytest.raises(RuntimeError, match="profiler busy"):
        with tprof.profiler_trace(str(tmp_path / "x")):
            ran.append(1)
    assert ran == []
