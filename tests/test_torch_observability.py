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

The port's own (no JAX counterpart): the exporters' repaired paths (errors
and the active-runs gauge through the facade, agent spans, failed runs,
exporter failures that never break a run), and the program's spans:
`annotate` is a shared null context with no profiler running and an
operator range (no user annotation) under one; the searcher, embedder and
reranker open their stage spans in order around unchanged results;
`gc_spans` wraps full collections only and leaves `gc.callbacks` as found.
"""

import gc
import itertools
import json
import sys
import types
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radiant_rag_tpu.agents.base_agent import AgentMetrics as JaxAgentMetrics
from radiant_rag_tpu.agents.base_agent import BaseAgent as JaxBaseAgent
from radiant_rag_tpu.utils import metrics_export as jexp
from radiant_rag_tpu.utils import profiling as jprof
from radiant_rag_tpu_torch.agents.base import new_agent_context
from radiant_rag_tpu_torch.agents.base_agent import (
    AgentMetrics, AgentStatus, BaseAgent, DeviceStageError,
)
from radiant_rag_tpu_torch.utils import metrics_export as texp
from radiant_rag_tpu_torch.utils import profiling as tprof

from _torch_parity import assert_result_match

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


# ------------------------------------------- the exporters' repaired paths
def test_unified_facade_forwards_errors_and_runs(exporters):
    (_jx, tx), (_jn, tn) = exporters()
    um = texp.UnifiedMetrics(prometheus=tx)
    um.record_error("probe")
    um.record_error("probe")
    with um.track_run():
        inside = REGISTRY.get_sample_value(f"{tn}_active_runs")
    assert (inside, samples(tn, "probe")["agent_errors_total"],
            REGISTRY.get_sample_value(f"{tn}_active_runs")) == (1.0, 2.0, 0.0)
    bare = texp.UnifiedMetrics()  # no exporter: both are no-ops
    bare.record_error("probe")
    with bare.track_run():
        pass


class _Sink:
    """A metrics sink that logs each call in order; `broken` names the calls
    that raise."""

    def __init__(self, broken=()):
        self.calls, self.broken = [], set(broken)

    def _log(self, call):
        self.calls.append(call)
        if call in self.broken:
            raise RuntimeError(f"exporter {call} broken")

    def record_agent(self, metrics):
        self._log(f"agent {metrics.agent_name} {metrics.ended is not None}")

    def record_error(self, agent_name):
        self._log(f"error {agent_name}")

    @contextmanager
    def trace_agent(self, agent_name, metrics=None):
        self._log("span enter")
        try:
            yield None
        finally:
            self._log("span exit")

    @contextmanager
    def track_run(self):
        self._log("run enter")
        try:
            yield
        finally:
            self._log("run exit")


class _Probe(BaseAgent):
    name = "probe"

    def __init__(self, fail=None, fallback=False):
        super().__init__()
        self.fail, self.fallback = fail, fallback

    def _execute(self, ctx, **kwargs):
        if self.fail is not None:
            raise self.fail
        return "data"

    def _on_error(self, ctx, exc, **kwargs):
        if self.fallback:
            return "fallback"
        raise exc


@pytest.mark.parametrize("case", ["success", "degraded", "failed", "device"])
def test_every_agent_run_is_exported_inside_its_span(monkeypatch, case):
    """A run inside the sink's agent span; a failed, degraded or raised run
    counts an error before its metrics (the failed run's were dropped)."""
    sink = _Sink()
    monkeypatch.setattr(BaseAgent, "metrics_sink", sink)
    fail = {"success": None, "degraded": ValueError("bad json"), "failed": ValueError("bad"),
            "device": DeviceStageError("scan: boom")}[case]
    agent = _Probe(fail=fail, fallback=case == "degraded")
    ctx = new_agent_context("q")
    if case == "device":
        with pytest.raises(DeviceStageError, match="boom"):
            agent.run(ctx)
    else:
        status = agent.run(ctx).status
        assert status == {"success": AgentStatus.SUCCESS, "degraded": AgentStatus.PARTIAL,
                          "failed": AgentStatus.FAILED}[case]
    error = [] if case == "success" else ["error probe"]
    assert sink.calls == ["span enter", *error, "agent probe True", "span exit"]
    sink.calls.clear()
    agent.enabled = False  # a skipped agent exports nothing
    assert agent.run(ctx).status == AgentStatus.SKIPPED and sink.calls == []


@pytest.mark.parametrize("broken", ["span enter", "span exit", "agent probe True",
                                    "run enter", "run exit"])
def test_exporter_failures_never_break_a_run(monkeypatch, broken):
    from radiant_rag_tpu_torch.utils.metrics_export import guarded

    sink = _Sink(broken=[broken])
    monkeypatch.setattr(BaseAgent, "metrics_sink", sink)
    assert _Probe().run(new_agent_context("q")).data == "data"
    with guarded(sink.track_run):
        ran = True
    assert ran
    # the body's own failure is raised as it is, whatever the exporter does
    with pytest.raises(DeviceStageError, match="boom"):
        _Probe(fail=DeviceStageError("scan: boom")).run(new_agent_context("q"))
    with pytest.raises(KeyError, match="body"):
        with guarded(sink.track_run):
            raise KeyError("body")


def test_orchestrator_run_holds_the_active_runs_gauge(stacks, monkeypatch):
    from radiant_rag_tpu_torch.orchestrator import RAGOrchestrator

    from _torch_agentic_world import llms, replace_sections

    monkeypatch.setattr(BaseAgent, "metrics_sink", None)
    ns = f"radiant_obs_runs_{next(_NAMES)}"
    exporter = texp.UnifiedMetrics(prometheus=texp.PrometheusMetricsExporter(namespace=ns))
    cfg, store, bm25, models = stacks["t"]
    cfg = replace_sections(cfg, strategy_memory={"enabled": False})
    seen = []

    def progress(event, step, info):
        seen.append(REGISTRY.get_sample_value(f"{ns}_active_runs"))

    try:
        orch = RAGOrchestrator(cfg, store, bm25, models, llms()[1], metrics_exporter=exporter)
        assert orch.run("How do mitochondria produce the energy of the cell?",
                        progress=progress).success
        after = REGISTRY.get_sample_value(f"{ns}_active_runs")
    finally:
        unregister(exporter.prometheus)
    assert seen and set(seen) == {1.0} and after == 0.0


# ------------------------------------------------------- the program's spans
STAGES = ("embed.prep", "hybrid.prep", "hybrid.dense", "hybrid.bm25", "hybrid.bm25.prep",
          "hybrid.fuse", "rerank.prep")


def _spans(prof, names):
    """(name, start_ns, end_ns) of the named host ranges of a finished
    profile, by start (an enclosing range before the ranges it holds)."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in names and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def test_annotate_is_one_flag_check_without_a_profiler(monkeypatch):
    """No profiler: the shared null context, and no range is made; under
    one: a range per span, an operator range, not a user annotation (a
    user annotation gets a device row of its own under CUDA)."""
    made = []

    def counting(real):
        def make(name, *a):
            made.append(name)
            return real(name, *a)
        return make

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting(torch.autograd.profiler.record_function))
    assert not torch._C._autograd._profiler_enabled()
    span = tprof.annotate("hybrid.dense")
    assert span is tprof.annotate("embed.prep")
    with span:
        with tprof.annotate("hybrid.fuse"):
            pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.annotate("hybrid.dense"):
            with tprof.annotate("hybrid.fuse"):
                torch.ones(4) + 1
    assert made == ["hybrid.dense", "hybrid.fuse"]
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in STAGES]
    assert sorted(e.name() for e in events) == ["hybrid.dense", "hybrid.fuse"]
    assert not any(e.is_user_annotation() for e in events)


@pytest.fixture(scope="module")
def tiny():
    """A 500-doc searcher with a seeded 1-layer embedder and cross-encoder,
    the port alone, on the CPU."""
    from radiant_rag_tpu_torch.config import CrossEncoderConfig, EmbeddingConfig
    from radiant_rag_tpu_torch.index.bm25 import BM25Index
    from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
    from radiant_rag_tpu_torch.index.hybrid import HybridSearcher
    from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
    from radiant_rag_tpu_torch.models.device_rerank import DeviceReranker
    from radiant_rag_tpu_torch.models.embedder import Embedder

    n, d = 500, 32
    rng = np.random.default_rng(17)
    texts = [" ".join(f"w{t}" for t in row) for row in rng.zipf(1.3, (n, 16)) % 500]
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    eng = DeviceVectorIndex(d, initial_capacity=n, device="cpu")
    eng.append(vecs, np.zeros(n, np.int8), np.zeros(n, np.int32), np.full(n, 16, np.float32))
    bm = BM25Index(sketch_dim=128, device="cpu")
    bm.bulk_build(list(range(n)), texts)
    emb = Embedder(EmbeddingConfig(preset="none", dim=d, num_layers=1, num_heads=4,
                                   hidden_dim=64, vocab_size=1024, max_seq_len=32,
                                   batch_size=64, dtype="float32", checkpoint_dir=""),
                   seed=2, device="cpu")
    ce = CrossEncoder(CrossEncoderConfig(dim=d, num_layers=1, num_heads=4, hidden_dim=64,
                                         vocab_size=1024, max_seq_len=64, dtype="float32"),
                      seed=3, device="cpu")
    reranker = DeviceReranker(ce, pair_chunk=256)
    reranker.build_table(texts)
    qidx = rng.integers(0, n, 6)
    q = vecs[qidx] + 0.2 * rng.standard_normal((6, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return {"searcher": HybridSearcher(eng, bm), "embedder": emb, "reranker": reranker,
            "q": q, "qt": [" ".join(texts[i].split()[:5]) for i in qidx]}


@pytest.mark.parametrize("bm25_mode", ["sketch", "pages"])
def test_search_rows_opens_its_stage_spans_in_order(tiny, tmp_path, bm25_mode):
    searcher, q, qt = tiny["searcher"], tiny["q"], tiny["qt"]
    kw = dict(mode="int8", bm25_mode=bm25_mode, fused_depth=20)
    plain = searcher.search_rows(q, qt, **kw)
    with tprof.profiler_trace(str(tmp_path / "tr")) as prof:
        traced = searcher.search_rows(q, qt, **kw)
    spans = _spans(prof, STAGES)
    assert [n for n, _, _ in spans] == ["hybrid.prep", "hybrid.dense", "hybrid.bm25",
                                        "hybrid.bm25.prep", "hybrid.fuse"]
    (_, *prep), (_, *dense), (_, *bm25), (_, *bm25_prep), (_, *fuse) = spans
    assert prep[1] <= dense[0] and dense[1] <= bm25[0] and bm25[1] <= fuse[0]
    assert bm25[0] <= bm25_prep[0] and bm25_prep[1] <= bm25[1]
    if bm25_mode == "pages":  # its scatter-add order is not fixed: two untraced calls
        assert_result_match(plain, traced, "traced pages")  # differ in the last bit too
        return
    for leg in plain:
        np.testing.assert_array_equal(traced[leg][1], plain[leg][1])
        np.testing.assert_array_equal(traced[leg][0], plain[leg][0])


def test_chunked_batches_keep_the_spans_per_chunk(tiny, tmp_path):
    searcher, q, qt = tiny["searcher"], tiny["q"], tiny["qt"]
    eng = searcher.engine
    saved = eng.usable_bytes
    try:  # shrink the gate to 4-query batches: 6 queries run as 2 chunks
        eng.usable_bytes = (eng.resident_bytes()
                            + searcher.bm25.device_bytes_projected(eng.capacity)
                            + 4 * eng.capacity * 24)
        assert searcher.max_query_bucket() == 4
        with tprof.profiler_trace(str(tmp_path / "tr")) as prof:
            searcher.search_rows(q, qt, mode="int8", bm25_mode="sketch")
    finally:
        eng.usable_bytes = saved
    names = [n for n, _, _ in _spans(prof, STAGES)]
    one = ["hybrid.prep", "hybrid.dense", "hybrid.bm25", "hybrid.bm25.prep", "hybrid.fuse"]
    assert names == ["hybrid.prep"] + one + one  # the whole batch's gate, then each chunk


def test_embed_device_and_rerank_rows_open_their_prep_spans(tiny, tmp_path):
    emb, reranker, qt = tiny["embedder"], tiny["reranker"], tiny["qt"]
    rows = tiny["searcher"].search_rows(tiny["q"], qt, mode="int8")["fused"][1]
    plain = emb.embed_device(qt, pad_to=8), reranker.rerank_rows(qt, rows, top_k=5)
    with tprof.profiler_trace(str(tmp_path / "tr")) as prof:
        traced = emb.embed_device(qt, pad_to=8), reranker.rerank_rows(qt, rows, top_k=5)
    assert [n for n, _, _ in _spans(prof, STAGES)] == ["embed.prep", "rerank.prep"]
    torch.testing.assert_close(traced[0], plain[0], rtol=0, atol=0)
    for got, ref in zip(traced[1], plain[1]):
        np.testing.assert_array_equal(got, ref)


def test_gc_spans_wrap_full_collections_only():
    before = list(gc.callbacks)
    with tprof.gc_spans():  # no profiler running: no hook
        assert gc.callbacks == before
    automatic = gc.isenabled()
    gc.disable()  # no collection but the test's own
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tprof.gc_spans():
                assert len(gc.callbacks) == len(before) + 1
                gc.collect(0)
                gc.collect(1)
                with tprof.annotate("t.before"):
                    pass
                gc.collect()
                with tprof.annotate("t.after"):
                    pass
            assert gc.callbacks == before
            with pytest.raises(RuntimeError, match="body"):
                with tprof.gc_spans():
                    raise RuntimeError("body")
            assert gc.callbacks == before
    finally:
        if automatic:
            gc.enable()
    spans = _spans(prof, ("gc", "t.before", "t.after"))
    assert [n for n, _, _ in spans] == ["t.before", "gc", "t.after"]
    assert spans[0][2] <= spans[1][1] < spans[1][2] <= spans[2][1]
