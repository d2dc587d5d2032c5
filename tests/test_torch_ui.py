"""The port's user-facing surfaces against the JAX package's (CPU): the
display helpers, the reports, the TUI view model and the TUI loops.

Both packages render equal inputs (each package's own PipelineResult and
StoredDoc of the same fields) to equal strings: the tabs, the timeline, the
markdown / HTML / JSON / text reports and the search report, with the
clock masked where a renderer prints it (log lines' HH:MM:SS, a running
step's elapsed ms, `generated_at`). Reports of two real runs (one question
through both packages' orchestrators, tests/_torch_agentic_world.py) match
with their step timings and the citations' random audit id masked too.
Mirrors tests/test_tui_model.py and tests/test_app.py's report case.
"""

import io
import json
import re

import pytest

from radiant_rag_tpu.index.doc import StoredDoc as JaxDoc
from radiant_rag_tpu.orchestrator import PipelineResult as JaxResult
from radiant_rag_tpu.ui import display as jdisplay
from radiant_rag_tpu.ui import reports as jreports
from radiant_rag_tpu.ui import tui as jtui
from radiant_rag_tpu.ui import tui_model as jmodel
from radiant_rag_tpu_torch.agents.base_agent import DeviceStageError
from radiant_rag_tpu_torch.index.doc import StoredDoc
from radiant_rag_tpu_torch.orchestrator import PipelineResult
from radiant_rag_tpu_torch.ui import display as tdisplay
from radiant_rag_tpu_torch.ui import reports as treports
from radiant_rag_tpu_torch.ui import tui as ttui
from radiant_rag_tpu_torch.ui import tui_model as tmodel

CLOCK = re.compile(r"\d\d:\d\d:\d\d")
MS = re.compile(r"\d+ ms")


def _result(doc_cls, result_cls, **over):
    d1 = doc_cls("id1", "alpha content about lasers\nand more", {"source": "a.txt"})
    d2 = doc_cls("id2", "beta content <about> optics & more", {"source": "b.txt"})
    fields = dict(
        query="what is a laser?",
        answer="A laser emits coherent light.\nIt is <bright> & narrow.",
        confidence=0.83, retry_count=1,
        plan={"use_decomposition": False, "retrieval_k": 10},
        effective_queries=["what is a laser?", "laser physics"],
        dense_docs=[(d1, 0.91)], bm25_docs=[(d2, 7.3)], web_docs=[(d2, 0.9)],
        fused_docs=[(d1, 0.05), (d2, 0.04)], reranked_docs=[(d1, 2.2)],
        docs=[(d1, 2.2), (d2, 1.1)],
        critic_notes=["cites one source"], warnings=["w1"],
        degraded={"rerank": "RuntimeError: x"},
        fact_verification={"overall_score": 0.75,
                           "claims": [{"status": "supported", "claim": "lasers emit light"}]},
        citations={"citations": [{"id": 1}]},
        language={"source_language": "de", "translated": True, "confidence": 0.9},
        metrics={"steps": [
            {"name": "planning", "duration_ms": 12.0, "ok": True},
            {"name": "retrieval", "duration_ms": 48.0, "ok": True},
            {"name": "synthesis", "duration_ms": 200.0, "ok": False,
             "error": "LLMError: boom"},
        ], "total_ms": 260.0},
    )
    fields.update(over)
    return result_cls(**fields)


def results(**over):
    return _result(JaxDoc, JaxResult, **over), _result(StoredDoc, PipelineResult, **over)


VARIANTS = [{}, {"plan": {}, "degraded": {}, "warnings": [], "metrics": {}, "docs": [],
                 "effective_queries": [], "fact_verification": {}, "language": {},
                 "dense_docs": [], "bm25_docs": [], "web_docs": [], "fused_docs": [],
                 "reranked_docs": [], "retry_count": 0, "low_confidence": True}]


# ---------------------------------------------------------------- view model
def _sessions(events):
    out = []
    for mod in (jmodel, tmodel):
        s = mod.QuerySession()
        s.begin()
        for e in events:
            s.observer(*e)
        out.append(s)
    return out


def test_observer_timeline_matches_jax():
    events = [("step_start", "planning", {}),
              ("step_end", "planning", {"ok": True, "duration_ms": 12.5}),
              ("step_start", "retrieval", {}),
              ("step_end", "orphan", {"ok": False, "duration_ms": 3.0, "error": "E"}),
              ("step_start", "synthesis", {})]
    js, ts = _sessions(events)
    assert [MS.sub("", line) for line in ts.timeline_lines()] == \
        [MS.sub("", line) for line in js.timeline_lines()]
    assert len(ts.timeline_lines()) == 4 and "…" in ts.timeline_lines()[1]
    assert [CLOCK.sub("T", line) for line in ts.logs] == [CLOCK.sub("T", line) for line in js.logs]
    for s in (js, ts):
        s.observer("step_end", "retrieval", {"ok": False, "duration_ms": 3.0,
                                             "error": "ValueError: x"})
        s.finish(error="backend down")
    assert ts.timeline_lines()[1] == js.timeline_lines()[1]
    assert (ts.error, ts.running, ts.result) == (js.error, js.running, None)
    assert CLOCK.sub("T", ts.tab("logs")) == CLOCK.sub("T", js.tab("logs"))


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
@pytest.mark.parametrize("tab", jmodel.TAB_NAMES)
def test_tabs_match_jax(tab, variant):
    jr, tr = results(**VARIANTS[variant])
    js, ts = jmodel.QuerySession(), tmodel.QuerySession()
    js.finish(result=jr)
    ts.finish(result=tr)
    assert ts.tab(tab) == js.tab(tab) and ts.tab(tab)


def test_session_edges_and_report_markdown_match_jax():
    assert tmodel.TAB_NAMES == jmodel.TAB_NAMES
    js, ts = jmodel.QuerySession(), tmodel.QuerySession()
    assert ts.tab("overview") == js.tab("overview") == "(no result yet)"
    assert ts.tab("logs") == js.tab("logs") == "(no logs)"
    assert ts.report_markdown() == js.report_markdown() == "# No result\n"
    jr, tr = results()
    js.finish(result=jr)
    ts.finish(result=tr)
    assert ts.report_markdown() == js.report_markdown()
    assert "## Agents" in ts.report_markdown()
    for s in (js, ts):
        with pytest.raises(ValueError, match="unknown tab"):
            s.tab("nope")


def test_run_query_matches_jax_and_shows_a_card_failure():
    class FakeApp:
        def __init__(self, result):
            self.result = result

        def query(self, q, conversation_id="", progress=None):
            progress("step_start", "retrieval", {})
            progress("step_end", "retrieval", {"ok": True, "duration_ms": 5.0})
            return self.result

    class NoProgress:  # a facade without progress= (the SimplifiedOrchestrator paths)
        def __init__(self, result):
            self.result = result

        def query(self, q):
            return self.result

    jr, tr = results()
    for app_cls in (FakeApp, NoProgress):
        js, ts = jmodel.QuerySession(), tmodel.QuerySession()
        jmodel.run_query(js, app_cls(jr), "q")
        tmodel.run_query(ts, app_cls(tr), "q")
        assert ts.result is tr and js.result is jr and not ts.running and ts.error is None
        assert ts.timeline_lines() == js.timeline_lines()

    class CardDown:
        def query(self, q, conversation_id="", progress=None):
            raise DeviceStageError("hybrid retrieval: RuntimeError: CUDA error")

    ts = tmodel.QuerySession()
    tmodel.run_query(ts, CardDown(), "q")
    assert ts.error.startswith("hybrid retrieval") and ts.result is None
    assert "(no result yet)" == ts.tab("overview")


def test_app_query_passes_progress_through():
    from radiant_rag_tpu_torch.app import RadiantTPU
    from radiant_rag_tpu_torch.utils.cache import QueryCache

    captured = {}

    class FakeOrch:
        def run(self, q, conversation_id="", conversation_history=None, progress=None,
                token_sink=None):
            captured["progress"] = progress
            return results()[1]

    app = RadiantTPU.__new__(RadiantTPU)
    app.orchestrator, app.conversations, app.query_cache = FakeOrch(), None, QueryCache(4, 60)
    sentinel = object()
    app.query("q", progress=sentinel, use_cache=False)
    assert captured["progress"] is sentinel


# ---------------------------------------------------------------- reports
@pytest.mark.parametrize("variant", range(len(VARIANTS)))
@pytest.mark.parametrize("fmt", ["markdown", "html", "json", "text"])
def test_report_renderers_match_jax(fmt, variant):
    jr, tr = results(**VARIANTS[variant])
    ref = jreports.QueryReport.from_pipeline_result(jr)
    got = treports.QueryReport.from_pipeline_result(tr)
    got.generated_at = ref.generated_at
    assert getattr(got, f"to_{fmt}")() == getattr(ref, f"to_{fmt}")()
    if fmt == "json":
        assert json.loads(got.to_json())["query"] == tr.query


def test_report_save_by_suffix_and_search_report_match_jax(tmp_path):
    jr, tr = results()
    ref = jreports.QueryReport.from_pipeline_result(jr)
    got = treports.QueryReport.from_pipeline_result(tr)
    got.generated_at = ref.generated_at
    for name in ("r.md", "r.markdown", "r.HTML", "r.htm", "r.json", "r.txt", "r"):
        got.save(str(tmp_path / f"t_{name}"))
        ref.save(str(tmp_path / f"j_{name}"))
        assert (tmp_path / f"t_{name}").read_text() == (tmp_path / f"j_{name}").read_text()
    assert (tmp_path / "t_r.HTML").read_text().startswith("<!DOCTYPE html>")
    assert (tmp_path / "t_r.txt").read_text() == got.to_text()
    for hits in (tr.docs, []):
        jhits = [(JaxDoc(d.doc_id, d.content, d.meta), s) for d, s in hits]
        treports.save_search_report("laser?", hits, str(tmp_path / "ts.md"))
        jreports.save_search_report("laser?", jhits, str(tmp_path / "js.md"))
        assert (tmp_path / "ts.md").read_text() == (tmp_path / "js.md").read_text()
    for scores in ([], [1.0], [2.0, 2.0], [3.0, 1.0, 2.0]):
        docs = [(i, s) for i, s in enumerate(scores)]
        assert treports.normalize_scores(docs) == jreports.normalize_scores(docs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _torch_agentic_world import make_stacks, orchestrators

    jo, to = orchestrators(make_stacks(tmp_path_factory.mktemp("ui")))
    q = "How do mitochondria produce energy for the cell and why does ATP matter?"
    return jo.run(q), to.run(q)


def test_reports_of_two_runs_match_with_timings_masked(runs, tmp_path):
    jr, tr = runs
    ref = jreports.QueryReport.from_pipeline_result(jr)
    got = treports.QueryReport.from_pipeline_result(tr)
    got.generated_at = ref.generated_at
    ms = re.compile(r"\d+ ms")
    for fmt in ("markdown", "html", "text"):
        assert ms.sub("", getattr(got, f"to_{fmt}")()) == ms.sub("", getattr(ref, f"to_{fmt}")())
    gj, rj = json.loads(got.to_json()), json.loads(ref.to_json())
    for doc in (gj, rj):
        doc["citations"].pop("audit_id")  # random per run
        doc["steps"] = [s["name"] for s in doc["steps"]]
        doc["docs"] = [{k: v for k, v in d.items() if k != "score"} for d in doc["docs"]]
    assert gj == rj and gj["answer"] == tr.answer


# ---------------------------------------------------------------- display and the TUI
@pytest.mark.parametrize("rich", [True, False])
def test_display_matches_jax(rich, monkeypatch, capsys):
    monkeypatch.setenv("COLUMNS", "100")
    for mod in (jdisplay, tdisplay):
        monkeypatch.setattr(mod, "HAVE_RICH", rich)
    jr, tr = results()
    calls = [("display_answer", (jr,), (tr,)),
             ("display_search_results", ("q", jr.docs), ("q", tr.docs)),
             ("display_stats", ({"a": 1, "b": [1, 2]},), ({"a": 1, "b": [1, 2]},)),
             ("display_health", ({"store": True, "llm": False},),
              ({"store": True, "llm": False},))]
    for name, jargs, targs in calls:
        getattr(jdisplay, name)(*jargs)
        ref = capsys.readouterr().out
        getattr(tdisplay, name)(*targs)
        got = capsys.readouterr().out
        assert got == ref and got, name
    for mod in (jdisplay, tdisplay):
        with mod.ProgressDisplay("working") as p:
            p.update("still")
    if not rich:
        assert capsys.readouterr().out == "working...\nworking...\n"


class _QueryApp:
    def __init__(self, result):
        self.result, self.questions = result, []

    def query(self, q, conversation_id="", progress=None):
        self.questions.append(q)
        if progress is not None:
            progress("step_start", "retrieval", {})
            progress("step_end", "retrieval", {"ok": True, "duration_ms": 5.0})
        return self.result


def test_plain_tui_matches_jax(monkeypatch, capsys):
    jr, tr = results()
    out = []
    for mod, disp, res in ((jtui, jdisplay, jr), (ttui, tdisplay, tr)):
        monkeypatch.setattr(mod, "HAVE_TEXTUAL", False)
        monkeypatch.setattr(mod, "HAVE_RICH", False)
        monkeypatch.setattr(disp, "HAVE_RICH", False)
        monkeypatch.setattr("sys.stdin", io.StringIO("what is a laser?\n\n"))
        app = _QueryApp(res)
        mod.run_tui(app)
        out.append(capsys.readouterr().out)
        assert app.questions == ["what is a laser?"]
    assert out[1] == out[0] and "coherent light" in out[1]


def test_rich_tui_runs_a_query_and_saves_a_report(monkeypatch, capsys, tmp_path):
    _, tr = results()
    monkeypatch.setattr(ttui, "HAVE_TEXTUAL", False)
    path = tmp_path / "tui.md"
    monkeypatch.setattr("sys.stdin", io.StringIO(f"what is a laser?\n:plan\n:nope\n:save {path}\n"
                                                 ":new\n\n"))
    app = _QueryApp(tr)
    ttui.run_tui(app)
    out = capsys.readouterr().out
    assert app.questions == ["what is a laser?"] and "coherent light" in out
    assert "retrieval_k" in out and "unknown command :nope" in out
    assert path.read_text().startswith("# Query report") and "new conversation started" in out


def test_tui_without_a_terminal_takes_the_line_loop(monkeypatch, capsys):
    """With `textual` importable but stdin a pipe, the port's TUI reads
    lines (the rich or plain loop) instead of starting the Textual app,
    which would wait for a terminal."""
    _, tr = results()
    started = []
    monkeypatch.setattr(ttui, "HAVE_TEXTUAL", True)
    monkeypatch.setattr(ttui, "AgenticRAGApp", lambda app: started.append(app), raising=False)
    monkeypatch.setattr("sys.stdin", io.StringIO("what is a laser?\n\n"))
    app = _QueryApp(tr)
    ttui.run_tui(app)
    assert started == [] and app.questions == ["what is a laser?"]
    assert "coherent light" in capsys.readouterr().out


def _shown(ui, selector):
    """The plain text a Textual `Static` shows (`content` in newer Textual,
    `renderable` in older)."""
    widget = ui.query_one(selector, ttui.Static)
    for attr in ("content", "renderable"):
        value = getattr(widget, attr, None)
        if value is not None and not callable(value):
            return str(value)
    return str(widget.render())


def test_textual_tui_runs_a_query_and_fills_the_tabs(monkeypatch, tmp_path):
    """The Textual frontend headless (`App.run_test`'s pilot), where
    `textual` is installed: a question typed into the input runs through
    the app in a worker thread, the timeline and every tab show the
    session's run, and ctrl+s saves its markdown report into the working
    directory. `chip_smoke.py` phase 12 (d) drives it over the card's app."""
    pytest.importorskip("textual")
    import asyncio

    _, tr = results()
    app = _QueryApp(tr)
    monkeypatch.chdir(tmp_path)

    async def drive():
        ui = ttui.AgenticRAGApp(app)
        async with ui.run_test(size=(120, 48)) as pilot:
            box = ui.query_one("#query", ttui.Input)
            box.focus()
            box.value = "what is a laser?"
            await pilot.press("enter")
            for _ in range(400):
                await pilot.pause(0.05)
                if ui.session.result is not None and not ui.session.running \
                        and _shown(ui, "#content-overview").strip():
                    break
            tabs = {name: _shown(ui, f"#content-{name}") for name in tmodel.TAB_NAMES}
            timeline = _shown(ui, "#timeline")
            await pilot.press("ctrl+s")
            await pilot.pause(0.2)
        return ui.session, tabs, timeline

    session, tabs, timeline = asyncio.run(drive())
    assert app.questions == ["what is a laser?"] and session.error is None
    assert "coherent light" in tabs["overview"] and "retrieval_k" in tabs["plan"]
    assert all(tabs[name].strip() for name in tmodel.TAB_NAMES) and "retrieval" in timeline
    (saved,) = tmp_path.glob("report-*.md")
    assert saved.read_text() == session.report_markdown()
