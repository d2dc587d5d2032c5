"""TUI view model: frontend-independent session state for the terminal UI.

The port's copy of `radiant_rag_tpu/ui/tui_model.py`: the live step
timeline fed by the orchestrator's `progress` observer, the tab contents
built from a PipelineResult (overview / plan / queries / retrieval / agents
/ metrics / logs), and the report export, in a headless layer the tests
drive; the frontends (ui/tui.py) only render it. A run that raises (a card
failure included) ends the session's query with its error shown, not with
an answer.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

TAB_NAMES = ["overview", "plan", "queries", "retrieval", "agents", "metrics", "logs"]


@dataclass
class LiveStep:
    name: str
    status: str = "running"  # running | ok | error
    duration_ms: float = 0.0
    error: str = ""
    started: float = field(default_factory=time.time)


class QuerySession:
    """State for one TUI session: live progress + last result's tab views."""

    def __init__(self) -> None:
        self.steps: List[LiveStep] = []
        self.logs: List[str] = []
        self.result: Any = None
        self.running = False
        self.error: Optional[str] = None
        self._lock = threading.Lock()
        self._by_name: Dict[str, LiveStep] = {}

    # -- live observer (orchestrator progress hook) ------------------------
    def observer(self, event: str, name: str, info: Dict[str, Any]) -> None:
        """Signature matches RunMetrics.observer: (event, step_name, info)."""
        with self._lock:
            if event == "step_start":
                step = LiveStep(name=name)
                self.steps.append(step)
                self._by_name[name] = step
                self.logs.append(f"[{time.strftime('%H:%M:%S')}] start {name}")
            elif event == "step_end":
                step = self._by_name.get(name)
                if step is None:
                    step = LiveStep(name=name)
                    self.steps.append(step)
                step.status = "ok" if info.get("ok", True) else "error"
                step.duration_ms = float(info.get("duration_ms", 0.0))
                step.error = info.get("error") or ""
                self.logs.append(
                    f"[{time.strftime('%H:%M:%S')}] {'done ' if step.status == 'ok' else 'FAIL '}"
                    f"{name} ({step.duration_ms:.0f} ms)")

    def begin(self) -> None:
        with self._lock:
            self.steps = []
            self._by_name = {}
            self.running = True
            self.error = None

    def finish(self, result: Any = None, error: Optional[str] = None) -> None:
        with self._lock:
            self.running = False
            self.result = result if error is None else self.result
            self.error = error
            if error:
                self.logs.append(f"[{time.strftime('%H:%M:%S')}] ERROR {error}")

    # -- tab content (plain text blocks the frontends render) --------------
    def timeline_lines(self) -> List[str]:
        with self._lock:
            lines = []
            for s in self.steps:
                if s.status == "running":
                    lines.append(f"  … {s.name:<26} {1000*(time.time()-s.started):8.0f} ms")
                else:
                    mark = "+" if s.status == "ok" else "x"
                    lines.append(f"  {mark} {s.name:<26} {s.duration_ms:8.0f} ms")
            return lines

    def tab(self, name: str) -> str:
        r = self.result
        if name == "logs":
            return "\n".join(self.logs[-200:]) or "(no logs)"
        if r is None:
            return "(no result yet)"
        if name == "overview":
            parts = [
                f"Q: {r.query}", "",
                r.answer, "",
                f"confidence {r.confidence:.2f}"
                + ("  [LOW]" if r.low_confidence else "")
                + f"   retries {r.retry_count}   docs {len(r.docs)}",
            ]
            if r.warnings:
                parts.append("warnings: " + "; ".join(r.warnings))
            if r.degraded:
                parts.append("degraded: " + ", ".join(f"{k} ({v})" for k, v in r.degraded.items()))
            return "\n".join(parts)
        if name == "plan":
            if not r.plan:
                return "(no plan)"
            return "\n".join(f"{k:>22}: {v}" for k, v in r.plan.items())
        if name == "queries":
            lines = [f"original : {r.query}"]
            for i, q in enumerate(r.effective_queries):
                lines.append(f"effective {i}: {q}")
            return "\n".join(lines)
        if name == "retrieval":
            out = []
            for leg, docs in (("dense", r.dense_docs), ("bm25", r.bm25_docs),
                              ("web", r.web_docs), ("fused", r.fused_docs),
                              ("reranked", r.reranked_docs)):
                if not docs:
                    continue
                out.append(f"--- {leg} ({len(docs)}) ---")
                for doc, score in docs[:8]:
                    src = doc.meta.get("source", doc.doc_id[:12])
                    out.append(f"  {score:8.4f}  {src}  {doc.content[:60]!r}")
            return "\n".join(out) or "(no retrieval data)"
        if name == "agents":
            steps = (r.metrics or {}).get("steps", [])
            if not steps:
                return "(no agent timings)"
            total = sum(s.get("duration_ms", 0) for s in steps) or 1.0
            lines = [f"{'agent/step':<28} {'ms':>9}  {'%':>5}  ok"]
            for s in steps:
                ms = s.get("duration_ms", 0.0)
                lines.append(
                    f"{s.get('name', '?'):<28} {ms:9.0f}  {100*ms/total:5.1f}  "
                    f"{'+' if s.get('ok', True) else 'x: ' + str(s.get('error'))[:40]}")
            lines.append(f"{'TOTAL':<28} {total:9.0f}")
            return "\n".join(lines)
        if name == "metrics":
            m = dict(r.metrics or {})
            m.pop("steps", None)
            fv = r.fact_verification or {}
            if fv:
                m["fact_verification_score"] = fv.get("overall_score")
            cit = r.citations or {}
            if cit:
                m["citations"] = len(cit.get("citations", []))
            lang = r.language or {}
            if lang:
                m["language"] = lang.get("code", lang)
            return "\n".join(f"{k:>28}: {v}" for k, v in m.items()) or "(no metrics)"
        raise ValueError(f"unknown tab {name!r} (expected one of {TAB_NAMES})")

    def report_markdown(self) -> str:
        """Exportable report of the last run (reference ctrl+s save_report)."""
        r = self.result
        if r is None:
            return "# No result\n"
        parts = [f"# Query report\n\n**Q:** {r.query}\n\n## Answer\n\n{r.answer}\n"]
        for name in ("plan", "queries", "retrieval", "agents", "metrics"):
            parts.append(f"\n## {name.capitalize()}\n\n```\n{self.tab(name)}\n```\n")
        return "".join(parts)


def run_query(session: QuerySession, rag_app: Any, query: str,
              conversation_id: str = "") -> None:
    """Run one query against the app facade, feeding the session's observer.
    Blocking; frontends call it from a worker thread."""
    session.begin()
    try:
        result = rag_app.query(query, conversation_id=conversation_id,
                               progress=session.observer)
        session.finish(result=result)
    except TypeError:
        # facade without a progress kwarg (SimplifiedOrchestrator paths)
        try:
            result = rag_app.query(query)
            session.finish(result=result)
        except Exception as exc:  # pragma: no cover
            session.finish(error=str(exc))
    except Exception as exc:
        session.finish(error=str(exc))
