"""Query reports: markdown / HTML / JSON / plain-text renderers.

The port's copy of `radiant_rag_tpu/ui/reports.py`: `QueryReport.
from_pipeline_result`, min-max score normalization for display, the four
renderers, `save` dispatching on the file's suffix (.md / .markdown, .html /
.htm, .json, anything else plain text), `TextReportBuilder`'s numbered
sections, and `save_search_report` (the CLI's `search --save`). The CLI's
`query --report <path>` saves one. The `report` config section is read by
neither package.
"""

from __future__ import annotations

import html as html_mod
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


def normalize_scores(docs: List[Tuple[Any, float]]) -> List[Tuple[Any, float]]:
    """Min-max normalize to [0,1] for display (reference `report.py:101`)."""
    if not docs:
        return []
    scores = [s for _, s in docs]
    lo, hi = min(scores), max(scores)
    if hi - lo < 1e-12:
        return [(d, 1.0) for d, _ in docs]
    return [(d, (s - lo) / (hi - lo)) for d, s in docs]


@dataclass
class QueryReport:
    query: str
    answer: str
    confidence: float = 0.0
    plan: Dict[str, Any] = field(default_factory=dict)
    effective_queries: List[str] = field(default_factory=list)
    docs: List[Tuple[Any, float]] = field(default_factory=list)
    critic_notes: List[str] = field(default_factory=list)
    fact_verification: Dict[str, Any] = field(default_factory=dict)
    citations: Dict[str, Any] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)
    degraded: Dict[str, str] = field(default_factory=dict)
    steps: List[Dict[str, Any]] = field(default_factory=list)
    retry_count: int = 0
    generated_at: float = field(default_factory=time.time)

    @classmethod
    def from_pipeline_result(cls, result) -> "QueryReport":
        return cls(
            query=result.query,
            answer=result.answer,
            confidence=result.confidence,
            plan=dict(result.plan),
            effective_queries=list(result.effective_queries),
            docs=list(result.docs),
            critic_notes=list(result.critic_notes),
            fact_verification=dict(result.fact_verification),
            citations=dict(result.citations),
            warnings=list(result.warnings),
            degraded=dict(result.degraded),
            steps=list(result.metrics.get("steps", [])),
            retry_count=result.retry_count,
        )

    # -- renderers ---------------------------------------------------------
    def to_markdown(self) -> str:
        lines = [
            "# Query Report", "",
            f"**Query:** {self.query}", "",
            f"**Confidence:** {self.confidence:.2f}"
            + (f" · retries: {self.retry_count}" if self.retry_count else ""), "",
            "## Answer", "", self.answer, "",
        ]
        if self.effective_queries and self.effective_queries != [self.query]:
            lines += ["## Effective queries", ""]
            lines += [f"- {q}" for q in self.effective_queries] + [""]
        if self.docs:
            lines += ["## Sources", ""]
            for i, (doc, score) in enumerate(normalize_scores(self.docs), start=1):
                src = getattr(doc, "source", "")
                preview = getattr(doc, "content", "")[:200].replace("\n", " ")
                lines.append(f"{i}. **{src}** (score {score:.2f}): {preview}")
            lines.append("")
        if self.fact_verification:
            fv = self.fact_verification
            lines += ["## Fact verification", "",
                      f"Overall score: {fv.get('overall_score', 'n/a')}", ""]
            for c in fv.get("claims", []):
                lines.append(f"- [{c['status']}] {c['claim']}")
            lines.append("")
        if self.critic_notes:
            lines += ["## Critic notes", ""] + [f"- {n}" for n in self.critic_notes] + [""]
        if self.steps:
            lines += ["## Pipeline timing", ""]
            for s in self.steps:
                mark = "" if s.get("ok", True) else " (FAILED)"
                lines.append(f"- {s['name']}: {s['duration_ms']:.0f} ms{mark}")
            lines.append("")
        if self.degraded:
            lines += ["## Degraded features", ""]
            lines += [f"- {k}: {v}" for k, v in self.degraded.items()] + [""]
        return "\n".join(lines)

    def to_html(self) -> str:
        md_body = html_mod.escape(self.answer).replace("\n", "<br>")
        rows = "".join(
            f"<tr><td>{i}</td><td>{s:.2f}</td>"
            f"<td>{html_mod.escape(getattr(d, 'source', ''))}</td>"
            f"<td>{html_mod.escape(getattr(d, 'content', '')[:200])}</td></tr>"
            for i, (d, s) in enumerate(normalize_scores(self.docs), start=1)
        )
        steps = "".join(
            f"<li>{html_mod.escape(s['name'])}: {s['duration_ms']:.0f} ms</li>"
            for s in self.steps
        )
        return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Query Report</title>
<style>body{{font-family:sans-serif;max-width:900px;margin:2em auto}}
table{{border-collapse:collapse;width:100%}}td,th{{border:1px solid #ccc;padding:4px}}</style>
</head><body>
<h1>Query Report</h1>
<p><b>Query:</b> {html_mod.escape(self.query)}</p>
<p><b>Confidence:</b> {self.confidence:.2f}</p>
<h2>Answer</h2><p>{md_body}</p>
<h2>Sources</h2><table><tr><th>#</th><th>score</th><th>source</th><th>preview</th></tr>{rows}</table>
<h2>Timing</h2><ul>{steps}</ul>
</body></html>"""

    def to_json(self) -> str:
        return json.dumps({
            "query": self.query,
            "answer": self.answer,
            "confidence": self.confidence,
            "retry_count": self.retry_count,
            "plan": self.plan,
            "effective_queries": self.effective_queries,
            "docs": [
                {"source": getattr(d, "source", ""), "score": s,
                 "doc_id": getattr(d, "doc_id", ""),
                 "preview": getattr(d, "content", "")[:300]}
                for d, s in self.docs
            ],
            "fact_verification": self.fact_verification,
            "citations": self.citations,
            "critic_notes": self.critic_notes,
            "warnings": self.warnings,
            "degraded": self.degraded,
            "steps": self.steps,
            "generated_at": self.generated_at,
        }, indent=2, default=str)

    def to_text(self) -> str:
        return TextReportBuilder(self).build()

    # -- save --------------------------------------------------------------
    def save(self, path: str) -> None:
        """Format dispatch by extension (reference `report.py:697-778`)."""
        ext = Path(path).suffix.lower()
        if ext in (".md", ".markdown"):
            content = self.to_markdown()
        elif ext in (".html", ".htm"):
            content = self.to_html()
        elif ext == ".json":
            content = self.to_json()
        else:
            content = self.to_text()
        Path(path).write_text(content)


class TextReportBuilder:
    """Numbered-section plain-text report (reference `ui/reports/text.py:51-511`)."""

    def __init__(self, report: QueryReport) -> None:
        self.report = report
        self._sections: List[Tuple[str, List[str]]] = []

    def build(self) -> str:
        r = self.report
        self._sections = []
        self._add("QUERY", [r.query])
        self._add("ANSWER", [r.answer])
        self._add("CONFIDENCE", [f"{r.confidence:.2f} (retries: {r.retry_count})"])
        if r.effective_queries:
            self._add("EFFECTIVE QUERIES", r.effective_queries)
        if r.docs:
            self._add("SOURCES", [
                f"[{s:.2f}] {getattr(d, 'source', '')}: "
                f"{getattr(d, 'content', '')[:120]!r}"
                for d, s in normalize_scores(r.docs)
            ])
        if r.steps:
            self._add("PIPELINE STEPS", [
                f"{s['name']}: {s['duration_ms']:.0f} ms"
                + ("" if s.get("ok", True) else " FAILED")
                for s in r.steps
            ])
        if r.degraded:
            self._add("DEGRADED", [f"{k}: {v}" for k, v in r.degraded.items()])

        width = 70
        out: List[str] = ["=" * width, "QUERY REPORT".center(width), "=" * width, ""]
        for i, (title, lines) in enumerate(self._sections, start=1):
            out.append(f"{i}. {title}")
            out.append("-" * width)
            out.extend(lines)
            out.append("")
        return "\n".join(out)

    def _add(self, title: str, lines: List[str]) -> None:
        self._sections.append((title, lines))


def save_search_report(query: str, hits: List[Tuple[Any, float]], path: str) -> None:
    """Search-only report (reference `report.py:809-977`)."""
    lines = [f"# Search report", "", f"**Query:** {query}", ""]
    for i, (doc, score) in enumerate(hits, start=1):
        lines.append(f"{i}. [{score:.4f}] **{getattr(doc, 'source', '')}**")
        lines.append(f"   {getattr(doc, 'content', '')[:300]}")
    Path(path).write_text("\n".join(lines))
