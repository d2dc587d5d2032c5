"""Console display helpers.

The port's copy of `radiant_rag_tpu/ui/display.py`: rendered with `rich`
when it is importable, plain text otherwise; the display layer is never a
hard dependency of the pipeline. The CLI's `query`, `search`, `stats`,
`health`, `interactive` and the plain TUI print through it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

try:
    from rich.console import Console
    from rich.panel import Panel
    from rich.table import Table

    _console: Any = Console()
    HAVE_RICH = True
except ImportError:  # pragma: no cover
    _console = None
    HAVE_RICH = False


def display_answer(result) -> None:
    """Render a PipelineResult (reference `display.py:58-543`)."""
    if HAVE_RICH:
        _console.print(Panel(result.answer or "(no answer)", title="Answer",
                             subtitle=f"confidence {result.confidence:.2f}"))
        if result.docs:
            table = Table(title="Context documents")
            table.add_column("#", width=3)
            table.add_column("score", width=7)
            table.add_column("source")
            table.add_column("preview")
            for i, (doc, score) in enumerate(result.docs[:8], start=1):
                table.add_row(str(i), f"{score:.3f}", doc.source[:40],
                              doc.content[:70].replace("\n", " "))
            _console.print(table)
        if result.degraded:
            _console.print(f"[yellow]degraded: {result.degraded}[/yellow]")
        steps = result.metrics.get("steps", [])
        if steps:
            timeline = ", ".join(f"{s['name']} {s['duration_ms']:.0f}ms" for s in steps)
            _console.print(f"[dim]{timeline}[/dim]")
    else:
        print("=== Answer ===")
        print(result.answer)
        print(f"(confidence {result.confidence:.2f}, {len(result.docs)} docs)")


def display_search_results(query: str, hits: List[Tuple[Any, float]]) -> None:
    if HAVE_RICH:
        table = Table(title=f"Search: {query}")
        table.add_column("#", width=3)
        table.add_column("score", width=8)
        table.add_column("source")
        table.add_column("content")
        for i, (doc, score) in enumerate(hits, start=1):
            table.add_row(str(i), f"{score:.4f}", doc.source[:40],
                          doc.content[:80].replace("\n", " "))
        _console.print(table)
    else:
        for i, (doc, score) in enumerate(hits, start=1):
            print(f"{i:2d}. [{score:.4f}] {doc.source}: {doc.content[:80]!r}")


def display_stats(stats: Dict[str, Any]) -> None:
    if HAVE_RICH:
        _console.print_json(json.dumps(stats, default=str))
    else:
        print(json.dumps(stats, indent=2, default=str))


def display_health(health: Dict[str, Any]) -> None:
    for key, ok in health.items():
        mark = "✓" if ok else "✗"
        if HAVE_RICH:
            color = "green" if ok else "red"
            _console.print(f"[{color}]{mark}[/{color}] {key}")
        else:
            print(f"{mark} {key}")


class ProgressDisplay:
    """Spinner/progress wrapper (reference `display.py` ProgressDisplay)."""

    def __init__(self, description: str = "working") -> None:
        self.description = description
        self._status = None

    def __enter__(self):
        if HAVE_RICH:
            self._status = _console.status(self.description)
            self._status.__enter__()
        else:
            print(f"{self.description}...")
        return self

    def __exit__(self, *exc) -> None:
        if self._status is not None:
            self._status.__exit__(*exc)

    def update(self, message: str) -> None:
        if self._status is not None:
            self._status.update(message)
