"""Terminal UI: a query input, the live per-phase timeline, and the result
tabs Overview / Plan / Queries / Retrieval / Agents / Metrics / Logs.

The port's copy of `radiant_rag_tpu/ui/tui.py`: three frontends over the
headless view model (ui/tui_model.py):

1. a Textual app when `textual` is installed: tabbed content, the timeline
   refreshed during the run, ctrl+n new conversation, ctrl+s save report,
   escape to clear the input;
2. a rich loop when `rich` is installed: a Live timeline during each
   query, then the Overview tab; `:plan`, `:agents`, `:retrieval`,
   `:queries`, `:metrics`, `:logs` switch tabs, `:save <path>` writes the
   markdown report, `:new` starts a conversation, an empty line exits;
3. a plain input loop otherwise.

One deviation: the Textual app needs a terminal, so with stdin or stdout
not a terminal (a pipe, a script feeding lines) the rich or plain loop
runs; the JAX package starts the Textual app whenever `textual` imports,
which then waits for a terminal that never comes.
"""

from __future__ import annotations

import sys
import threading
import time
import uuid
from typing import Any

from radiant_rag_tpu_torch.ui.tui_model import TAB_NAMES, QuerySession, run_query

try:
    from textual.app import App, ComposeResult
    from textual.binding import Binding
    from textual.containers import VerticalScroll
    from textual.widgets import Footer, Header, Input, Static, TabbedContent, TabPane

    HAVE_TEXTUAL = True
except ImportError:  # pragma: no cover - textual not in this environment
    HAVE_TEXTUAL = False

try:
    from rich.console import Console
    from rich.live import Live
    from rich.panel import Panel

    HAVE_RICH = True
except ImportError:  # pragma: no cover
    HAVE_RICH = False


if HAVE_TEXTUAL:  # pragma: no cover - exercised only where textual exists

    class AgenticRAGApp(App):
        """Query TUI with result tabs (reference `ui/tui.py:285-822`)."""

        CSS = """
        #timeline { height: auto; border: solid $accent; padding: 0 1; }
        TabbedContent { height: 1fr; }
        """
        BINDINGS = [
            Binding("ctrl+q", "quit", "Quit"),
            Binding("ctrl+n", "new_conversation", "New Conv"),
            Binding("ctrl+s", "save_report", "Save Report"),
            Binding("escape", "clear_query", "Clear"),
        ]

        def __init__(self, rag_app: Any) -> None:
            super().__init__()
            self.rag_app = rag_app
            self.session = QuerySession()
            self.conversation_id = uuid.uuid4().hex[:12]

        def compose(self) -> ComposeResult:
            yield Header(show_clock=True)
            yield Input(placeholder="Ask a question…", id="query")
            yield Static("", id="timeline")
            with TabbedContent():
                for name in TAB_NAMES:
                    with TabPane(name.capitalize(), id=f"tab-{name}"):
                        yield VerticalScroll(Static("", id=f"content-{name}"))
            yield Footer()

        def on_mount(self) -> None:
            self.set_interval(0.25, self._refresh_live)

        def _refresh_live(self) -> None:
            if self.session.running:
                self.query_one("#timeline", Static).update(
                    "\n".join(self.session.timeline_lines()))

        def on_input_submitted(self, event: Input.Submitted) -> None:
            query = event.value.strip()
            if not query or self.session.running:
                return

            def work() -> None:
                run_query(self.session, self.rag_app, query, self.conversation_id)
                self.call_from_thread(self._show_result)

            threading.Thread(target=work, daemon=True).start()

        def _show_result(self) -> None:
            self.query_one("#timeline", Static).update(
                "\n".join(self.session.timeline_lines()))
            for name in TAB_NAMES:
                self.query_one(f"#content-{name}", Static).update(
                    self.session.tab(name) if not self.session.error
                    else f"error: {self.session.error}")

        def action_new_conversation(self) -> None:
            self.conversation_id = uuid.uuid4().hex[:12]
            self.notify("new conversation started")

        def action_save_report(self) -> None:
            path = f"report-{int(time.time())}.md"
            with open(path, "w") as fh:
                fh.write(self.session.report_markdown())
            self.notify(f"saved {path}")

        def action_clear_query(self) -> None:
            self.query_one("#query", Input).value = ""


def _run_rich_tui(rag_app: Any) -> None:
    """Interactive rich frontend: live timeline + tab commands."""
    console = Console()
    session = QuerySession()
    conversation_id = uuid.uuid4().hex[:12]
    console.print(Panel(
        "radiant-tpu TUI — type a question; :plan :queries :retrieval "
        ":agents :metrics :logs switch tabs, :save <path> exports a report, "
        ":new starts a conversation, empty line exits.", title="help"))
    while True:
        try:
            line = console.input("[bold cyan]query>[/] ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            break
        if line.startswith(":"):
            cmd, _, arg = line[1:].partition(" ")
            if cmd in TAB_NAMES:
                console.print(Panel(session.tab(cmd) or "(empty)", title=cmd))
            elif cmd == "save":
                path = arg.strip() or f"report-{int(time.time())}.md"
                with open(path, "w") as fh:
                    fh.write(session.report_markdown())
                console.print(f"saved {path}")
            elif cmd == "new":
                conversation_id = uuid.uuid4().hex[:12]
                console.print("new conversation started")
            else:
                console.print(f"unknown command :{cmd} (tabs: {', '.join(TAB_NAMES)})")
            continue

        worker = threading.Thread(
            target=run_query, args=(session, rag_app, line, conversation_id),
            daemon=True)
        worker.start()
        with Live(console=console, refresh_per_second=8) as live:
            while worker.is_alive():
                live.update(Panel("\n".join(session.timeline_lines()) or "…",
                                  title="pipeline"))
                time.sleep(0.12)
            live.update(Panel("\n".join(session.timeline_lines()), title="pipeline"))
        worker.join()
        if session.error:
            console.print(f"[red]error:[/] {session.error}")
        else:
            console.print(Panel(session.tab("overview"), title="answer"))


def run_tui(rag_app: Any) -> None:
    if HAVE_TEXTUAL and sys.stdin.isatty() and sys.stdout.isatty():  # pragma: no cover
        AgenticRAGApp(rag_app).run()
        return
    if HAVE_RICH:
        _run_rich_tui(rag_app)
        return
    # plain fallback loop
    print("(textual/rich not installed — plain interactive mode; empty line exits)")
    from radiant_rag_tpu_torch.ui.display import display_answer

    while True:
        try:
            q = input("query> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not q:
            break
        display_answer(rag_app.query(q))
