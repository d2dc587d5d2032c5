"""Logging setup with ANSI colors, and the agents' correlation-id logger.

The port's copy of `setup_logging`, `ColorFormatter` and `StructuredLogger`
from `radiant_rag_tpu/utils/logging.py`: a stderr handler (colored when the
terminal allows it: no NO_COLOR, a TTY, TERM not "dumb"), an optional file
handler, the chatty third-party loggers held at WARNING, and a logger that
prefixes a run's correlation id to every agent log line.
"""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    "DEBUG": "\x1b[36m",
    "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m",
    "CRITICAL": "\x1b[35m",
}
_RESET = "\x1b[0m"

_NOISY_LOGGERS = ("urllib3", "requests", "httpx", "filelock", "transformers")


class ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool) -> None:
        super().__init__("%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if self.use_color:
            color = _COLORS.get(record.levelname)
            if color:
                msg = f"{color}{msg}{_RESET}"
        return msg


def _color_allowed() -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    if os.environ.get("TERM", "") == "dumb":
        return False
    return sys.stderr.isatty()


def setup_logging(level: str = "INFO", file: str = "", color: bool = True) -> None:
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()

    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(ColorFormatter(color and _color_allowed()))
    root.addHandler(sh)

    if file:
        fh = logging.FileHandler(file)
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(fh)

    for name in _NOISY_LOGGERS:
        logging.getLogger(name).setLevel(logging.WARNING)


class StructuredLogger:
    """Logger adapter that prefixes a correlation id to every line."""

    def __init__(self, name: str, correlation_id: str = "") -> None:
        self._logger = logging.getLogger(name)
        self.correlation_id = correlation_id

    def _fmt(self, msg: str) -> str:
        return f"[{self.correlation_id}] {msg}" if self.correlation_id else msg

    def debug(self, msg: str, *args) -> None:
        self._logger.debug(self._fmt(msg), *args)

    def info(self, msg: str, *args) -> None:
        self._logger.info(self._fmt(msg), *args)

    def warning(self, msg: str, *args) -> None:
        self._logger.warning(self._fmt(msg), *args)

    def error(self, msg: str, *args) -> None:
        self._logger.error(self._fmt(msg), *args)
