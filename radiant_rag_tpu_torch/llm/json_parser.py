"""Robust parsing of JSON out of LLM text.

Capability parity with reference `llm/client.py:59-244` (JSONParser):
markdown-fence and bare-object extraction, trailing-comma/comment cleanup,
truncation repair by closing open brackets, and type validation.

The port's copy of `radiant_rag_tpu/llm/json_parser.py`, unchanged.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Any, Optional, Type

logger = logging.getLogger(__name__)

_FENCE_RE = re.compile(r"```(?:json)?\s*(.*?)```", re.S)
_LINE_COMMENT_RE = re.compile(r"^\s*//.*$", re.M)
_TRAILING_COMMA_RE = re.compile(r",(\s*[}\]])")


class JSONParser:
    """Extract and repair JSON from messy LLM output."""

    @staticmethod
    def extract_candidate(text: str) -> Optional[str]:
        """Find the most likely JSON payload: fenced block, else first
        balanced-looking {...} or [...] region."""
        m = _FENCE_RE.search(text)
        if m:
            return m.group(1).strip()
        # whichever bracket opens FIRST wins (an array of objects must parse
        # as the array, not as its first object)
        candidates = []
        for open_ch, close_ch in (("{", "}"), ("[", "]")):
            start = text.find(open_ch)
            if start >= 0:
                candidates.append((start, open_ch, close_ch))
        if not candidates:
            return None
        start, open_ch, close_ch = min(candidates)
        end = text.rfind(close_ch)
        if end > start:
            return text[start : end + 1]
        return text[start:]  # truncated — repair later

    @staticmethod
    def strip_comments(text: str) -> str:
        """Remove // comments outside of string literals (a bare regex would
        eat URLs like http://)."""
        out = []
        in_string = False
        escape = False
        i = 0
        while i < len(text):
            ch = text[i]
            if escape:
                out.append(ch)
                escape = False
            elif ch == "\\" and in_string:
                out.append(ch)
                escape = True
            elif ch == '"':
                in_string = not in_string
                out.append(ch)
            elif not in_string and ch == "/" and text[i : i + 2] == "//":
                while i < len(text) and text[i] != "\n":
                    i += 1
                continue
            else:
                out.append(ch)
            i += 1
        return "".join(out)

    @classmethod
    def clean(cls, text: str) -> str:
        """Remove // comments and trailing commas."""
        text = cls.strip_comments(text)
        text = _TRAILING_COMMA_RE.sub(r"\1", text)
        return text.strip()

    @staticmethod
    def repair_truncation(text: str) -> str:
        """Close unbalanced brackets/strings from a truncated response
        (reference `client.py:127-187` bracket-stack closing)."""
        stack = []
        in_string = False
        escape = False
        for ch in text:
            if escape:
                escape = False
                continue
            if ch == "\\" and in_string:
                escape = True
                continue
            if ch == '"':
                in_string = not in_string
                continue
            if in_string:
                continue
            if ch in "{[":
                stack.append(ch)
            elif ch in "}]":
                if stack:
                    stack.pop()
        out = text
        if in_string:
            out += '"'
        # drop a dangling comma/colon before closing
        stripped = out.rstrip()
        if stripped.endswith((",", ":")):
            out = stripped[:-1]
        for open_ch in reversed(stack):
            out += "}" if open_ch == "{" else "]"
        return out

    @classmethod
    def parse(cls, text: str, expect: Optional[Type] = None) -> Optional[Any]:
        """Best-effort parse; returns None on failure. `expect` (dict/list)
        validates the top-level type."""
        if not text:
            return None
        candidate = cls.extract_candidate(text)
        if candidate is None:
            return None
        for attempt in (candidate, cls.clean(candidate), cls.repair_truncation(cls.clean(candidate))):
            try:
                value = json.loads(attempt)
            except (json.JSONDecodeError, ValueError):
                continue
            if expect is not None and not isinstance(value, expect):
                continue
            return value
        return None
