"""Structured-JSON ingestion with strategy auto-detection.

The port's copy of `radiant_rag_tpu/ingestion/json_parser.py`, unchanged.
Capability parity with reference `ingestion/json_parser.py:80-590`: strategy
auto-detect over flatten/records/semantic/logs (`:222-270`), JSONL batching,
and field-priority semantic extraction.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Iterator, List, Tuple

logger = logging.getLogger(__name__)

_SEMANTIC_FIELDS = ("title", "name", "summary", "description", "content", "text",
                    "body", "abstract", "message", "question", "answer")
_LOG_FIELDS = {"timestamp", "level", "message", "ts", "time", "severity"}


class StructuredJSONParser:
    def __init__(self, records_per_chunk: int = 20, max_chunk_chars: int = 4000) -> None:
        self.records_per_chunk = records_per_chunk
        self.max_chunk_chars = max_chunk_chars

    # -- strategy ----------------------------------------------------------
    @staticmethod
    def detect_strategy(data: Any) -> str:
        """flatten | records | semantic | logs (reference `:222-270`)."""
        if isinstance(data, list) and data and isinstance(data[0], dict):
            keys = set(data[0].keys())
            if keys & _LOG_FIELDS and len(keys & _LOG_FIELDS) >= 2:
                return "logs"
            if any(k in keys for k in _SEMANTIC_FIELDS):
                return "semantic"
            return "records"
        if isinstance(data, dict):
            if any(k in data for k in _SEMANTIC_FIELDS):
                return "semantic"
            return "flatten"
        return "flatten"

    # -- strategies --------------------------------------------------------
    def _flatten(self, data: Any, prefix: str = "") -> Iterator[str]:
        if isinstance(data, dict):
            for k, v in data.items():
                yield from self._flatten(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(data, list):
            for i, v in enumerate(data):
                yield from self._flatten(v, f"{prefix}[{i}]")
        else:
            yield f"{prefix}: {data}"

    def _semantic_text(self, record: Dict[str, Any]) -> str:
        parts = []
        for field in _SEMANTIC_FIELDS:
            if field in record and record[field]:
                parts.append(f"{field}: {record[field]}")
        others = {k: v for k, v in record.items()
                  if k not in _SEMANTIC_FIELDS and not isinstance(v, (dict, list))}
        if others:
            parts.append("; ".join(f"{k}={v}" for k, v in others.items()))
        return "\n".join(parts)

    # -- entry -------------------------------------------------------------
    def parse(self, data: Any) -> List[Tuple[str, Dict[str, Any]]]:
        strategy = self.detect_strategy(data)
        out: List[Tuple[str, Dict[str, Any]]] = []
        if strategy == "flatten":
            lines = list(self._flatten(data))
            for i in range(0, len(lines), 100):
                text = "\n".join(lines[i : i + 100])[: self.max_chunk_chars]
                out.append((text, {"json_strategy": "flatten"}))
        elif strategy in ("records", "logs"):
            records = data if isinstance(data, list) else [data]
            for i in range(0, len(records), self.records_per_chunk):
                block = records[i : i + self.records_per_chunk]
                text = "\n".join(json.dumps(r, default=str)[:500] for r in block)
                out.append((text, {"json_strategy": strategy,
                                   "records": f"{i}-{i+len(block)-1}"}))
        else:  # semantic
            records = data if isinstance(data, list) else [data]
            for i, rec in enumerate(records):
                if not isinstance(rec, dict):
                    continue
                text = self._semantic_text(rec)
                if text.strip():
                    out.append((text[: self.max_chunk_chars],
                                {"json_strategy": "semantic", "record": i}))
        return out

    def parse_file(self, path: str) -> List[Tuple[str, Dict[str, Any]]]:
        p = Path(path)
        try:
            raw = p.read_text(errors="replace")
        except Exception as exc:
            logger.warning("cannot read %s: %s", path, exc)
            return []
        if p.suffix.lower() == ".jsonl" or "\n{" in raw.strip():
            records = []
            for line in raw.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
            if records:
                return self.parse(records)
        try:
            return self.parse(json.loads(raw))
        except json.JSONDecodeError as exc:
            logger.warning("invalid JSON in %s: %s", path, exc)
            return []
