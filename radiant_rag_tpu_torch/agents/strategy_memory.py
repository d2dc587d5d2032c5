"""Retrieval strategy memory: learn which retrieval mode works per query pattern.

Capability parity with reference `agents/strategy_memory.py:171-434`: regex
query-pattern classes, `record_outcome` updating per-pattern + global stats
with exponential decay (0.95), `recommend_strategy` returning
(mode, confidence), gzip-JSON persistence.

The port's copy of `radiant_rag_tpu/agents/strategy_memory.py`, unchanged:
either package reads the other's memory file.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import re
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

# Pattern classes (reference has 14 regex classes, `strategy_memory.py:123-138`)
_PATTERNS = [
    ("definition", re.compile(r"^(what (is|are)|define|meaning of)\b", re.I)),
    ("howto", re.compile(r"^how (do|to|can|does)\b", re.I)),
    ("why", re.compile(r"^why\b", re.I)),
    ("who", re.compile(r"^who\b", re.I)),
    ("when", re.compile(r"^when\b", re.I)),
    ("where", re.compile(r"^where\b", re.I)),
    ("comparison", re.compile(r"\b(vs\.?|versus|compare|difference between)\b", re.I)),
    ("list", re.compile(r"^(list|name|enumerate|what are the)\b", re.I)),
    ("yesno", re.compile(r"^(is|are|can|does|do|did|was|were|will|should)\b", re.I)),
    ("numeric", re.compile(r"\b(how (many|much)|percent|number of)\b", re.I)),
    ("code", re.compile(r"\b(code|function|api|error|exception|syntax)\b", re.I)),
    ("temporal", re.compile(r"\b(latest|recent|current|today|news)\b", re.I)),
    ("entity", re.compile(r"\"[^\"]+\"|'[^']+'", re.I)),
    ("keyword", re.compile(r"^\S+(\s+\S+){0,2}$")),  # 1-3 bare terms
]

_MODES = ("hybrid", "dense", "bm25")


class RetrievalStrategyMemory:
    def __init__(self, path: str = "./data/strategy_memory.json.gz",
                 decay: float = 0.95) -> None:
        self.path = path
        self.decay = decay
        self._lock = threading.Lock()
        # stats[pattern][mode] = {"weight": decayed trials, "value": decayed successes}
        self.stats: Dict[str, Dict[str, Dict[str, float]]] = {}
        self._loaded = False

    @staticmethod
    def classify(query: str) -> str:
        for name, rx in _PATTERNS:
            if rx.search(query.strip()):
                return name
        return "other"

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        p = Path(self.path)
        if p.is_file():
            try:
                with gzip.open(p, "rt", encoding="utf-8") as fh:
                    self.stats = json.load(fh)
            except Exception as exc:
                logger.warning("strategy memory load failed: %s", exc)

    def save(self) -> None:
        with self._lock:
            p = Path(self.path)
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = str(p) + ".tmp"
            with gzip.open(tmp, "wt", encoding="utf-8") as fh:
                json.dump(self.stats, fh)
            os.replace(tmp, str(p))

    def record_outcome(self, query: str, mode: str, success: bool,
                       confidence: float = 1.0, persist: bool = True) -> None:
        """Decay-update pattern + global stats (reference `:210-280`)."""
        if mode not in _MODES:
            return
        self._ensure_loaded()
        value = confidence if success else 0.0
        with self._lock:
            for key in (self.classify(query), "__global__"):
                modes = self.stats.setdefault(key, {})
                st = modes.setdefault(mode, {"weight": 0.0, "value": 0.0})
                st["weight"] = st["weight"] * self.decay + 1.0
                st["value"] = st["value"] * self.decay + value
        if persist:
            try:
                self.save()
            except Exception as exc:
                logger.warning("strategy memory save failed: %s", exc)

    def recommend_strategy(self, query: str) -> Tuple[Optional[str], float]:
        """Best mode for the query's pattern; confidence grows with evidence
        (reference `:281-332`)."""
        self._ensure_loaded()
        pattern = self.classify(query)
        modes = self.stats.get(pattern) or self.stats.get("__global__") or {}
        best_mode, best_rate, best_weight = None, -1.0, 0.0
        for mode, st in modes.items():
            w = st.get("weight", 0.0)
            if w < 1e-9:
                continue
            rate = st.get("value", 0.0) / w
            if rate > best_rate:
                best_mode, best_rate, best_weight = mode, rate, w
        if best_mode is None:
            return None, 0.0
        evidence = min(1.0, best_weight / 5.0)  # need ~5 effective trials
        return best_mode, best_rate * evidence

    def get_stats(self) -> Dict:
        self._ensure_loaded()
        return {"patterns": len(self.stats),
                "entries": sum(len(m) for m in self.stats.values())}
