"""Conversation state: turns, persistence with TTL, synthesis history.

Capability parity with reference `utils/conversation.py:24-560`
(`ConversationTurn`/`Conversation`, a TTL'd `ConversationStore`, and
`ConversationManager.start/load/add_turn/get_history_for_synthesis`). The
reference stores conversations in Redis with TTL 86400s
(`conversation.py:151-351`); this framework is standalone, so the store is
local JSON files with the same TTL semantics (expired conversations are
dropped at load).

The port's copy of `radiant_rag_tpu/utils/conversation.py`, unchanged:
either package reads the other's conversation files.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class ConversationTurn:
    query: str
    answer: str
    timestamp: float = field(default_factory=time.time)
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"query": self.query, "answer": self.answer,
                "timestamp": self.timestamp, "meta": self.meta}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ConversationTurn":
        return cls(query=d.get("query", ""), answer=d.get("answer", ""),
                   timestamp=float(d.get("timestamp", 0.0)), meta=d.get("meta") or {})


@dataclass
class Conversation:
    conversation_id: str
    turns: List[ConversationTurn] = field(default_factory=list)
    created: float = field(default_factory=time.time)
    updated: float = field(default_factory=time.time)

    def add_turn(self, query: str, answer: str, **meta: Any) -> None:
        self.turns.append(ConversationTurn(query=query, answer=answer, meta=meta))
        self.updated = time.time()

    def to_dict(self) -> Dict[str, Any]:
        return {"conversation_id": self.conversation_id, "created": self.created,
                "updated": self.updated, "turns": [t.to_dict() for t in self.turns]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Conversation":
        return cls(
            conversation_id=d["conversation_id"],
            turns=[ConversationTurn.from_dict(t) for t in d.get("turns", [])],
            created=float(d.get("created", 0.0)),
            updated=float(d.get("updated", 0.0)),
        )


class ConversationStore:
    """File-backed store with TTL and an index of ids."""

    def __init__(self, data_dir: str = "./data/conversations", ttl_s: float = 86400.0) -> None:
        self.dir = Path(data_dir)
        self.ttl_s = ttl_s

    def _path(self, conversation_id: str) -> Path:
        safe = "".join(c for c in conversation_id if c.isalnum() or c in "-_")
        return self.dir / f"{safe}.json"

    def save(self, conv: Conversation) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = str(self._path(conv.conversation_id)) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(conv.to_dict(), fh)
        os.replace(tmp, self._path(conv.conversation_id))

    def load(self, conversation_id: str) -> Optional[Conversation]:
        p = self._path(conversation_id)
        if not p.is_file():
            return None
        try:
            with open(p) as fh:
                conv = Conversation.from_dict(json.load(fh))
        except Exception as exc:
            logger.warning("failed to load conversation %s: %s", conversation_id, exc)
            return None
        if time.time() - conv.updated > self.ttl_s:
            p.unlink(missing_ok=True)
            return None
        return conv

    def delete(self, conversation_id: str) -> bool:
        p = self._path(conversation_id)
        if p.is_file():
            p.unlink()
            return True
        return False

    def list_ids(self) -> List[str]:
        if not self.dir.is_dir():
            return []
        now = time.time()
        ids = []
        for p in self.dir.glob("*.json"):
            try:
                with open(p) as fh:
                    d = json.load(fh)
                if now - float(d.get("updated", 0)) <= self.ttl_s:
                    ids.append(d["conversation_id"])
            except Exception:
                continue
        return sorted(ids)


class ConversationManager:
    def __init__(self, store: Optional[ConversationStore] = None,
                 max_turns: int = 20, data_dir: str = "./data/conversations",
                 ttl_s: float = 86400.0) -> None:
        self.store = store or ConversationStore(data_dir, ttl_s)
        self.max_turns = max_turns
        self._active: Dict[str, Conversation] = {}

    def start_conversation(self, conversation_id: str = "") -> str:
        cid = conversation_id or uuid.uuid4().hex[:16]
        conv = Conversation(conversation_id=cid)
        self._active[cid] = conv
        self.store.save(conv)
        return cid

    def get(self, conversation_id: str) -> Optional[Conversation]:
        conv = self._active.get(conversation_id)
        if conv is None:
            conv = self.store.load(conversation_id)
            if conv is not None:
                self._active[conversation_id] = conv
        return conv

    def add_turn(self, conversation_id: str, query: str, answer: str, **meta: Any) -> None:
        conv = self.get(conversation_id)
        if conv is None:
            conv = Conversation(conversation_id=conversation_id)
            self._active[conversation_id] = conv
        conv.add_turn(query, answer, **meta)
        if len(conv.turns) > self.max_turns:
            conv.turns = conv.turns[-self.max_turns :]
        self.store.save(conv)

    def get_history_for_synthesis(self, conversation_id: str,
                                  max_turns: int = 3) -> List[Dict[str, str]]:
        """Recent turns as chat messages (reference `conversation.py:353-560`)."""
        conv = self.get(conversation_id)
        if conv is None:
            return []
        out: List[Dict[str, str]] = []
        for turn in conv.turns[-max_turns:]:
            out.append({"role": "user", "content": turn.query})
            out.append({"role": "assistant", "content": turn.answer})
        return out
