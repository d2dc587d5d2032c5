"""Agent registry: name -> registered callable and its metadata, with
lookup by category and tag, `invoke`, a module-global registry and the
`register_agent` decorator.

The port's copy of `radiant_rag_tpu/agents/registry.py`. The orchestrator
wires its agents explicitly; the registry is for tools and diagnostics that
look an agent up by name.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class AgentMetadata:
    name: str
    description: str = ""
    category: str = "utility"
    version: str = "1.0"
    tags: List[str] = field(default_factory=list)


@dataclass
class RegisteredAgent:
    fn: Callable
    metadata: AgentMetadata


class AgentRegistry:
    def __init__(self) -> None:
        self._agents: Dict[str, RegisteredAgent] = {}
        self._lock = threading.Lock()

    def register(self, fn: Callable, name: str, description: str = "",
                 category: str = "utility", version: str = "1.0",
                 tags: Optional[List[str]] = None) -> None:
        with self._lock:
            self._agents[name] = RegisteredAgent(
                fn=fn,
                metadata=AgentMetadata(name=name, description=description,
                                       category=category, version=version,
                                       tags=list(tags or [])),
            )

    def unregister(self, name: str) -> bool:
        with self._lock:
            return self._agents.pop(name, None) is not None

    def get(self, name: str) -> Optional[RegisteredAgent]:
        return self._agents.get(name)

    def invoke(self, name: str, *args: Any, **kwargs: Any) -> Any:
        agent = self.get(name)
        if agent is None:
            raise KeyError(f"agent not registered: {name}")
        return agent.fn(*args, **kwargs)

    def list_agents(self, category: Optional[str] = None) -> List[AgentMetadata]:
        metas = [a.metadata for a in self._agents.values()]
        if category is not None:
            metas = [m for m in metas if m.category == category]
        return sorted(metas, key=lambda m: m.name)

    def find_by_tag(self, tag: str) -> List[AgentMetadata]:
        return [a.metadata for a in self._agents.values() if tag in a.metadata.tags]

    def __contains__(self, name: str) -> bool:
        return name in self._agents

    def __len__(self) -> int:
        return len(self._agents)


_global_registry = AgentRegistry()


def get_global_registry() -> AgentRegistry:
    return _global_registry


def register_agent(name: str, description: str = "", category: str = "utility",
                   version: str = "1.0", tags: Optional[List[str]] = None,
                   registry: Optional[AgentRegistry] = None) -> Callable:
    """Decorator: @register_agent("my-agent", ...) on a callable."""

    def deco(fn: Callable) -> Callable:
        # note: an empty AgentRegistry is falsy (__len__), so test identity
        (_global_registry if registry is None else registry).register(
            fn, name=name, description=description, category=category,
            version=version, tags=tags,
        )
        return fn

    return deco
