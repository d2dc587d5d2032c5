"""LLM backends: OpenAI-compatible HTTP + deterministic mock.

Capability parity with reference `llm/backends/base.py:31` (BaseLLMBackend)
and `llm/backends/llm_backends.py:27` (OpenAI-compatible, serving
ollama/vLLM/OpenAI endpoints). Implemented over urllib so no SDK is required;
zero-egress environments use the mock backend (also the test fixture,
replacing the reference's MagicMock LLMs, SURVEY.md §4).

The port's copy of `radiant_rag_tpu/llm/backends.py`. `backend: local`
(in-process causal-LM generation) raises: it waits for causal-LM weights
in the repository (ROADMAP queue A item 11, rest).
"""

from __future__ import annotations

import abc
import json
import logging
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence

from radiant_rag_tpu_torch.config import LLMConfig

logger = logging.getLogger(__name__)

Message = Dict[str, str]  # {"role": ..., "content": ...}

LOCAL_BACKEND_NOT_PORTED = (
    "llm.backend 'local' (in-process causal-LM generation) waits for causal-LM weights in "
    "the repository: ROADMAP queue A item 11 (rest); use 'openai_compatible' or 'mock'")


class LLMError(Exception):
    def __init__(self, message: str, status: Optional[int] = None) -> None:
        super().__init__(message)
        self.status = status

    @property
    def retryable(self) -> bool:
        """4xx (except 408/429) are permanent (reference `client.py:41-56`)."""
        if self.status is None:
            return True
        if self.status in (408, 429):
            return True
        return not (400 <= self.status < 500)


class BaseLLMBackend(abc.ABC):
    @abc.abstractmethod
    def chat(self, messages: Sequence[Message], temperature: float = 0.2,
             max_tokens: int = 2048) -> str:
        ...

    def chat_stream(self, messages: Sequence[Message], temperature: float = 0.2,
                    max_tokens: int = 2048):
        """Yield response text chunks. Default: non-streaming fallback that
        yields the full chat() response once — backends override with true
        token streaming."""
        yield self.chat(messages, temperature=temperature, max_tokens=max_tokens)

    def generate(self, prompt: str, **kwargs: Any) -> str:
        return self.chat([{"role": "user", "content": prompt}], **kwargs)

    def ping(self) -> bool:
        try:
            self.chat([{"role": "user", "content": "ping"}], max_tokens=4)
            return True
        except Exception:
            return False


class OpenAICompatibleLLMBackend(BaseLLMBackend):
    """POST {base_url}/chat/completions — serves OpenAI, vLLM, and ollama."""

    def __init__(self, config: LLMConfig) -> None:
        self.config = config

    def chat(self, messages: Sequence[Message], temperature: float = 0.2,
             max_tokens: int = 2048) -> str:
        cfg = self.config
        url = cfg.base_url.rstrip("/") + "/chat/completions"
        payload = {
            "model": cfg.model,
            "messages": list(messages),
            "temperature": temperature,
            "max_tokens": max_tokens,
        }
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode("utf-8"),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {cfg.api_key}",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=cfg.timeout_s) as resp:
                body = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as exc:
            raise LLMError(f"LLM HTTP {exc.code}: {exc.reason}", status=exc.code) from exc
        except Exception as exc:
            raise LLMError(f"LLM request failed: {exc}") from exc
        try:
            return body["choices"][0]["message"]["content"]
        except (KeyError, IndexError) as exc:
            raise LLMError(f"malformed LLM response: {body}") from exc

    def chat_stream(self, messages: Sequence[Message], temperature: float = 0.2,
                    max_tokens: int = 2048):
        """SSE token stream (`"stream": true` — same wire format for OpenAI,
        vLLM, and ollama's OpenAI-compatible endpoint)."""
        cfg = self.config
        url = cfg.base_url.rstrip("/") + "/chat/completions"
        payload = {
            "model": cfg.model,
            "messages": list(messages),
            "temperature": temperature,
            "max_tokens": max_tokens,
            "stream": True,
        }
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode("utf-8"),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {cfg.api_key}",
            },
        )
        try:
            resp = urllib.request.urlopen(req, timeout=cfg.timeout_s)
        except urllib.error.HTTPError as exc:
            raise LLMError(f"LLM HTTP {exc.code}: {exc.reason}", status=exc.code) from exc
        except Exception as exc:
            raise LLMError(f"LLM request failed: {exc}") from exc
        with resp:
            for raw in resp:
                line = raw.decode("utf-8", errors="replace").strip()
                if not line.startswith("data:"):
                    continue
                data = line[len("data:"):].strip()
                if data == "[DONE]":
                    return
                try:
                    chunk = json.loads(data)
                    delta = chunk["choices"][0].get("delta", {})
                except (json.JSONDecodeError, KeyError, IndexError):
                    continue  # keep-alives / malformed chunks are skipped
                piece = delta.get("content")
                if piece:
                    yield piece


class MockLLMBackend(BaseLLMBackend):
    """Deterministic scripted backend for tests and offline runs.

    `script` maps a substring of the last user message to a response (first
    match wins, insertion order); `default` answers everything else. A
    `responder` callable takes full control when provided."""

    def __init__(
        self,
        script: Optional[Dict[str, str]] = None,
        default: str = "ok",
        responder: Optional[Callable[[Sequence[Message]], str]] = None,
    ) -> None:
        self.script = dict(script or {})
        self.default = default
        self.responder = responder
        self.calls: List[List[Message]] = []

    def chat(self, messages: Sequence[Message], temperature: float = 0.2,
             max_tokens: int = 2048) -> str:
        self.calls.append(list(messages))
        if self.responder is not None:
            return self.responder(messages)
        last_user = next((m["content"] for m in reversed(messages) if m["role"] == "user"), "")
        for key, resp in self.script.items():
            if key in last_user:
                return resp
        return self.default

    def chat_stream(self, messages: Sequence[Message], temperature: float = 0.2,
                    max_tokens: int = 2048):
        """Stream the scripted response word-by-word (tests the token path)."""
        text = self.chat(messages, temperature=temperature, max_tokens=max_tokens)
        words = text.split(" ")
        for i, w in enumerate(words):
            yield w if i == len(words) - 1 else w + " "

    @property
    def call_count(self) -> int:
        return len(self.calls)


def create_llm_backend(config: LLMConfig) -> BaseLLMBackend:
    """Factory (reference `llm/backends/factory.py:38`)."""
    if config.backend == "openai_compatible":
        return OpenAICompatibleLLMBackend(config)
    if config.backend == "local":
        raise NotImplementedError(LOCAL_BACKEND_NOT_PORTED)
    if config.backend == "mock":
        return MockLLMBackend()
    raise ValueError(f"unknown llm backend: {config.backend!r}")
