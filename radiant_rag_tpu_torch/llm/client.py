"""LLMClient: retrying chat + schema-clarified JSON chat.

Capability parity with reference `llm/client.py:259-477`: linear-backoff
retries skipping non-retryable 4xx (`client.py:311-391`), and `chat_json`
re-prompting with a clarification turn when the response fails to parse
(`client.py:393-477`).

The port's copy of `radiant_rag_tpu/llm/client.py`, unchanged.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Type

from radiant_rag_tpu_torch.config import LLMConfig
from radiant_rag_tpu_torch.llm.backends import BaseLLMBackend, LLMError, Message, create_llm_backend
from radiant_rag_tpu_torch.llm.json_parser import JSONParser

logger = logging.getLogger(__name__)


class LLMClient:
    def __init__(self, config: Optional[LLMConfig] = None,
                 backend: Optional[BaseLLMBackend] = None) -> None:
        self.config = config or LLMConfig()
        self.backend = backend or create_llm_backend(self.config)
        self.call_count = 0
        self.error_count = 0

    def chat(self, messages: Sequence[Message], temperature: Optional[float] = None,
             max_tokens: Optional[int] = None) -> str:
        cfg = self.config
        temperature = cfg.temperature if temperature is None else temperature
        max_tokens = cfg.max_tokens if max_tokens is None else max_tokens
        last_exc: Optional[Exception] = None
        for attempt in range(cfg.max_retries + 1):
            try:
                self.call_count += 1
                return self.backend.chat(messages, temperature=temperature, max_tokens=max_tokens)
            except LLMError as exc:
                self.error_count += 1
                last_exc = exc
                if not exc.retryable:
                    logger.warning("non-retryable LLM error: %s", exc)
                    raise
                if attempt < cfg.max_retries:
                    delay = cfg.retry_backoff_s * (attempt + 1)  # linear backoff
                    logger.warning("LLM error (attempt %d/%d), retrying in %.1fs: %s",
                                   attempt + 1, cfg.max_retries, delay, exc)
                    time.sleep(delay)
        raise last_exc  # type: ignore[misc]

    def chat_stream(self, messages: Sequence[Message],
                    on_token: Optional[Any] = None,
                    temperature: Optional[float] = None,
                    max_tokens: Optional[int] = None) -> str:
        """Streamed chat: `on_token(chunk)` fires per text chunk; returns the
        full concatenated response. Retries apply only before the first chunk
        arrives (a mid-stream failure would duplicate emitted tokens)."""
        cfg = self.config
        temperature = cfg.temperature if temperature is None else temperature
        max_tokens = cfg.max_tokens if max_tokens is None else max_tokens
        last_exc: Optional[Exception] = None
        for attempt in range(cfg.max_retries + 1):
            parts: List[str] = []
            try:
                self.call_count += 1
                for chunk in self.backend.chat_stream(
                        messages, temperature=temperature, max_tokens=max_tokens):
                    parts.append(chunk)
                    if on_token is not None:
                        try:
                            on_token(chunk)
                        except Exception:
                            logger.debug("token sink failed", exc_info=True)
                return "".join(parts)
            except LLMError as exc:
                self.error_count += 1
                last_exc = exc
                if parts or not exc.retryable:
                    raise  # tokens already emitted, or permanent error
                if attempt < cfg.max_retries:
                    delay = cfg.retry_backoff_s * (attempt + 1)
                    logger.warning("LLM stream error (attempt %d/%d), retrying in "
                                   "%.1fs: %s", attempt + 1, cfg.max_retries, delay, exc)
                    time.sleep(delay)
        raise last_exc  # type: ignore[misc]

    def generate(self, prompt: str, system: Optional[str] = None, **kwargs: Any) -> str:
        messages: List[Message] = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        return self.chat(messages, **kwargs)

    def chat_json(
        self,
        messages: Sequence[Message],
        expect: Type = dict,
        max_parse_retries: int = 2,
        **kwargs: Any,
    ) -> Optional[Any]:
        """Chat and parse JSON; on parse failure, append the bad answer and a
        clarification request, then retry (reference `client.py:432-468`)."""
        convo: List[Message] = list(messages)
        for attempt in range(max_parse_retries + 1):
            text = self.chat(convo, **kwargs)
            value = JSONParser.parse(text, expect=expect)
            if value is not None:
                return value
            if attempt < max_parse_retries:
                convo = convo + [
                    {"role": "assistant", "content": text[:2000]},
                    {"role": "user", "content":
                        "That was not valid JSON. Respond with ONLY the JSON "
                        f"{'object' if expect is dict else 'array'}, no prose, no markdown."},
                ]
                logger.debug("chat_json parse failure, clarifying (attempt %d)", attempt + 1)
        logger.warning("chat_json failed to produce parseable JSON after retries")
        return None

    def stats(self) -> Dict[str, int]:
        return {"calls": self.call_count, "errors": self.error_count}
