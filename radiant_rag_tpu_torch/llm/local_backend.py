"""Local in-process generation backend (HF transformers).

The port's counterpart of `radiant_rag_tpu/llm/local_backend.py`, with its
names and behaviour: the generator model runs inside the process instead
of over HTTP (the reference's LocalHuggingFaceLLMBackend).

- Lazy, locked load on the first chat: the app can be configured with
  `llm.backend: local` without paying the model load at construction.
- Token streaming through transformers' TextIteratorStreamer, with
  `generate` on a worker thread.
- temperature 0 is greedy decoding (do_sample=False), the deterministic
  contract the agents' JSON prompts rely on.
- A missing package or bad model files raise `LLMError(status=400)`, a
  permanent error, so the client's degradation path engages instead of
  a retry loop.

The device is `llm.device`: "cuda" by default (the card), "cpu" when the
configuration asks for it, "auto" leaves the model where `from_pretrained`
put it, as in the JAX package. float16 on any device but the CPU, as the
JAX package chooses. A CUDA device that is missing is an error, never a
move to the CPU.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence

from radiant_rag_tpu_torch import resolve_device
from radiant_rag_tpu_torch.config import LLMConfig
from radiant_rag_tpu_torch.llm.backends import BaseLLMBackend, LLMError, Message

logger = logging.getLogger(__name__)


def from_pretrained_dtype(dtype) -> Dict[str, Any]:
    """`from_pretrained`'s dtype argument: `dtype` from transformers 4.56 on
    (5.x deprecates `torch_dtype`), `torch_dtype` before."""
    import transformers

    major, minor = (int(x) for x in transformers.__version__.split(".")[:2])
    return {"dtype": dtype} if (major, minor) >= (4, 56) else {"torch_dtype": dtype}


def _format_messages(messages: Sequence[Message]) -> str:
    """Role-tagged prompt for tokenizers without a chat template."""
    parts: List[str] = []
    for m in messages:
        role = m.get("role", "user")
        tag = {"system": "System", "assistant": "Assistant"}.get(role, "User")
        parts.append(f"{tag}: {m.get('content', '')}")
    parts.append("Assistant:")
    return "\n\n".join(parts)


class LocalTransformersLLMBackend(BaseLLMBackend):
    """In-process causal-LM generation over HF transformers.

    `model` may be a local directory or a hub name (a hub name needs
    network access). A pre-built (model, tokenizer) pair skips the load."""

    def __init__(self, config: LLMConfig, model: Optional[Any] = None,
                 tokenizer: Optional[Any] = None) -> None:
        self.config = config
        self._model = model
        self._tokenizer = tokenizer
        self._load_lock = threading.Lock()

    def _ensure_loaded(self) -> None:
        if self._model is not None and self._tokenizer is not None:
            return
        with self._load_lock:
            if self._model is not None and self._tokenizer is not None:
                return
            path = self.config.model_path or self.config.model
            device = self.config.device
            try:
                import torch
                from transformers import AutoModelForCausalLM, AutoTokenizer
            except ImportError as exc:
                raise LLMError("llm.backend 'local' needs the transformers package installed",
                               status=400) from exc
            logger.info("loading local generator model from %s onto %s", path, device)
            try:
                tokenizer = AutoTokenizer.from_pretrained(path)
                dtype = torch.float32 if device == "cpu" else torch.float16
                model = AutoModelForCausalLM.from_pretrained(path, **from_pretrained_dtype(dtype))
                if device != "auto":
                    model = model.to(resolve_device(device))
                model.eval()
            except Exception as exc:
                # missing or corrupt files, or no such device: permanent
                raise LLMError(f"failed to load local model {path!r} onto {device!r}: {exc}",
                               status=400) from exc
            self._tokenizer = tokenizer
            self._model = model

    def _build_prompt(self, messages: Sequence[Message]) -> str:
        tok = self._tokenizer
        if getattr(tok, "chat_template", None):
            try:
                return tok.apply_chat_template(list(messages), tokenize=False,
                                               add_generation_prompt=True)
            except Exception as exc:
                logger.warning("chat template failed (%s); role-tag fallback", exc)
        return _format_messages(messages)

    def _generate(self, messages: Sequence[Message], temperature: float, max_tokens: int,
                  streamer=None) -> str:
        import torch

        prompt = self._build_prompt(messages)
        inputs = self._tokenizer(prompt, return_tensors="pt")
        inputs = {k: v.to(self._model.device) for k, v in inputs.items()}
        tok = self._tokenizer
        kwargs: Dict[str, Any] = dict(
            max_new_tokens=max_tokens,
            pad_token_id=tok.pad_token_id if tok.pad_token_id is not None else tok.eos_token_id)
        if temperature and temperature > 0:
            kwargs.update(do_sample=True, temperature=float(temperature))
        else:
            kwargs.update(do_sample=False)
        if streamer is not None:
            kwargs["streamer"] = streamer
        with torch.no_grad():
            out = self._model.generate(**inputs, **kwargs)
        new_tokens = out[0][inputs["input_ids"].shape[1]:]
        return self._tokenizer.decode(new_tokens, skip_special_tokens=True)

    def chat(self, messages: Sequence[Message], temperature: float = 0.2,
             max_tokens: int = 2048) -> str:
        self._ensure_loaded()
        try:
            return self._generate(messages, temperature, max_tokens)
        except LLMError:
            raise
        except Exception as exc:
            raise LLMError(f"local generation failed: {exc}", status=500) from exc

    def chat_stream(self, messages: Sequence[Message], temperature: float = 0.2,
                    max_tokens: int = 2048):
        """Token streaming: generate() runs on a worker thread and pushes
        decoded spans through a TextIteratorStreamer; this generator yields
        them as they arrive, then raises the worker's error, if any."""
        self._ensure_loaded()
        from transformers import TextIteratorStreamer

        streamer = TextIteratorStreamer(self._tokenizer, skip_prompt=True,
                                        skip_special_tokens=True)
        errors: List[Exception] = []

        def run() -> None:
            try:
                self._generate(messages, temperature, max_tokens, streamer=streamer)
            except Exception as exc:  # surfaced after the stream drains
                errors.append(exc)
                streamer.end()

        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        for span in streamer:
            if span:
                yield span
        worker.join()
        if errors:
            raise LLMError(f"local streaming generation failed: {errors[0]}",
                           status=500) from errors[0]
