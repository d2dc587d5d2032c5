"""Pluggable embedding and reranking backends.

The port's counterpart of `radiant_rag_tpu/llm/model_backends.py`, with
its names and behaviour (the reference's `BaseEmbeddingBackend` /
`BaseRerankingBackend`, its sentence-transformers / OpenAI-compatible /
HF-transformers embedding backends, its LLM-prompted reranker and its
type-dispatched factory):

- `TorchEmbeddingBackend` / `TorchRerankingBackend` over the port's own
  `Embedder` / `CrossEncoder` (the JAX package's `JaxEmbeddingBackend` /
  `JaxRerankingBackend`, also importable under those names);
- `OpenAICompatibleEmbeddingBackend`: POST {base_url}/embeddings;
- `TransformersEmbeddingBackend`: any HF encoder through `transformers`,
  mean or cls pooling, L2 normalization, mini-batches, on the card unless
  the caller passes device="cpu";
- `LLMRerankingBackend`: an LLM scores each document 0-10.

The backend key of the built-in models stays "jax", the JAX package's
default, so configurations parse the same in both packages.
"""

from __future__ import annotations

import abc
import json
import logging
import urllib.request
from typing import List, Optional, Sequence, Tuple

import numpy as np

from radiant_rag_tpu_torch import resolve_device
from radiant_rag_tpu_torch.config import AppConfig

logger = logging.getLogger(__name__)


class BaseEmbeddingBackend(abc.ABC):
    @abc.abstractmethod
    def embed(self, texts: Sequence[str]) -> np.ndarray:
        ...

    def embed_single(self, text: str) -> np.ndarray:
        return self.embed([text])[0]

    @property
    @abc.abstractmethod
    def embedding_dimension(self) -> int:
        ...


class BaseRerankingBackend(abc.ABC):
    @abc.abstractmethod
    def rerank(self, query: str, docs: Sequence[str], top_k: Optional[int] = None,
               max_chars: int = 3000) -> List[Tuple[int, float]]:
        """[(doc_index, score)] sorted by score, highest first."""


class TorchEmbeddingBackend(BaseEmbeddingBackend):
    """The port's bi-encoder (`models/embedder.py`) on its device."""

    def __init__(self, embedder) -> None:
        self.embedder = embedder

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        return self.embedder.embed(texts)

    @property
    def embedding_dimension(self) -> int:
        return self.embedder.embedding_dimension


class OpenAICompatibleEmbeddingBackend(BaseEmbeddingBackend):
    """POST {base_url}/embeddings."""

    def __init__(self, base_url: str, model: str, api_key: str = "unused",
                 dimension: int = 384, timeout_s: float = 60.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self._dim = dimension
        self.timeout_s = timeout_s

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        req = urllib.request.Request(
            f"{self.base_url}/embeddings",
            data=json.dumps({"model": self.model, "input": list(texts)}).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            body = json.loads(resp.read().decode())
        data = sorted(body["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], np.float32)

    @property
    def embedding_dimension(self) -> int:
        return self._dim


class TransformersEmbeddingBackend(BaseEmbeddingBackend):
    """Embeddings from any HF encoder through `transformers`: a lazy load
    from a local directory (or a hub name where the network allows), mean
    or cls pooling, optional L2 normalization, mini-batches. device None
    is the card (`resolve_device`); "cpu" when the caller asks for it.
    `embedding_dimension` is a method here, as in the JAX package."""

    def __init__(self, model_path: str, pooling: str = "mean", normalize: bool = True,
                 batch_size: int = 32, max_seq_len: int = 256, device=None) -> None:
        if pooling not in ("mean", "cls"):
            raise ValueError(f"pooling must be mean|cls, got {pooling!r}")
        self.model_path = model_path
        self.pooling = pooling
        self.normalize = normalize
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        self.device = resolve_device(device)
        self._model = None
        self._tokenizer = None

    def _ensure_loaded(self) -> None:
        if self._model is not None:
            return
        from transformers import AutoModel, AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(self.model_path)
        self._model = AutoModel.from_pretrained(self.model_path).to(self.device).eval()

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        import torch

        self._ensure_loaded()
        outs: List[np.ndarray] = []
        for start in range(0, len(texts), self.batch_size):
            batch = list(texts[start : start + self.batch_size])
            enc = self._tokenizer(batch, padding=True, truncation=True,
                                  max_length=self.max_seq_len, return_tensors="pt")
            enc = {k: v.to(self.device) for k, v in enc.items()}
            with torch.no_grad():
                hidden = self._model(**enc).last_hidden_state  # (B, S, H)
            if self.pooling == "cls":
                emb = hidden[:, 0]
            else:
                m = enc["attention_mask"].unsqueeze(-1).to(hidden.dtype)
                emb = (hidden * m).sum(1) / m.sum(1).clamp(min=1e-9)
            outs.append(emb.cpu().numpy())
        embs = np.concatenate(outs, axis=0) if outs else np.zeros((0, 0), np.float32)
        if self.normalize and embs.size:
            embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        return embs.astype(np.float32)

    def embedding_dimension(self) -> int:
        self._ensure_loaded()
        return int(self._model.config.hidden_size)


class TorchRerankingBackend(BaseRerankingBackend):
    """The port's cross-encoder (`models/cross_encoder.py`) on its device."""

    def __init__(self, cross_encoder) -> None:
        self.cross_encoder = cross_encoder

    def rerank(self, query: str, docs: Sequence[str], top_k: Optional[int] = None,
               max_chars: int = 3000) -> List[Tuple[int, float]]:
        return self.cross_encoder.rerank(query, docs, top_k=top_k, max_chars=max_chars)


# the JAX package's names for the built-in backends
JaxEmbeddingBackend = TorchEmbeddingBackend
JaxRerankingBackend = TorchRerankingBackend


class LLMRerankingBackend(BaseRerankingBackend):
    """Prompt an LLM to score each doc 0-10 (for deployments without a
    cross-encoder)."""

    def __init__(self, llm) -> None:
        self.llm = llm

    def rerank(self, query: str, docs: Sequence[str], top_k: Optional[int] = None,
               max_chars: int = 3000) -> List[Tuple[int, float]]:
        numbered = "\n\n".join(f"[{i+1}] {d[:max_chars]}" for i, d in enumerate(docs))
        arr = self.llm.chat_json([{
            "role": "user",
            "content": (
                "Score each document's relevance to the query from 0 to 10. "
                f"Return ONLY a JSON array of {len(docs)} numbers, in order.\n\n"
                f"Query: {query}\n\nDocuments:\n{numbered}"
            ),
        }], expect=list)
        scores = []
        for i in range(len(docs)):
            try:
                scores.append(float(arr[i]) if arr and i < len(arr) else 0.0)
            except (TypeError, ValueError):
                scores.append(0.0)
        order = sorted(range(len(docs)), key=lambda i: -scores[i])
        if top_k is not None:
            order = order[:top_k]
        return [(i, scores[i]) for i in order]


def create_embedding_backend(config: AppConfig, embedder=None,
                             device=None) -> BaseEmbeddingBackend:
    """embedding.backend: "jax" (the built-in encoder, the default) |
    "openai_compatible" | "transformers". `device` places the built-in
    encoder and the transformers model (None: the card)."""
    kind = getattr(config.embedding, "backend", "jax") or "jax"
    if kind == "openai_compatible":
        return OpenAICompatibleEmbeddingBackend(
            base_url=config.llm.base_url, model=config.embedding.model_name,
            api_key=config.llm.api_key, dimension=config.embedding.dim)
    if kind == "transformers":
        return TransformersEmbeddingBackend(
            model_path=config.embedding.weights_path or config.embedding.model_name,
            batch_size=config.embedding.batch_size, max_seq_len=config.embedding.max_seq_len,
            normalize=config.embedding.normalize, device=device)
    if embedder is None:
        from radiant_rag_tpu_torch.models.embedder import Embedder

        embedder = Embedder(config.embedding, device=device)
    return TorchEmbeddingBackend(embedder)


def create_reranking_backend(config: AppConfig, cross_encoder=None, llm=None,
                             device=None) -> BaseRerankingBackend:
    """cross_encoder.backend: "jax" (the built-in cross-encoder, the
    default) | "llm" (needs an LLM client)."""
    kind = getattr(config.cross_encoder, "backend", "jax") or "jax"
    if kind == "llm":
        if llm is None:
            raise ValueError("llm reranking backend requires an LLM client")
        return LLMRerankingBackend(llm)
    if cross_encoder is None:
        from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder

        cross_encoder = CrossEncoder(config.cross_encoder, device=device)
    return TorchRerankingBackend(cross_encoder)
