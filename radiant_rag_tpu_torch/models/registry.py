"""LocalNLPModels: the embed / rerank facade the retrieval layers call.

Counterpart of `radiant_rag_tpu/models/registry.py` (`embed`,
`embed_single`, `embed_device`, `rerank`, a lazy cross-encoder), over the
port's Embedder and CrossEncoder on one device.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from radiant_rag_tpu_torch import resolve_device
from radiant_rag_tpu_torch.config import AppConfig
from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
from radiant_rag_tpu_torch.models.embedder import Embedder
from radiant_rag_tpu_torch.utils.cache import EmbeddingCache

logger = logging.getLogger(__name__)


def warn_unserved_backends(cfg: AppConfig) -> None:
    """embedding.backend and cross_encoder.backend take effect only through
    `llm.model_backends`' factories; the app serves the built-in encoders
    whatever they say, as the JAX package's app does. Say so where a config
    names another backend."""
    for section in ("embedding", "cross_encoder"):
        backend = getattr(cfg, section).backend
        if backend != "jax":
            logger.warning("%s.backend %r takes effect only through llm.model_backends' "
                           "factories: the app serves the built-in encoder", section, backend)


class LocalNLPModels:
    def __init__(self, config: Optional[AppConfig] = None, embedder: Optional[Embedder] = None,
                 cross_encoder: Optional[CrossEncoder] = None, device=None) -> None:
        cfg = config or AppConfig()
        warn_unserved_backends(cfg)
        # a given embedder sets the device; else device=None means CUDA
        self.device = embedder.device if embedder is not None else resolve_device(device)
        cache = EmbeddingCache(cfg.cache.embedding_cache_size)
        self.embedder = embedder or Embedder(cfg.embedding, cache=cache, device=self.device)
        self._cross: Optional[CrossEncoder] = cross_encoder
        self._cross_cfg = cfg.cross_encoder

    @property
    def cross_encoder(self) -> CrossEncoder:
        if self._cross is None:  # built at first use: rerank may be off
            self._cross = CrossEncoder(self._cross_cfg, device=self.device)
        return self._cross

    @property
    def embedding_dimension(self) -> int:
        return self.embedder.embedding_dimension

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        return self.embedder.embed(texts)

    def embed_device(self, texts: Sequence[str], pad_to: int) -> torch.Tensor:
        """Device-resident batch embedding (see Embedder.embed_device)."""
        return self.embedder.embed_device(texts, pad_to)

    def embed_single(self, text: str) -> np.ndarray:
        return self.embedder.embed_single(text)

    def rerank(self, query: str, docs: Sequence[str], top_k: Optional[int] = None,
               max_chars: int = 3000) -> List[Tuple[int, float]]:
        return self.cross_encoder.rerank(query, docs, top_k=top_k, max_chars=max_chars)
