"""Embedder: batched text -> L2-normalized embeddings on the device.

Counterpart of `radiant_rag_tpu/models/embedder.py`: the same cache-aware
batching contract (look each text up in the LRU, compute only the misses,
merge in order) over the port's `BertEncoder`, with batches padded to
`BATCH_BUCKETS` and sequences to the tokenizer's `LENGTH_BUCKETS`.
`embed_device` keeps a batch on the device for `HybridSearcher.search_rows
(_qdev=...)`.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from radiant_rag_tpu_torch import resolve_device, to_device
from radiant_rag_tpu_torch.config import EmbeddingConfig
from radiant_rag_tpu_torch.models.bert import (
    BertConfig, BertEncoder, init_module, l2_normalize, mean_pool,
)
from radiant_rag_tpu_torch.models.tokenizer import load_tokenizer
from radiant_rag_tpu_torch.utils.cache import EmbeddingCache
from radiant_rag_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

BATCH_BUCKETS = (1, 8, 32, 64, 128, 256)


def _batch_bucket(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def pad_rows(arrays, rows: int):
    """Zero rows appended to each (b, s) array up to `rows` (a padded row has
    an all-zero mask)."""
    return [np.pad(a, ((0, rows - a.shape[0]), (0, 0))) for a in arrays]


class Embedder:
    """MiniLM-class bi-encoder with mean pooling + L2 normalization."""

    def __init__(self, config: Optional[EmbeddingConfig] = None,
                 cache: Optional[EmbeddingCache] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
                 device=None) -> None:
        """params: a `BertEncoder` state_dict (`convert.bert_params_from_jax`
        carries the JAX package's across); else the latest checkpoint in
        checkpoint_dir, weights_path (HF), the shipped artifact, then a
        seeded init."""
        self.device = resolve_device(device)
        self.config = config or EmbeddingConfig()
        cfg = self.config
        self.bert_cfg = BertConfig(vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
                                   num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                                   intermediate_size=cfg.hidden_dim,
                                   dtype=compute_dtype(cfg.dtype))
        self.model = BertEncoder(self.bert_cfg)
        self.tokenizer = load_tokenizer(cfg.weights_path, cfg.vocab_size)
        if params is None:
            params = self._restore_checkpoint(cfg)
        if params is None:
            if cfg.weights_path:
                from radiant_rag_tpu_torch.models.hf_loading import try_load_bert_params

                params = try_load_bert_params(cfg.weights_path, self.bert_cfg)
            if params is None:
                from radiant_rag_tpu_torch.models.pretrained import shipped_embedder_params

                params = shipped_embedder_params(self.bert_cfg, self.model.state_dict())
        if params is None:
            init_module(self.model, seed)
        else:
            self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        self.cache = cache if cache is not None else EmbeddingCache(cfg.cache_size)

    def _restore_checkpoint(self, cfg: EmbeddingConfig) -> Optional[Dict[str, torch.Tensor]]:
        """The latest trained params in cfg.checkpoint_dir (the `train`
        output, `parallel/checkpoint.py`): how a fresh process serves a
        trained encoder. None when the directory is missing, empty or holds
        no step. Unlike the JAX package, which logs and serves other
        weights, a checkpoint that does not fit this architecture raises
        (ValueError), as does any failure to read it, and an orbax
        directory of the JAX package raises NotImplementedError naming
        `convert.embedder_checkpoint_from_jax`."""
        d = cfg.checkpoint_dir
        if not d or not os.path.isdir(d) or not os.listdir(d):
            return None
        from radiant_rag_tpu_torch.convert import params_from_flat
        from radiant_rag_tpu_torch.parallel.checkpoint import TrainCheckpointer

        state = TrainCheckpointer(d).restore()
        if state is None:
            return None
        params = params_from_flat(state["params"])
        template = self.model.state_dict()
        bad = sorted(k for k in set(template) | set(params)
                     if k not in params or k not in template
                     or tuple(params[k].shape) != tuple(template[k].shape))
        if bad:
            raise ValueError(f"embedder checkpoint {d} (step {state['step']}) does not fit "
                             f"the configured architecture: {bad[:5]}")
        logger.info("embedder: restored trained params from %s (step %s)", d, state["step"])
        return params

    def set_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Hot-swap encoder weights; clears the cache (its vectors are from
        the old weights)."""
        self.model.load_state_dict(params)
        self.cache.clear()

    @property
    def embedding_dimension(self) -> int:
        return self.config.dim

    def _forward(self, ids: np.ndarray, attn: np.ndarray, types: np.ndarray) -> torch.Tensor:
        """(b, dim) float32 on the device."""
        dev = self.device
        mask = to_device(attn, dev)
        with torch.no_grad():
            hidden = self.model(to_device(ids, dev), mask, to_device(types, dev))
            pooled = mean_pool(hidden, mask)
            if self.config.normalize:
                pooled = l2_normalize(pooled)
        return pooled.float()

    def _compute(self, texts: Sequence[str]) -> np.ndarray:
        """Forward a list of texts (no cache), a batch at a time. Every batch
        is queued before the first is fetched, so the host tokenizes batch
        i + 1 while the device runs batch i."""
        bs = self.config.batch_size
        pending = []
        for start in range(0, len(texts), bs):
            chunk = list(texts[start:start + bs])
            arrays = self.tokenizer.encode_batch(chunk, self.config.max_seq_len)
            pending.append((start, len(chunk),
                            self._forward(*pad_rows(arrays, _batch_bucket(len(chunk))))))
        out = np.zeros((len(texts), self.config.dim), np.float32)
        for start, n, emb in pending:
            out[start:start + n] = emb[:n].cpu().numpy()
        return out

    def embed_device(self, texts: Sequence[str], pad_to: int) -> torch.Tensor:
        """A batch's embeddings kept on the device, padded to `pad_to` rows:
        the serving hand-off to `search_rows(_qdev=...)` without a host round
        trip. Bypasses the cache. Padded rows are exactly zero (all-zero
        mask -> guarded mean pool -> eps-guarded normalize)."""
        if pad_to < len(texts):
            raise ValueError(f"pad_to {pad_to} < batch {len(texts)}")
        with annotate("embed.prep"):
            arrays = pad_rows(self.tokenizer.encode_batch(list(texts), self.config.max_seq_len),
                              pad_to)
        return self._forward(*arrays)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """Cache-aware batch embedding."""
        if len(texts) == 0:
            return np.zeros((0, self.config.dim), np.float32)
        found, missing = self.cache.get_batch(texts)
        out = np.zeros((len(texts), self.config.dim), np.float32)
        for i, e in found.items():
            out[i] = e
        if missing:
            computed = self._compute([texts[i] for i in missing])
            for j, i in enumerate(missing):
                out[i] = computed[j]
                self.cache.put(texts[i], computed[j])
        return out

    def embed_single(self, text: str) -> np.ndarray:
        return self.embed([text])[0]
