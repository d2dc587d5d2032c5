"""Cross-encoder reranker: (query, doc) pairs -> relevance scores on the device.

Counterpart of `radiant_rag_tpu/models/cross_encoder.py`: a BERT pair
encoder in the BertForSequenceClassification shape (encoder -> [CLS] in
float32 -> tanh pooler -> one-logit classifier, both Dense in float32),
with batches bucketed as the embedder buckets them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from radiant_rag_tpu_torch import resolve_device, to_device
from radiant_rag_tpu_torch.config import CrossEncoderConfig
from radiant_rag_tpu_torch.models.bert import (
    BertConfig, BertEncoder, ParamTable, dense, encoder_forward, init_module, param_table,
)
from radiant_rag_tpu_torch.models.embedder import _batch_bucket, compute_dtype, pad_rows
from radiant_rag_tpu_torch.models.tokenizer import load_tokenizer


def cross_encoder_forward(P: ParamTable, devs: Sequence[torch.device], cfg: BertConfig,
                          input_ids: torch.Tensor, attention_mask: torch.Tensor,
                          token_type_ids: torch.Tensor) -> torch.Tensor:
    """`CrossEncoderModel`'s forward over a parameter table (as
    `bert.encoder_forward`'s): (b,) float32 logits on devs[0]."""
    hidden = encoder_forward(P, devs, cfg, input_ids, attention_mask, token_type_ids, "bert.")
    pooled = torch.tanh(dense(P["pooler.weight"][0], P["pooler.bias"][0],
                              hidden[:, 0, :].float(), torch.float32))
    return dense(P["classifier.weight"][0], P["classifier.bias"][0], pooled,
                 torch.float32)[:, 0]


class CrossEncoderModel(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.bert = BertEncoder(cfg)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.classifier = nn.Linear(cfg.hidden_size, 1)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        return cross_encoder_forward(param_table(self), [self.pooler.weight.device], self.cfg,
                                     input_ids, attention_mask, token_type_ids)


class CrossEncoder:
    def __init__(self, config: Optional[CrossEncoderConfig] = None,
                 bert_cfg: Optional[BertConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None, seed: int = 1,
                 device=None) -> None:
        """params: a `CrossEncoderModel` state_dict
        (`convert.cross_encoder_params_from_jax`); else weights_path (HF),
        the shipped artifact, then a seeded init."""
        self.device = resolve_device(device)
        self.config = config or CrossEncoderConfig()
        c = self.config
        self.bert_cfg = bert_cfg or BertConfig(
            vocab_size=c.vocab_size, hidden_size=c.dim, num_layers=c.num_layers,
            num_heads=c.num_heads, intermediate_size=c.hidden_dim,
            dtype=compute_dtype(c.dtype))
        self.model = CrossEncoderModel(self.bert_cfg)
        self.tokenizer = load_tokenizer(c.weights_path, self.bert_cfg.vocab_size)
        if params is None and c.weights_path:
            from radiant_rag_tpu_torch.models.hf_loading import try_load_cross_encoder_params

            params = try_load_cross_encoder_params(c.weights_path, self.bert_cfg)
        if params is None:
            from radiant_rag_tpu_torch.models.pretrained import shipped_cross_encoder_params

            params = shipped_cross_encoder_params(self.bert_cfg, self.model.state_dict())
        if params is None:
            init_module(self.model, seed)
        else:
            self.model.load_state_dict(params)
        self.model.to(self.device).eval()

    def forward(self, ids: torch.Tensor, attn: torch.Tensor, types: torch.Tensor
                ) -> torch.Tensor:
        """(b,) float32 logits of packed pairs already on the device."""
        with torch.no_grad():
            return self.model(ids, attn, types)

    def score_pairs(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """Relevance score per (query, doc) pair."""
        if not pairs:
            return np.zeros((0,), np.float32)
        bs = self.config.batch_size
        pending = []  # every batch queued before the first fetch
        for start in range(0, len(pairs), bs):
            chunk = pairs[start:start + bs]
            arrays = self.tokenizer.encode_batch([q for q, _ in chunk], self.config.max_seq_len,
                                                 pairs=[d for _, d in chunk])
            ids, attn, types = (to_device(a, self.device)
                                for a in pad_rows(arrays, _batch_bucket(len(chunk))))
            pending.append((start, len(chunk), self.forward(ids, attn, types)))
        out = np.zeros((len(pairs),), np.float32)
        for start, n, scores in pending:
            out[start:start + n] = scores[:n].cpu().numpy()
        return out

    def rerank(self, query: str, docs: Sequence[str], top_k: Optional[int] = None,
               max_chars: int = 3000) -> List[Tuple[int, float]]:
        """[(doc index, score)] in descending score; each doc's text is cut
        to max_chars first."""
        scores = self.score_pairs([(query, d[:max_chars]) for d in docs])
        order = np.argsort(-scores)
        if top_k is not None:
            order = order[:top_k]
        return [(int(i), float(scores[i])) for i in order]
