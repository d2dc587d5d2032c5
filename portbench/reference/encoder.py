"""BERT encoders (MiniLM class) in plain float32 PyTorch.

  embeddings  word + position + token type, LayerNorm (eps 1e-12)
  layer       self-attention (heads of hidden / heads, logits / sqrt(head),
              masked keys at -1e9, softmax), output Dense, residual,
              LayerNorm; Dense -> exact GELU -> Dense, residual, LayerNorm
  embedder    masked mean over tokens, L2-normalised (eps 1e-12)
  cross       [CLS] hidden -> tanh(Dense) -> Dense to one logit

Parameters are the state dicts the harness drew (the port's names). Every
sequence runs at its own length: padded keys carry no weight. Under
`Precision.encoder == "fp8"` both operands of every encoder product are
rounded to e4m3 first (the control); under "bfloat16" the products take
bfloat16 operands (the harness's input generator, `embed_ids`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference.precision import FULL, Precision, fp8, tf32_off
from reference.text import CLS_ID, SEP_ID, hash_ids

EPS = 1e-12


def _mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.encoder == "fp8":
        a, b = fp8(a), fp8(b)
    elif prec.encoder == "bfloat16":
        return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)).to(torch.float32)
    return torch.matmul(a, b)


def _dense(P, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return _mm(x, P[f"{name}.weight"].t(), prec) + P[f"{name}.bias"]


def _ln(P, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], EPS)


def encode(P: Dict[str, torch.Tensor], cfg: Dict, ids: torch.Tensor, mask: torch.Tensor,
           types: torch.Tensor, prec: Precision = FULL, prefix: str = "") -> torch.Tensor:
    """(b, s) ids, mask and types -> (b, s, hidden) float32."""
    heads = int(cfg["num_attention_heads"])
    with tf32_off():
        b, s = ids.shape
        x = (P[f"{prefix}word_emb.weight"][ids] + P[f"{prefix}pos_emb.weight"][:s][None]
             + P[f"{prefix}type_emb.weight"][types])
        x = _ln(P, f"{prefix}emb_ln", x)
        h = x.shape[-1]
        hd = h // heads
        keep = mask.bool()[:, None, None, :]
        for i in range(int(cfg["num_hidden_layers"])):
            pre = f"{prefix}layer_{i}."

            def split(t):
                return t.view(b, s, heads, hd).transpose(1, 2)

            q = split(_dense(P, f"{pre}attention.query", x, prec))
            k = split(_dense(P, f"{pre}attention.key", x, prec))
            v = split(_dense(P, f"{pre}attention.value", x, prec))
            logits = _mm(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
            probs = torch.softmax(logits.masked_fill(~keep, -1e9), dim=-1)
            ctx = _mm(probs, v, prec).transpose(1, 2).reshape(b, s, h)
            x = _ln(P, f"{pre}attn_ln", x + _dense(P, f"{pre}attention.out", ctx, prec))
            mid = F.gelu(_dense(P, f"{pre}mlp_in", x, prec))
            x = _ln(P, f"{pre}mlp_ln", x + _dense(P, f"{pre}mlp_out", mid, prec))
        return x


def _pad(seqs: Sequence[Tuple[List[int], List[int]]], device) -> Tuple[torch.Tensor, ...]:
    s = max(len(ids) for ids, _ in seqs)
    ids = torch.zeros((len(seqs), s), dtype=torch.long)
    types = torch.zeros_like(ids)
    mask = torch.zeros_like(ids)
    for i, (a, t) in enumerate(seqs):
        ids[i, :len(a)] = torch.tensor(a)
        types[i, :len(t)] = torch.tensor(t)
        mask[i, :len(a)] = 1
    return ids.to(device), mask.to(device), types.to(device)


def _pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()[:, :, None]
    pooled = (hidden * m).sum(1) / m.sum(1).clamp_min(1e-9)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(EPS)


def embed_ids(P, cfg: Dict, ids: torch.Tensor, prec: Precision = FULL,
              block: int = 32768) -> torch.Tensor:
    """(n, hidden) L2-normalised embeddings of (n, s) token ids, every row
    s tokens long ([CLS] and [SEP] included), in blocks of rows."""
    out = []
    for s0 in range(0, ids.shape[0], block):
        part = ids[s0:s0 + block]
        mask = torch.ones_like(part)
        out.append(_pool(encode(P, cfg, part, mask, torch.zeros_like(part), prec), mask))
    return torch.cat(out)


def embed_texts(P, cfg: Dict, texts: Sequence[str], device, prec: Precision = FULL,
                block: int = 512) -> torch.Tensor:
    """(n, hidden) L2-normalised sentence embeddings, [CLS] text [SEP] each,
    at most `max_seq_len` tokens."""
    cap = int(cfg["query_max_seq_len"])
    out = []
    for s0 in range(0, len(texts), block):
        seqs = []
        for t in texts[s0:s0 + block]:
            ids = [CLS_ID] + hash_ids(t, int(cfg["vocab_size"]))[:cap - 2] + [SEP_ID]
            seqs.append((ids, [0] * len(ids)))
        ids, mask, types = _pad(seqs, device)
        out.append(_pool(encode(P, cfg, ids, mask, types, prec), mask))
    return torch.cat(out)


def pair_logits(P, cfg: Dict, queries: Sequence[str], docs: Sequence[str], q_len: int,
                d_len: int, device, prec: Precision = FULL, block: int = 1024) -> torch.Tensor:
    """(n,) cross-encoder logits of [CLS] q[:q_len] [SEP] d[:d_len] [SEP]."""
    vocab = int(cfg["vocab_size"])
    out = []
    for s0 in range(0, len(queries), block):
        seqs = []
        for q, d in zip(queries[s0:s0 + block], docs[s0:s0 + block]):
            qa, da = hash_ids(q, vocab)[:q_len], hash_ids(d, vocab)[:d_len]
            ids = [CLS_ID] + qa + [SEP_ID] + da + [SEP_ID]
            seqs.append((ids, [0] * (len(qa) + 2) + [1] * (len(da) + 1)))
        ids, mask, types = _pad(seqs, device)
        hidden = encode(P, cfg, ids, mask, types, prec, prefix="bert.")
        with tf32_off():
            pooled = torch.tanh(hidden[:, 0] @ P["pooler.weight"].t() + P["pooler.bias"])
            out.append((pooled @ P["classifier.weight"].t() + P["classifier.bias"])[:, 0])
    return torch.cat(out)
