"""BERT-family encoder (MiniLM class) as PyTorch modules.

Counterpart of `radiant_rag_tpu/models/bert.py`: the compute core of the
embedding bi-encoder (all-MiniLM-L12-v2 class: 12 layers, hidden 384, 12
heads) and of the cross-encoder (ms-marco-MiniLM-L12 class). Parameters
stay float32; the compute dtype is the config's (bfloat16 by default). The
module and parameter names are the flax tree's (`word_emb`, `layer_0.
attention.query`, ...), so carrying weights across is a rename
(`convert.bert_params_from_jax`).

The JAX package leaves this to XLA, and so does the port to plain PyTorch:
no Pallas kernel is involved. It rounds where XLA rounds, so bfloat16
results agree with the JAX package up to the exact GELU, whose bfloat16
`erfc` path differs by at most one bfloat16 ulp:
  * a Dense layer rounds the product to the compute dtype, then adds the
    bias in it (`F.linear` would fuse the bias and round once);
  * the attention logits are divided by bf16(sqrt(head_dim)) in float32 and
    rounded once, masked keys set to -1e9, and the softmax runs in float32
    before its probabilities are rounded back (once, inside the softmax);
  * the three embeddings are summed stepwise in the compute dtype;
  * LayerNorm runs on a float32 copy of its input and its output is
    rounded once (flax's float32 LayerNorm, then the cast); its variance is
    torch's two-pass one where flax takes E[x^2] - E[x]^2, a difference
    below 1e-6 in float32. (CUDA's LayerNorm takes no bf16 input with
    float32 weights.)
The attention stays matmul + softmax: `scaled_dot_product_attention` would
not round the probabilities where the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16  # compute dtype; parameters stay float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)`: the product rounded to dtype, then the
    bias added in dtype."""
    return torch.matmul(x.to(dtype), layer.weight.to(dtype).t()) + layer.bias.to(dtype)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=float32)` on x, then the cast to dtype."""
    return ln(x.float()).to(dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query, self.key, self.value, self.out = (nn.Linear(h, h) for _ in range(4))
        # bf16(sqrt(head_dim)) as the JAX package casts it, as a float32 divisor
        self.scale = float(torch.tensor(math.sqrt(cfg.head_dim)).to(cfg.dtype))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, h = x.shape

        def heads(layer):  # (b, heads, s, head_dim)
            out = dense(layer, x, cfg.dtype)
            return out.view(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        logits = torch.matmul(q, k.transpose(-1, -2))
        logits.div_(self.scale)  # float32 division, one rounding to the compute dtype
        # -1e9 rounds to bf16 here, where the JAX package writes it in float32:
        # both are exactly 0 after the softmax unless every key is masked,
        # and then both rows are uniform
        logits.masked_fill_(~mask[:, None, None, :], -1e9)
        # torch's softmax of a bf16 tensor accumulates in float32 and rounds
        # its output once: the JAX package's float32 softmax, then the cast
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, h)
        return dense(self.out, ctx, cfg.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg)
        self.attn_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.mlp_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = layer_norm(self.attn_ln, x + self.attention(x, mask), dt)
        mlp = dense(self.mlp_out, F.gelu(dense(self.mlp_in, x, dt)), dt)
        return layer_norm(self.mlp_ln, x + mlp, dt)


class BertEncoder(nn.Module):
    """Token ids -> contextual hidden states (b, s, h) in the compute dtype."""

    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.word_emb = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_emb = nn.Embedding(cfg.max_position, cfg.hidden_size)
        self.type_emb = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.emb_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        s = input_ids.shape[1]
        ids = input_ids.long()
        types = torch.zeros_like(ids) if token_type_ids is None else token_type_ids.long()
        # the module calls gather float32 rows as indexing would; their
        # backward (`embedding_dense_backward`) sums a repeated id's rows in
        # parallel, where indexing's serializes them (padding, type 0)
        word = self.word_emb(ids).to(cfg.dtype)
        pos = self.pos_emb.weight[:s].to(cfg.dtype)[None]
        typ = self.type_emb(types).to(cfg.dtype)
        x = layer_norm(self.emb_ln, (word + pos) + typ, cfg.dtype)
        mask = attention_mask.bool()
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence, in float32 (an all-zero mask gives 0)."""
    m = attention_mask.float()[:, :, None]
    summed = (hidden.float() * m).sum(dim=1)
    return summed / torch.clamp(m.sum(dim=1), min=1e-9)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def init_module(module: nn.Module, seed: int) -> nn.Module:
    """Deterministic init of every Linear, Embedding and LayerNorm in
    `module` from a seeded generator, with flax's default distributions:
    Dense kernels lecun-normal (truncated at 2 sigma), zero biases,
    embeddings normal with variance 1 / features, LayerNorm scale 1, bias 0.
    The values are not the JAX package's (another generator)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = 1.0 / math.sqrt(m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=g)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim), generator=g)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module


def init_params(cfg: BertConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A BertEncoder's float32 parameters from init_module (used when no
    pretrained weights exist)."""
    return init_module(BertEncoder(cfg), seed).state_dict()
