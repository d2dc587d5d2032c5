"""BERT-family encoder (MiniLM class) as PyTorch modules.

Counterpart of `radiant_rag_tpu/models/bert.py`: the compute core of the
embedding bi-encoder (all-MiniLM-L12-v2 class: 12 layers, hidden 384, 12
heads) and of the cross-encoder (ms-marco-MiniLM-L12 class). Parameters
stay float32; the compute dtype is the config's (bfloat16 by default). The
module and parameter names are the flax tree's (`word_emb`, `layer_0.
attention.query`, ...), so carrying weights across is a rename
(`convert.bert_params_from_jax`).

One forward, `encoder_forward`, serves and trains. It reads a parameter
table: each parameter's name -> its model shards, one per device of a
data row. A module's own parameters are one shard each (`param_table`, as
`BertEncoder.forward` calls it); a ('data', 'model') mesh gives a data
row's shards (`parallel/tensor_parallel.py`). Each shard runs its heads'
query / key / value products and attention and its slice of mlp_in on
its own device; the row-split partials of out and mlp_out are summed on
the first device in float32 and rounded once, then the bias, the
residual and LayerNorm. With one shard the partial is the whole product
and nothing is summed or copied. Under bfloat16 the sum of several
partials is where a model axis differs from the unsharded product (each
partial rounds before the sum).

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
import functools
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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


ParamTable = Mapping[str, Sequence[torch.Tensor]]


def param_table(module: nn.Module) -> Dict[str, Tuple[torch.Tensor]]:
    """`module`'s parameters as a parameter table of one model shard each:
    name -> (the parameter,). The names and the dicts that hold them are
    read once and kept on the module: a forward then builds its table in
    one pass over a list, where `named_parameters` walks the module tree."""
    slots = module.__dict__.get("_table_slots")
    if slots is None:
        slots = [(f"{owner}.{leaf}" if owner else leaf, mod._parameters, leaf)
                 for owner, mod in module.named_modules() for leaf in mod._parameters]
        module.__dict__["_table_slots"] = slots
    return {name: (params[leaf],) for name, params, leaf in slots}


def dense(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)`: the product rounded to dtype, then the
    bias added in dtype."""
    return torch.matmul(x.to(dtype), weight.to(dtype).t()) + bias.to(dtype)


def _layer_norm(P: ParamTable, name: str, x: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=float32)` on x, then the cast to the compute
    dtype."""
    return F.layer_norm(x.float(), (cfg.hidden_size,), P[f"{name}.weight"][0],
                        P[f"{name}.bias"][0], cfg.layer_norm_eps).to(cfg.dtype)


def _reduce(parts: Sequence[torch.Tensor], bias: torch.Tensor, dtype) -> torch.Tensor:
    """A row-split product from its model shards' partials: summed on the
    first one's device in float32 and rounded once, then the bias added in
    dtype. One partial is the whole product, as `dense` computes it."""
    if len(parts) == 1:
        out = parts[0]
    else:
        dev = parts[0].device
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.to(dev).float()
        out = acc.to(dtype)
    return out + bias.to(dtype)


@functools.lru_cache(maxsize=None)
def _attention_scale(head_dim: int, dtype: torch.dtype) -> float:
    """bf16(sqrt(head_dim)) as the JAX package casts it, as a float32 divisor."""
    return float(torch.tensor(math.sqrt(head_dim)).to(dtype))


def _attention_part(P: ParamTable, pre: str, m: int, x: torch.Tensor, mask: torch.Tensor,
                    cfg: BertConfig, heads: int) -> torch.Tensor:
    """Model shard m's heads of self-attention, through its partial of the
    out product (no bias yet)."""
    dt = cfg.dtype
    b, s, _ = x.shape

    def proj(name):  # (b, heads, s, head_dim)
        out = dense(P[f"{pre}{name}.weight"][m], P[f"{pre}{name}.bias"][m], x, dt)
        return out.view(b, s, heads, cfg.head_dim).transpose(1, 2)

    q, k, v = proj("query"), proj("key"), proj("value")
    logits = torch.matmul(q, k.transpose(-1, -2))
    logits.div_(_attention_scale(cfg.head_dim, dt))  # float32 division, one rounding
    # -1e9 rounds to bf16 here, where the JAX package writes it in float32:
    # both are exactly 0 after the softmax unless every key is masked,
    # and then both rows are uniform
    logits.masked_fill_(~mask[:, None, None, :], -1e9)
    # torch's softmax of a bf16 tensor accumulates in float32 and rounds
    # its output once: the JAX package's float32 softmax, then the cast
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, heads * cfg.head_dim)
    return torch.matmul(ctx.to(dt), P[f"{pre}out.weight"][m].to(dt).t())


def _layer(P: ParamTable, pre: str, x: torch.Tensor, masks: List[torch.Tensor],
           devs: Sequence[torch.device], cfg: BertConfig) -> torch.Tensor:
    """One `BertLayer` over the model shards on devs; x on devs[0]."""
    dt, model = cfg.dtype, len(devs)
    heads = cfg.num_heads // model
    xs = [x.to(dv) for dv in devs]
    parts = [_attention_part(P, f"{pre}attention.", m, xs[m], masks[m], cfg, heads)
             for m in range(model)]
    x = _layer_norm(P, f"{pre}attn_ln", x + _reduce(parts, P[f"{pre}attention.out.bias"][0], dt),
                    cfg)
    xs = [x.to(dv) for dv in devs]
    parts = [torch.matmul(F.gelu(dense(P[f"{pre}mlp_in.weight"][m], P[f"{pre}mlp_in.bias"][m],
                                       xs[m], dt)),
                          P[f"{pre}mlp_out.weight"][m].to(dt).t())
             for m in range(model)]
    return _layer_norm(P, f"{pre}mlp_ln", x + _reduce(parts, P[f"{pre}mlp_out.bias"][0], dt),
                       cfg)


def encoder_forward(P: ParamTable, devs: Sequence[torch.device], cfg: BertConfig,
                    input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    token_type_ids: Optional[torch.Tensor] = None,
                    prefix: str = "") -> torch.Tensor:
    """`BertEncoder`'s forward over a parameter table whose split
    parameters hold one shard per device of devs (module doc), the batch on
    devs[0]: (b, s, h) in the compute dtype on devs[0]."""
    s = input_ids.shape[1]
    ids = input_ids.long()
    types = torch.zeros_like(ids) if token_type_ids is None else token_type_ids.long()
    # F.embedding gathers float32 rows as indexing would; its backward
    # (`embedding_dense_backward`) sums a repeated id's rows in parallel,
    # where indexing's serializes them (padding, type 0)
    word = F.embedding(ids, P[f"{prefix}word_emb.weight"][0]).to(cfg.dtype)
    pos = P[f"{prefix}pos_emb.weight"][0][:s].to(cfg.dtype)[None]
    typ = F.embedding(types, P[f"{prefix}type_emb.weight"][0]).to(cfg.dtype)
    x = _layer_norm(P, f"{prefix}emb_ln", (word + pos) + typ, cfg)
    mask = attention_mask.bool()
    masks = [mask.to(dv) for dv in devs]
    for i in range(cfg.num_layers):
        x = _layer(P, f"{prefix}layer_{i}.", x, masks, devs, cfg)
    return x


class BertSelfAttention(nn.Module):
    """The attention's parameters (the forward is `encoder_forward`'s)."""

    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        h = cfg.hidden_size
        self.query, self.key, self.value, self.out = (nn.Linear(h, h) for _ in range(4))


class BertLayer(nn.Module):
    """A layer's parameters (the forward is `encoder_forward`'s)."""

    def __init__(self, cfg: BertConfig) -> None:
        super().__init__()
        self.attention = BertSelfAttention(cfg)
        self.attn_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.mlp_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


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
        return encoder_forward(param_table(self), [self.word_emb.weight.device], self.cfg,
                               input_ids, attention_mask, token_type_ids)


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
