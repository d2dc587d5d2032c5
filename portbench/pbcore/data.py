"""Inputs made from the run's seed: the corpus, the query batches and the
models' weights.

Everything is drawn on the run's device from `torch.Generator`s seeded by
`stream_seed(seed, name)`, in a few large calls, so the same seed gives the
same inputs and set-up does not pay for host random numbers. The corpus
follows bench.py's generator, rewritten here (the configuration's
`assumed` block states it):

  texts    `words_per_doc` words "w<k>" per doc, k a discrete Pareto draw of
           tail index `zipf_a` - 1 (P(k) ~ k^-zipf_a, as numpy's zipf)
           folded modulo `vocab_words`
  vectors  by the configuration's `corpus_vectors`:
           "clusters"  `clusters` centres ~ N(0, 1), each row a centre plus
                       `noise` x N(0, 1), L2-normalised (bench.py's)
           "encoder"   the run's embedder (its weights below) over each
                       passage's first `lead_words` words, [CLS] lead [SEP],
                       bfloat16 products, mean-pooled, L2-normalised: the
                       dense leg then retrieves for real, for the port and
                       the reference alike

Texts are built as one byte buffer (no Python loop per doc) and split once.
The index matrix the texts are made of is kept: the reference tokenizes
from it (each word is one token under the program's analysers).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for one named random stream of a run."""
    tag = [ord(c) for c in name]
    return int(np.random.SeedSequence([int(seed) & ((1 << 64) - 1), *tag])
               .generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def generator(device: torch.device, seed: int, name: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name))


@dataclasses.dataclass
class Corpus:
    vecs: Optional[torch.Tensor]  # (N, D) float32 unit rows on the device (None in the window)
    vecs_host: torch.Tensor  # the same rows on the host
    words: np.ndarray  # (N, W) int32 word indices (host)
    texts: List[str]  # N strings
    word_strings: List[str]  # vocabulary: index -> "w<k>"


def word_table(vocab_words: int) -> List[str]:
    return [f"w{k}" for k in range(vocab_words)]


def texts_from_words(words: np.ndarray, vocab: Sequence[str]) -> List[str]:
    """One string per row of `words`: its words joined by single spaces."""
    n, w = words.shape
    if n == 0:
        return []
    width = max(len(s) for s in vocab)
    table = np.zeros((len(vocab), width), np.uint8)
    lens = np.zeros(len(vocab), np.int64)
    for i, s in enumerate(vocab):
        table[i, :len(s)] = np.frombuffer(s.encode("ascii"), np.uint8)
        lens[i] = len(s)
    flat = words.reshape(-1)
    tok_len = lens[flat] + 1  # the word and its separator
    ends = np.cumsum(tok_len)
    starts = ends - tok_len
    buf = np.empty(int(ends[-1]), np.uint8)
    for c in range(width):
        keep = c < lens[flat]
        buf[starts[keep] + c] = table[flat[keep], c]
    sep = np.full(flat.shape, ord(" "), np.uint8)
    sep[w - 1::w] = ord("\n")
    buf[ends - 1] = sep
    return buf[:-1].tobytes().decode("ascii").split("\n")


def pareto_words(g: torch.Generator, shape, a: float, vocab_words: int,
                 device: torch.device) -> torch.Tensor:
    """Word indices: floor(U^(-1 / (a - 1))) modulo vocab_words (int64)."""
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float64)
    u = u.clamp_min(1e-300)
    x = torch.floor(torch.pow(u, -1.0 / (a - 1.0)))
    return torch.fmod(x, float(vocab_words)).to(torch.int64)


def corpus_vectors(spec: Dict, seed: int, device: torch.device, words: np.ndarray,
                   embedder: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The (N, D) float32 unit corpus vectors on the device (module doc)."""
    kind = spec.get("corpus_vectors", "clusters")
    if kind == "encoder":
        return lead_embeddings(spec, words, embedder, device)
    if kind != "clusters":
        raise ValueError(f"corpus_vectors {kind!r}: 'clusters' or 'encoder'")
    n, dim = int(spec["num_passages"]), int(spec["dim"])
    g = generator(device, seed, "corpus.vectors")
    centers = torch.randn((int(spec["clusters"]), dim), generator=g, device=device)
    assign = torch.randint(0, centers.shape[0], (n,), generator=g, device=device)
    vecs = centers[assign]
    vecs.add_(torch.randn((n, dim), generator=g, device=device), alpha=float(spec["noise"]))
    return vecs.div_(torch.linalg.vector_norm(vecs, dim=1, keepdim=True))


def lead_embeddings(spec: Dict, words: np.ndarray, embedder: Dict[str, torch.Tensor],
                    device: torch.device) -> torch.Tensor:
    """The embedder's vectors of [CLS] + each passage's first `lead_words`
    words + [SEP] (every word one token of the hash tokenizer)."""
    from reference import encoder as renc
    from reference.precision import INPUTS
    from reference.text import CLS_ID, SEP_ID, hash_ids

    vocab = word_table(int(spec["vocab_words"]))
    table = torch.tensor([hash_ids(w, int(spec["vocab_size"]))[0] for w in vocab],
                         dtype=torch.long, device=device)
    lead = torch.from_numpy(words[:, :int(spec["lead_words"])].astype(np.int64)).to(device)
    n = lead.shape[0]
    ids = torch.cat([torch.full((n, 1), CLS_ID, dtype=torch.long, device=device), table[lead],
                     torch.full((n, 1), SEP_ID, dtype=torch.long, device=device)], dim=1)
    with torch.no_grad():
        return renc.embed_ids(embedder, spec, ids, INPUTS)


def make_corpus(spec: Dict, seed: int, device: torch.device,
                embedder: Dict[str, torch.Tensor]) -> Corpus:
    gw = generator(device, seed, "corpus.words")
    words = pareto_words(gw, (int(spec["num_passages"]), int(spec["words_per_doc"])),
                         float(spec["zipf_a"]), int(spec["vocab_words"]),
                         device).to(torch.int32).cpu().numpy()
    vocab = word_table(int(spec["vocab_words"]))
    vecs = corpus_vectors(spec, seed, device, words, embedder)
    return Corpus(vecs=vecs, vecs_host=vecs.cpu(), words=words,
                  texts=texts_from_words(words, vocab), word_strings=vocab)


@dataclasses.dataclass
class QueryBatches:
    texts: List[List[str]]  # per batch, B query texts
    words: np.ndarray  # (batches, B, query_words) word indices of the texts
    vectors: List[np.ndarray]  # per batch (B, D) float32, empty for text queries


def make_queries(traffic: Dict, corpus: Corpus, seed: int, device: torch.device,
                 n_batches: int) -> QueryBatches:
    """`n_batches` batches of `batch_size` queries. Each query is drawn from
    a uniform corpus row: its first `query_words` words, and for vector
    queries that row's vector plus `query_noise` x N(0, 1), renormalised."""
    b, qw = int(traffic["batch_size"]), int(traffic["query_words"])
    n = corpus.words.shape[0]
    g = generator(device, seed, "queries")
    docs = torch.randint(0, n, (n_batches, b), generator=g, device=device)
    vectors: List[np.ndarray] = []
    if traffic["query_form"] == "vector":
        noise = float(traffic["query_noise"])
        for i in range(n_batches):
            q = corpus.vecs[docs[i]]
            q = q + noise * torch.randn(q.shape, generator=g, device=device)
            q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
            vectors.append(q.cpu().numpy())
    docs = docs.cpu().numpy()
    words = corpus.words[docs.reshape(-1), :qw]
    flat = texts_from_words(words, corpus.word_strings)
    texts = [flat[i * b:(i + 1) * b] for i in range(n_batches)]
    return QueryBatches(texts=texts, words=words.reshape(n_batches, b, qw),
                        vectors=vectors)


def batches_for(traffic: Dict, seconds: float) -> int:
    """Distinct batches a run draws: enough for `seconds` at the traffic's
    ceiling rate (`max_batches_per_s`), so the window never repeats one."""
    return max(2, int(math.ceil(float(traffic["max_batches_per_s"]) * seconds)) + 2)


def model_params(cfg: Dict, seed: int, device: torch.device) -> Dict[str, Dict]:
    """The embedder's and the cross-encoder's weights."""
    return {"embedder": bert_params(cfg, seed, "weights.embedder", device),
            "cross_encoder": bert_params(cfg, seed, "weights.cross_encoder", device,
                                         prefix="bert.", head=True)}


def bert_params(cfg: Dict, seed: int, name: str, device: torch.device,
                prefix: str = "", head: bool = False) -> Dict[str, torch.Tensor]:
    """Float32 weights of a BERT encoder (and, with `head`, a sequence
    classifier's pooler and one-logit classifier), under the port's
    parameter names, from one draw on the device: every Linear N(0, 1 /
    fan_in) clipped at 2 sigma, every embedding N(0, 1 / hidden), biases 0,
    LayerNorms 1 and 0."""
    h, ff, layers = int(cfg["hidden_size"]), int(cfg["intermediate_size"]), \
        int(cfg["num_hidden_layers"])
    shapes: Dict[str, tuple] = {
        f"{prefix}word_emb.weight": (int(cfg["vocab_size"]), h),
        f"{prefix}pos_emb.weight": (int(cfg["max_position_embeddings"]), h),
        f"{prefix}type_emb.weight": (int(cfg["type_vocab_size"]), h),
    }
    linear: Dict[str, tuple] = {}
    for i in range(layers):
        pre = f"{prefix}layer_{i}."
        for part in ("query", "key", "value", "out"):
            linear[f"{pre}attention.{part}"] = (h, h)
        linear[f"{pre}mlp_in"] = (ff, h)
        linear[f"{pre}mlp_out"] = (h, ff)
    if head:
        linear["pooler"] = (h, h)
        linear["classifier"] = (1, h)
    total = sum(math.prod(s) for s in shapes.values()) + \
        sum(math.prod(s) for s in linear.values())
    g = generator(device, seed, name)
    flat = torch.randn((total,), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for key, shape in shapes.items():
        size = math.prod(shape)
        out[key] = flat[off:off + size].view(shape).mul(1.0 / math.sqrt(h))
        off += size
    for key, (fout, fin) in linear.items():
        size = fout * fin
        out[f"{key}.weight"] = flat[off:off + size].view(fout, fin).clamp(-2.0, 2.0) \
            .mul(1.0 / math.sqrt(fin))
        out[f"{key}.bias"] = torch.zeros((fout,), device=device)
        off += size
    ones, zeros = torch.ones((h,), device=device), torch.zeros((h,), device=device)
    lns = [f"{prefix}emb_ln"] + [f"{prefix}layer_{i}.{ln}" for i in range(layers)
                                 for ln in ("attn_ln", "mlp_ln")]
    for ln in lns:
        out[f"{ln}.weight"] = ones.clone()
        out[f"{ln}.bias"] = zeros.clone()
    return out
