"""Device-resident cross-encoder rerank: no doc tokenization at query time.

Counterpart of `radiant_rag_tpu/models/device_rerank.py`. Every doc is
tokenized once into a device token table (N, d_len) int32 (int16 with
`table_dtype=np.int16`: 0.19 GB instead of 0.37 GB at 1M docs, d_len 93).
At query time the candidates' token rows are gathered by engine row on the
device, and the packed [CLS] q [SEP] d [SEP] layout is assembled by index
arithmetic, identical to `tokenizer.encode_batch(pairs=...)`, so a
cross-encoder scores a pair as it scores it from host tokens. The
cross-encoder then runs over chunks of pairs. The host tokenizes only the
queries.

The score orders candidates by z(CE logit) + prior_weight * z(prior) over
each query's live candidates, with a stable sort (ties go to the lower
slot, as `jnp.argsort` orders them), and returns the raw CE logits.
"""

from __future__ import annotations

import itertools
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from radiant_rag_tpu_torch import to_device
from radiant_rag_tpu_torch.models.tokenizer import CLS_ID, PAD_ID, SEP_ID

logger = logging.getLogger(__name__)


class DeviceReranker:
    """Cross-encoder rerank over row ids against a device doc-token table."""

    def __init__(self, cross_encoder, q_len: int = 31, d_len: int = 93,
                 pair_chunk: int = 4096, table_dtype=np.int32) -> None:
        """q_len / d_len: token budgets of the query and doc sides of a pair
        (L = q_len + d_len + 3 with the specials; 127 by default).
        pair_chunk bounds the attention's transient: chunk x heads x L x L
        logits in the compute dtype (4096 x 12 x 127 x 127 x 2 B = 1.6 GB at
        MiniLM-L12 in bf16)."""
        self.ce = cross_encoder
        self.device = cross_encoder.device
        self.q_len = int(q_len)
        self.d_len = int(d_len)
        self.L = self.q_len + self.d_len + 3
        self.pair_chunk = int(pair_chunk)
        self.table_dtype = table_dtype
        self._table: Optional[torch.Tensor] = None  # (N, d_len) on the device
        self._d_lens: Optional[torch.Tensor] = None  # (N,) int32 on the device
        self.n_rows = 0

    def _tokenize(self, texts: Sequence[str], cap: int, dtype, batch: int = 8192):
        """(len(texts), cap) ids (PAD after each text) and (len(texts),) lengths."""
        ids_host = np.full((len(texts), cap), PAD_ID, dtype)
        lens = np.zeros((len(texts),), np.int32)
        slots = np.arange(cap)[None, :]
        for s in range(0, len(texts), batch):
            lists = self.ce.tokenizer.tokenize_ids_batch(list(texts[s:s + batch]), cap=cap)
            n = np.fromiter(map(len, lists), np.int32, count=len(lists))
            lens[s:s + len(lists)] = n
            # row-major fill: each row's ids, in order, then PAD
            ids_host[s:s + len(lists)][slots < n[:, None]] = np.fromiter(
                itertools.chain.from_iterable(lists), dtype, count=int(n.sum()))
        return ids_host, lens

    # -- build ---------------------------------------------------------------
    def build_table(self, texts: Sequence[str], batch: int = 8192) -> None:
        """Tokenize every doc once into the device table; row i of the table
        is engine row i."""
        ids_host, lens = self._tokenize(texts, self.d_len, self.table_dtype, batch)
        self._table = to_device(ids_host, self.device)
        self._d_lens = to_device(lens, self.device)
        self.n_rows = len(texts)
        logger.info("device rerank table: %d docs x %d tokens (%.2f GB)",
                    self.n_rows, self.d_len, ids_host.nbytes / 1e9)

    def append(self, texts: Sequence[str]) -> None:
        """Extend the table for newly ingested rows."""
        if self._table is None:
            self.build_table(list(texts))
            return
        ids_host, lens = self._tokenize(texts, self.d_len, self.table_dtype)
        self._table = torch.cat([self._table, to_device(ids_host, self.device)])
        self._d_lens = torch.cat([self._d_lens, to_device(lens, self.device)])
        self.n_rows += len(texts)

    # -- the device program ---------------------------------------------------
    def pack_pairs(self, q_ids: torch.Tensor, q_lens: torch.Tensor, rows: torch.Tensor):
        """(B, K, L) int32 ids, mask and token types of the packed pairs
        [CLS] q[:ql] [SEP] d[:dl] [SEP] PAD..., from (B, q_len) query ids,
        (B,) query lengths and (B, K) engine rows (-1: any row; the caller
        masks those slots)."""
        L, q_len, d_len = self.L, self.q_len, self.d_len
        b, k = rows.shape
        safe = rows.clamp(0, self._table.shape[0] - 1)
        d_tok = self._table[safe].to(torch.int32)                     # (B, K, d_len)
        dl = torch.clamp(self._d_lens[safe], max=d_len)[:, :, None]  # (B, K, 1)
        ql = q_lens[:, None, None]                                     # (B, 1, 1)
        pos = torch.arange(L, device=rows.device)[None, None, :]       # (1, 1, L)
        q_part = q_ids[:, (pos[0, 0] - 1).clamp(0, q_len - 1)][:, None, :]       # (B, 1, L)
        d_part = d_tok.gather(2, (pos - ql - 2).clamp(0, d_len - 1).expand(b, k, L))
        end = ql + dl + 2  # position of the closing [SEP]
        seq = torch.where(pos == 0, CLS_ID,
              torch.where(pos <= ql, q_part,
              torch.where(pos == ql + 1, SEP_ID,
              torch.where(pos <= ql + 1 + dl, d_part,
              torch.where(pos == end, SEP_ID, PAD_ID))))).to(torch.int32)  # noqa: E128
        mask = (pos <= end).to(torch.int32)
        types = ((pos >= ql + 2) & (pos <= end)).to(torch.int32)
        return seq, mask, types

    def _scores(self, seq: torch.Tensor, mask: torch.Tensor, types: torch.Tensor
                ) -> torch.Tensor:
        """CE logits of (B, K, L) pairs, in chunks of eff_chunk pairs. Small
        batches do not pad up to pair_chunk: eff_chunk = min(pair_chunk,
        next_pow2(B K)); the last chunk is zero-padded (all-zero masks)."""
        b, k, L = seq.shape
        flat = b * k
        eff = min(self.pair_chunk, 1 << (flat - 1).bit_length())
        pad = (-flat) % eff
        chunks = [torch.cat([t.reshape(flat, L), t.new_zeros((pad, L))]).view(-1, eff, L)
                  for t in (seq, mask, types)]
        logits = torch.cat([self.ce.forward(s, m, t) for s, m, t in zip(*chunks)])
        return logits[:flat].view(b, k)

    @staticmethod
    def _order(logits: torch.Tensor, rows: torch.Tensor, prior: torch.Tensor,
               prior_weight: float, top_k: int):
        """The z-norm blend over live candidates, stable descending order,
        raw logits out (-inf and row -1 on dead slots)."""
        live = (rows >= 0).float()
        denom = torch.clamp(live.sum(dim=1, keepdim=True), min=1.0)

        def znorm(x):
            mean = (x * live).sum(dim=1, keepdim=True) / denom
            var = (((x - mean) ** 2) * live).sum(dim=1, keepdim=True) / denom
            return (x - mean) / torch.sqrt(var + 1e-9)

        final = znorm(logits) + prior_weight * znorm(prior)
        final = torch.where(rows >= 0, final, -torch.inf)
        order = torch.argsort(-final, dim=1, stable=True)[:, :top_k]
        out_rows = rows.gather(1, order)
        out_scores = torch.where(out_rows >= 0, logits.gather(1, order), -torch.inf)
        return out_scores, out_rows.to(torch.int32)

    # -- query time -----------------------------------------------------------
    def rerank_rows(self, q_texts: Sequence[str], rows: np.ndarray, top_k: int = 10,
                    fetch: bool = True, prior_scores: Optional[np.ndarray] = None,
                    prior_weight: float = 0.0):
        """Rerank hybrid candidates: rows (B, K) engine row ids (-1 = empty).
        Returns (scores f32, rows i32) of shape (B, top_k), ordered by
        z(CE logit) + prior_weight * z(prior_scores) per query (weight 0:
        pure CE order). fetch=False returns an unpack() thunk instead, so the
        caller can queue the next batch first."""
        if self._table is None:
            raise RuntimeError("build_table() first")
        rows = np.atleast_2d(np.asarray(rows))
        b, k_cand = rows.shape
        if prior_scores is None:
            prior = np.zeros((b, k_cand), np.float32)
            prior_weight = 0.0
        else:
            prior = np.nan_to_num(np.asarray(prior_scores, np.float32), neginf=0.0, posinf=0.0)
        q_ids, q_lens = self._tokenize(q_texts, self.q_len, np.int32)
        dev = self.device
        rows_t = to_device(rows.astype(np.int64), dev)
        seq, mask, types = self.pack_pairs(to_device(q_ids, dev), to_device(q_lens, dev), rows_t)
        logits = self._scores(seq, mask, types)
        out = self._order(logits, rows_t, to_device(prior, dev), float(prior_weight), top_k)

        def unpack():
            return tuple(t.cpu().numpy() for t in out)

        return unpack() if fetch else unpack
