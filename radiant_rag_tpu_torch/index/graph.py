"""Graph index: KNN graph + batched greedy-beam search on the device.

Counterpart of `radiant_rag_tpu/index/graph.py`; the names and the host
numpy code are the JAX package's, line for line, so every RNG draw is the
same. Its jitted device programs are plain PyTorch functions here (no hand
kernel: none of them is a Pallas kernel in the JAX package).

  build   an exact k-nearest-neighbour graph from tiled corpus x corpus
          matmuls (`build_knn_graph`, up to `GraphIndex.EXACT_BUILD_MAX_ROWS`
          rows), above that NN-descent with a cluster polish
          (`nn_descent_graph`), with fixed out-degree R stored as one (N, R)
          int32 adjacency tensor plus random long-range edges;
  search  batched greedy beam search (`graph_search`): each step gathers the
          beam's neighbourhoods, scores them against the queries, drops
          repeated ids and keeps the top-ef;
  insert  `GraphIndex.add`: exact out-edges of the new rows, and back-edges
          that evict the weakest out-edge of each new row's nearest rows.

How the port differs from the JAX programs, with the same results:
  - no static shapes: the last block of a loop runs at its own size instead
    of padded to the block (the padding was XLA's); `_descent_block` still
    takes a padded block's rows past N, as `jnp.take`'s fill does;
  - repeated ids are found by a stable sort by id (`dedup_mask`), not the
    (B, M, M) pairwise compare, which at B = 2048, ef = 100, R = 20 is a
    9 GB transient;
  - the descent and the polish score bf16-rounded vectors (the JAX programs
    cast every gathered row to bf16), so the port rounds the corpus once at
    every size where the JAX package does so above 4 GB; products of bf16
    values are exact in f32, and sums are f32 as with
    `preferred_element_type`;
  - an exact top-k over a (b, N) score block (`_knn_block`, which the exact
    build shares) runs in query sub-blocks sized to the card's free memory
    (`similarity.route_budget`);
  - every block of a loop is queued before any result is fetched, and each
    loop fetches once.

Ties go to the lowest index, as `lax.top_k` gives them (`topk_first`).
TF32 must stay off (`torch.backends.cuda.matmul.allow_tf32`, PyTorch's
default): the exact build, `_knn_block` and the beam's scores are f32.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from radiant_rag_tpu_torch import resolve_device, to_device
from radiant_rag_tpu_torch.ops import similarity as sim
from radiant_rag_tpu_torch.ops.similarity import NEG_INF, topk_first

logger = logging.getLogger(__name__)

Vectors = Union[np.ndarray, torch.Tensor]


def _device_of(vecs: Vectors, device) -> torch.device:
    return vecs.device if isinstance(vecs, torch.Tensor) else resolve_device(device)


def _as_tensor(vecs: Vectors, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Vectors on `device` in `dtype` (a tensor stays where it is)."""
    if isinstance(vecs, torch.Tensor):
        return vecs.to(dtype)
    return _rows_tensor(np.asarray(vecs, np.float32), device).to(dtype)


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, in f32 (a bf16 operand under f32 accumulation)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _rows_tensor(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to a card without waiting for the queued
    blocks (`to_device`: a copy from pageable memory would wait for them)."""
    return to_device(np.asarray(rows), device)


def dedup_mask(ids: torch.Tensor) -> torch.Tensor:
    """(B, M) -> (B, M) bool: True at the first occurrence of each id in
    its row (later repeats False, -1 pads included). The pairwise rule
    `~any(ids[:, i] == ids[:, j] for j < i)` from one stable sort by id."""
    sid, perm = torch.sort(ids, dim=1, stable=True)
    rep = torch.zeros_like(sid, dtype=torch.bool)
    rep[:, 1:] = sid[:, 1:] == sid[:, :-1]
    return ~torch.zeros_like(rep).scatter_(1, perm, rep)


def build_knn_graph(
    vecs: Vectors,  # (N, D) L2-normalized, host or device
    degree: int = 16,
    n_long_edges: int = 4,
    block: int = 4096,
    seed: int = 0,
    valid: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """Exact KNN graph via tiled device matmuls; returns (N, R+L) int32.

    Each row's neighbors are its `degree` nearest by cosine plus
    `n_long_edges` random long-range links (rewiring for navigability).
    A host array goes to `device` (None: the card); a tensor stays put."""
    n, d = vecs.shape
    dev = _device_of(vecs, device)
    vdev = _as_tensor(vecs, dev, torch.float32)
    mask = None if valid is None else _rows_tensor(np.asarray(valid, bool), dev)

    out = np.zeros((n, degree + n_long_edges), np.int32)
    # queue every block, then fetch once
    pending = []
    for start in range(0, n, block):
        end = min(start + block, n)
        rows = torch.arange(start, end, device=dev)
        pending.append(_knn_block(vdev, mask, vdev[start:end], rows, degree)[1])
    if pending:
        out[:, :degree] = torch.cat(pending).cpu().numpy()
    rng = np.random.default_rng(seed)
    if n_long_edges > 0:
        out[:, degree:] = rng.integers(0, n, (n, n_long_edges), dtype=np.int32)
    return out


def _descent_block(
    vdev: torch.Tensor,  # (N, D) corpus
    mask: torch.Tensor,  # (N,) bool live rows
    adj_dev: torch.Tensor,  # (N, R) int32 current adjacency (device-resident)
    qblk: torch.Tensor,  # (b, D) the block's own vectors
    qrows: torch.Tensor,  # (b,) int32 the block's own rows
    extra_ids: torch.Tensor,  # (b, E) int32 reverse-sample + random probes
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One NN-descent refinement step for a node block: forward and two-hop
    candidates gathered from the device-resident adjacency, plus the
    block's reverse/random probe table. A row past N (a padded block's)
    has no forward edges, as `jnp.take`'s fill gives it."""
    n, r = adj_dev.shape
    fwd = adj_dev[qrows.clamp(0, n - 1).long()]  # (b, R)
    fwd = torch.where((qrows < n)[:, None], fwd, -1)
    fwd2 = adj_dev[fwd.clamp(min=0).long()].reshape(fwd.shape[0], r * r)
    fwd2 = torch.where((fwd >= 0).repeat_interleave(r, dim=1), fwd2, -1)
    cand_ids = torch.cat([fwd, fwd2, extra_ids], dim=1)
    return _refine_block(vdev, mask, qblk, qrows, cand_ids, k)


def _refine_block(
    vdev: torch.Tensor,  # (N, D) corpus
    mask: torch.Tensor,  # (N,) bool live rows
    qblk: torch.Tensor,  # (b, D) the block's own vectors
    qrows: torch.Tensor,  # (b,) int32 the block's own rows
    cand_ids: torch.Tensor,  # (b, C) int32 candidate neighbor ids (-1 pad, dups ok)
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score all candidates (bf16 operands, f32 sums: near-tie order is
    irrelevant to graph quality), drop self/dead/duplicate ids, keep the
    top-k as the new out-edges."""
    safe = cand_ids.clamp(min=0).long()
    g = _bf16_f32(vdev[safe])  # (b, C, D)
    s = torch.bmm(g, _bf16_f32(qblk)[:, :, None])[:, :, 0]
    del g
    bad = (cand_ids < 0) | (cand_ids == qrows[:, None]) | ~mask[safe]
    s = torch.where(bad | ~dedup_mask(cand_ids), NEG_INF, s)
    top_s, sel = topk_first(s, k)
    ids = cand_ids.gather(1, sel)
    ids = torch.where(top_s > NEG_INF / 2, ids, -1)
    return top_s, ids


def _nearest_sample_block(sample_vecs: torch.Tensor, qblk: torch.Tensor) -> torch.Tensor:
    """Index (into the sample) of each block row's nearest sample vector
    (the first of equal maxima, as `jnp.argmax`)."""
    s = _bf16_f32(qblk) @ _bf16_f32(sample_vecs).T
    return torch.argmax(s, dim=1)


def nn_descent_graph(
    vecs: Vectors,  # (N, D) L2-normalized, host or device
    degree: int = 16,
    n_long_edges: int = 4,
    iters: int = 40,
    block: int = 4096,
    seed: int = 0,
    valid: Optional[np.ndarray] = None,
    n_reverse: int = 16,
    n_random: int = 8,
    converge_frac: float = 0.001,
    two_level: bool = False,
    polish: bool = True,
    device=None,
) -> np.ndarray:
    """Approximate KNN graph by NN-descent; returns (N, R+L) int32.

    The exact tiled build (`build_knn_graph`) is O(N^2 D); NN-descent
    converges to a near-exact KNN graph in O(N * C * D * iters) where
    C = R + R^2 + reverse + random candidates per node: each round, every
    node scores its neighbors' neighbors (plus a reverse-edge sample and
    random probes) in one gather + product per block, keeping the top-R.

    `iters` is a ceiling: descent stops when a round changes <=
    converge_frac of all edges. Each round logs its edge changes, its host
    ms (assembly and dispatch) and, on a card, the device span of its
    blocks (CUDA events).

    Candidate generation and the reverse-edge sample run vectorized on the
    host (numpy) per round; every block is queued before the round's one
    fetch, so a round's wall time is max(device time, host assembly).

    n_reverse/n_random auto-scale with corpus size (callers passing larger
    values keep them). two_level=True converges a <= 131k-row subsample
    graph first and starts every node from the adjacency of its nearest
    subsample member (only above 2^18 live rows)."""
    n, d = vecs.shape
    r = degree
    dev = _device_of(vecs, device)
    # ~2x budget at 1M, ~4x at 10M (capped: per-round cost grows with C)
    n_reverse = max(n_reverse, min(64, n // 16384))
    n_random = max(n_random, min(32, n // 32768))
    # the programs below read bf16-rounded vectors only (module doc)
    vdev = _as_tensor(vecs, dev, torch.bfloat16)
    live = np.ones(n, bool) if valid is None else np.asarray(valid, bool).copy()
    pool = np.nonzero(live)[0]
    if len(pool) == 0:
        return np.full((n, r + n_long_edges), -1, np.int32)
    mask_dev = _rows_tensor(live, dev)
    rng = np.random.default_rng(seed)

    # uniform-random init: sample-seeded edges concentrate in-degree on the
    # sample rows (hubs), which the JAX package measured losing at 1M;
    # two_level inherits converged subsample adjacency instead
    if two_level and len(pool) > 1 << 18:
        s1 = min(1 << 17, len(pool))
        sub = rng.choice(pool, size=s1, replace=False).astype(np.int32)
        sub_t = _rows_tensor(sub, dev).long()
        sub_vecs = vecs[sub_t] if isinstance(vecs, torch.Tensor) else \
            np.ascontiguousarray(np.asarray(vecs)[sub])
        sub_adj = nn_descent_graph(
            sub_vecs, degree=r, n_long_edges=0, iters=iters, block=block,
            seed=seed + 7, device=dev)[:, :r]
        # local subsample ids -> corpus rows (-1 stays -1)
        sub_adj = np.where(sub_adj >= 0, sub[np.maximum(sub_adj, 0)], -1)
        sub_vecs_dev = vdev[sub_t]
        pend = [_nearest_sample_block(sub_vecs_dev, vdev[b0:min(b0 + block, n)])
                for b0 in range(0, n, block)]
        nearest = torch.cat(pend).cpu().numpy()
        adj = sub_adj[nearest]
        dead = adj < 0
        if dead.any():
            adj[dead] = rng.choice(pool, size=int(dead.sum()), replace=True)
        adj = adj.astype(np.int32)
    else:
        adj = rng.choice(pool, size=(n, r), replace=True).astype(np.int32)
    rev = np.full((n, n_reverse), -1, np.int32)
    on_card = dev.type == "cuda"
    for it in range(iters):
        t_round = _time.perf_counter()
        # reverse-edge sample: for each edge i->j, j sees i as a candidate
        # (random-slot scatter; collisions overwrite = uniform-ish sample)
        rev.fill(-1)
        src = np.repeat(np.arange(n, dtype=np.int32), r)
        dst = adj.reshape(-1)
        ok = dst >= 0
        slots = rng.integers(0, n_reverse, ok.sum())
        rev[dst[ok], slots] = src[ok]

        pending = []
        adj_dev = _rows_tensor(adj, dev)  # ONE (N, R) upload per round
        if on_card:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        for s0 in range(0, n, block):
            e0 = min(s0 + block, n)
            b = e0 - s0
            rnd = rng.choice(pool, size=(b, n_random), replace=True).astype(np.int32)
            extra = np.concatenate([rev[s0:e0], rnd], axis=1)
            qrows = torch.arange(s0, e0, dtype=torch.int32, device=dev)
            _, ids = _descent_block(vdev, mask_dev, adj_dev, vdev[s0:e0], qrows,
                                    _rows_tensor(extra, dev), r)
            pending.append(ids)
        if on_card:
            ev[1].record()
        host_ms = (_time.perf_counter() - t_round) * 1e3
        new = torch.cat(pending).cpu().numpy()
        device_ms = ev[0].elapsed_time(ev[1]) if on_card else float("nan")
        changed = int((new != adj).sum())
        adj[:] = new
        logger.info("nn-descent round %d: %d edge changes (%.3f%% of %d); host %.1f ms, "
                    "device span %.1f ms", it + 1, changed, 100.0 * changed / max(n * r, 1),
                    n * r, host_ms, device_ms)
        if changed <= converge_frac * n * r:
            logger.info("nn-descent converged after %d rounds (%d changes)",
                        it + 1, changed)
            break

    if polish:
        t_p = _time.time()
        adj = _cluster_polish(vdev, mask_dev, adj, pool, rng, block=block // 2)
        logger.info("cluster polish: %.1fs", _time.time() - t_p)

    out = np.full((n, r + n_long_edges), -1, np.int32)
    out[:, :r] = adj
    if n_long_edges > 0:
        out[:, r:] = rng.choice(pool, size=(n, n_long_edges),
                                replace=True).astype(np.int32)
    return out


def _topk_centroids(cent_vecs: torch.Tensor, qblk: torch.Tensor, n_probe: int) -> torch.Tensor:
    """ids of each row's n_probe nearest centroids (bf16 operands)."""
    s = _bf16_f32(qblk) @ _bf16_f32(cent_vecs).T
    _, ids = topk_first(s, n_probe)
    return ids.to(torch.int32)


def _cluster_polish(vdev, mask_dev, adj: np.ndarray, pool: np.ndarray,
                    rng: np.random.Generator, block: int = 2048,
                    n_centroids: int = 4096, n_probe: int = 2) -> np.ndarray:
    """Exact within-cluster refinement after NN-descent converges.

    The descent's plateau misses are intra-cluster ranking among many
    near-equidistant members (the JAX package's 1M edge study). The fix:
    partition rows by nearest sample centroid and score every node exactly
    against its n_probe nearest partitions' members (union'd with its
    descent edges, top-R kept), in one `_refine_block` pass at candidate
    width R + n_probe * cap. The member table goes to the device once and
    each block's candidates are gathered there."""
    n, r = adj.shape
    dev = vdev.device
    # partitions much larger than the degree: ~64 members per centroid
    take = max(4, min(n_centroids, len(pool) // 64 or 1))
    # member cap bounds the gather transient; 3x the mean partition size
    # covers skew (overflow rows keep their descent edges)
    cap = min(512, max(64, 3 * n // take))
    cent_rows = rng.choice(pool, size=take, replace=False).astype(np.int32)
    cent_vecs = vdev[_rows_tensor(cent_rows, dev).long()]

    ablk = 8192
    probes_dev = torch.cat([_topk_centroids(cent_vecs, vdev[s0:min(s0 + ablk, n)], n_probe)
                            for s0 in range(0, n, ablk)])
    probes = probes_dev.cpu().numpy()

    # bucket rows by top-1 centroid (host, vectorized fill)
    member_table = np.full((take, cap), -1, np.int32)
    top1 = probes[:, 0]
    order = np.argsort(top1, kind="stable").astype(np.int32)
    sorted_c = top1[order]
    starts = np.searchsorted(sorted_c, np.arange(take))
    ends = np.searchsorted(sorted_c, np.arange(take), side="right")
    for c in range(take):
        members = order[starts[c]: ends[c]][:cap]
        member_table[c, : len(members)] = members

    # candidates read only the pre-polish adjacency: queue every block,
    # then fetch once
    member_dev = _rows_tensor(member_table, dev)
    adj_dev = _rows_tensor(adj, dev)
    pend = []
    for s0 in range(0, n, block):
        e0 = min(s0 + block, n)
        extra = member_dev[probes_dev[s0:e0].long()].reshape(e0 - s0, n_probe * cap)
        cand = torch.cat([adj_dev[s0:e0], extra], dim=1)
        qrows = torch.arange(s0, e0, dtype=torch.int32, device=dev)
        pend.append(_refine_block(vdev, mask_dev, vdev[s0:e0], qrows, cand, k=r)[1])
    adj[:] = torch.cat(pend).cpu().numpy()
    return adj


def _knn_block(
    vdev: torch.Tensor,  # (N, D) corpus (any float dtype)
    mask: Optional[torch.Tensor],  # (N,) bool: valid AND row < total
    qblock: torch.Tensor,  # (Q, D) new vectors
    qrows: torch.Tensor,  # (Q,) the new vectors' own rows (self-exclusion)
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 top-k of a block of vectors against the live corpus, each
    query's own row and masked rows scored NEG_INF; in query steps of what
    the device's memory holds at sim.SCORE_BYTES_PER_CELL a cell."""
    n, b = vdev.shape[0], qblock.shape[0]
    step = sim.product_query_block(n, b, sim.route_budget(qblock.device))
    corpus = vdev.to(torch.float32)
    outs_s, outs_i = [], []
    for s in range(0, b, step):
        q = qblock[s:s + step].to(torch.float32)
        scores = q @ corpus.T
        scores[torch.arange(q.shape[0], device=q.device), qrows[s:s + step].long()] = NEG_INF
        if mask is not None:
            scores.masked_fill_(~mask[None, :], NEG_INF)
        top_s, top_i = topk_first(scores, k)
        del scores
        outs_s.append(top_s)
        outs_i.append(top_i.to(torch.int32))
    return torch.cat(outs_s), torch.cat(outs_i)


def _edge_scores(
    vdev: torch.Tensor,  # (N, D)
    mask: torch.Tensor,  # (N,) bool live-row mask
    e_rows: torch.Tensor,  # (E,) int32 existing rows whose edges we re-score
    adj: torch.Tensor,  # (E, R) int32 their current out-edges (-1 pad)
) -> torch.Tensor:
    """Cosine strength of each current edge; dead/invalid edges score -inf
    (so weakest-edge replacement evicts them first)."""
    src = vdev[e_rows.clamp(min=0).long()].to(torch.float32)
    safe = adj.clamp(min=0).long()
    dst = vdev[safe].to(torch.float32)
    s = torch.bmm(dst, src[:, :, None])[:, :, 0]
    live = (adj >= 0) & mask[safe]
    return torch.where(live, s, NEG_INF)


def _scatter_adj(neighbors: torch.Tensor, rows: torch.Tensor, values: torch.Tensor
                 ) -> torch.Tensor:
    """neighbors[rows] = values in place; rows past the end are dropped."""
    keep = rows < neighbors.shape[0]
    neighbors[rows[keep].long()] = values[keep]
    return neighbors


def graph_search(
    vecs: torch.Tensor,  # (N, D) float
    neighbors: torch.Tensor,  # (N, R) int32
    entry_points: torch.Tensor,  # (E,) int32
    queries: torch.Tensor,  # (B, D) f32
    mask: Optional[torch.Tensor],  # (N,) bool or None
    k: int,
    ef: int = 64,
    steps: int = 6,
    entry_sample_rows: Optional[torch.Tensor] = None,  # (E0,) int32
    entry_sample_vecs: Optional[torch.Tensor] = None,  # (E0, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy beam search; returns (scores (B,k), rows (B,k) int32).

    With an entry sample (rows + their vectors, device-resident), each query
    first scores the whole sample in one small matmul and seeds its beam
    with its own top-E rows, a coarse-quantizer entry stage. Without it,
    all queries share E fixed entries, and greedy pruning can strand the
    beam in whatever basin those entries sit in.

    Each step's transient is the gathered (B, ef * (R + 1), D) f32 block."""
    b = queries.shape[0]
    r = neighbors.shape[1]
    e = entry_points.shape[0]

    def score_ids(ids):  # ids (B, M) -> (B, M) cosine, invalid = -inf
        safe = ids.clamp(min=0).long()
        gathered = vecs[safe].to(torch.float32)  # (B, M, D)
        s = torch.bmm(gathered, queries[:, :, None])[:, :, 0]
        del gathered
        s = torch.where(ids >= 0, s, NEG_INF)
        if mask is not None:
            s = torch.where(mask[safe], s, NEG_INF)
        return s

    if entry_sample_vecs is not None:
        es = queries @ entry_sample_vecs.to(queries.dtype).T
        e = min(e, int(entry_sample_rows.shape[0]))  # sample may be small
        _, sel0 = topk_first(es, e)  # per-query best sample rows
        beam_ids = entry_sample_rows[sel0]  # (B, E)
    else:
        beam_ids = entry_points[None, :].expand(b, e)
    beam_scores = score_ids(beam_ids)

    def body(beam_ids, beam_scores):
        nbr = neighbors[beam_ids.clamp(min=0).long()]  # (B, ef', R)
        nbr = torch.where(beam_ids[:, :, None] >= 0, nbr, -1).reshape(b, -1)
        cand_ids = torch.cat([beam_ids, nbr], dim=1)
        cand_scores = torch.cat([beam_scores, score_ids(nbr)], dim=1)
        cand_scores = torch.where(dedup_mask(cand_ids), cand_scores, NEG_INF)
        top_s, sel = topk_first(cand_scores, ef)
        top_ids = cand_ids.gather(1, sel)
        top_ids = torch.where(top_s > NEG_INF / 2, top_ids, -1)
        return top_ids, top_s

    # the first expansion widens the beam from E entries to ef
    for _ in range(steps):
        beam_ids, beam_scores = body(beam_ids, beam_scores)

    top_s, sel = topk_first(beam_scores, k)
    top_ids = beam_ids.gather(1, sel)
    top_ids = torch.where(top_s > NEG_INF / 2, top_ids, -1)
    return top_s, top_ids.to(torch.int32)


class GraphIndex:
    """Graph engine over an existing row space (wraps the flat engine's
    vectors). ef_runtime/ef_construction map onto beam width/build degree
    (reference `config.py:266-272`). Its tensors live on `device` (None:
    the card)."""

    # above this many rows, build() switches from the exact O(N^2) tiled
    # KNN build to NN-descent (near-exact, O(N * C * iters))
    EXACT_BUILD_MAX_ROWS = 200_000

    def __init__(self, degree: int = 16, n_long_edges: int = 4,
                 n_entry_points: int = 16, steps: int = 6, seed: int = 0,
                 entry_sample_size: int = 4096, device=None) -> None:
        self.device = resolve_device(device)
        self.degree = degree
        self.n_long_edges = n_long_edges
        self.n_entry_points = n_entry_points
        self.steps = steps
        self.seed = seed
        self.entry_sample_size = entry_sample_size
        self.neighbors: Optional[torch.Tensor] = None
        self.entry_points: Optional[torch.Tensor] = None
        # coarse-entry sample: per-query beam seeding (see graph_search)
        self.entry_sample_rows: Optional[torch.Tensor] = None
        self.entry_sample_vecs: Optional[torch.Tensor] = None
        self.built_rows = 0
        self._full_built_rows = 0  # rows covered by the last full build

    def _refresh_entry_sample(self, vecs: Vectors, live_pool: np.ndarray,
                              rng: np.random.Generator) -> None:
        """(Re)draw the coarse-entry sample from live rows; a device corpus
        is gathered on the device (no host copy of the corpus)."""
        if len(live_pool) == 0:
            self.entry_sample_rows = None
            self.entry_sample_vecs = None
            return
        take = min(self.entry_sample_size, len(live_pool))
        rows = rng.choice(live_pool, size=take, replace=False).astype(np.int32)
        rows_dev = _rows_tensor(rows, self.device)
        self.entry_sample_rows = rows_dev
        if isinstance(vecs, torch.Tensor):
            self.entry_sample_vecs = vecs[rows_dev.long()]
        else:  # host array: gather on host, upload only the sample
            self.entry_sample_vecs = _rows_tensor(np.asarray(vecs)[rows], self.device)

    def build(self, vecs: Vectors, valid: Optional[np.ndarray] = None,
              method: str = "auto") -> None:
        """Full build over rows [0, N) of `vecs` (a host array, or a tensor
        on this index's device); valid is a host bool array."""
        n = vecs.shape[0]
        if method == "auto":
            method = "exact" if n <= self.EXACT_BUILD_MAX_ROWS else "nn_descent"
        if method == "nn_descent":
            adj = nn_descent_graph(vecs, self.degree, self.n_long_edges,
                                   seed=self.seed, valid=valid, device=self.device)
        else:
            adj = build_knn_graph(vecs, self.degree, self.n_long_edges,
                                  seed=self.seed, valid=valid, device=self.device)
        rng = np.random.default_rng(self.seed + 1)
        if valid is not None and valid.any():
            pool = np.nonzero(valid)[0]
        else:
            pool = np.arange(n)
        entries = rng.choice(pool, size=min(self.n_entry_points, len(pool)),
                             replace=False).astype(np.int32)
        self.neighbors = _rows_tensor(adj, self.device)
        self.entry_points = _rows_tensor(entries, self.device)
        self._refresh_entry_sample(vecs, pool, rng)
        self.built_rows = n
        self._full_built_rows = n

    @property
    def stale_fraction(self) -> float:
        """Fraction of rows inserted incrementally since the last full build
        (rebuild policy input: edges of pre-existing nodes are only patched,
        not re-derived, by `add`)."""
        if self.built_rows == 0:
            return 0.0
        return (self.built_rows - self._full_built_rows) / self.built_rows

    def _ensure_adj_capacity(self, need: int) -> None:
        have = 0 if self.neighbors is None else int(self.neighbors.shape[0])
        if need <= have:
            return
        new_cap = max(have, 256)
        while new_cap < need:
            new_cap *= 2
        grown = torch.full((new_cap, self.degree + self.n_long_edges), -1,
                           dtype=torch.int32, device=self.device)
        if self.neighbors is not None:
            grown[:have] = self.neighbors
        self.neighbors = grown

    def add(self, vecs_dev: Vectors, start_row: int, n_new: int,
            valid: Optional[np.ndarray] = None, block: int = 4096) -> None:
        """Incrementally insert rows [start_row, start_row + n_new).

        vecs_dev: (>= start_row + n_new, D) row-aligned vectors (the engine's
        resident `vecs` works as-is; rows past the new ones are masked).
        Out-edges are the exact top-`degree` over the live corpus; back-edges
        make the new nodes reachable by evicting the weakest current KNN edge
        of each new node's nearest neighbors. Long-edge slots are kept."""
        if n_new <= 0:
            return
        if self.built_rows == 0:
            raise RuntimeError("add() requires a built graph (call build first)")
        total = start_row + n_new
        deg, nlong = self.degree, self.n_long_edges
        dev = self.device
        vdev = vecs_dev if isinstance(vecs_dev, torch.Tensor) else \
            _as_tensor(vecs_dev, dev, torch.float32)
        n_rows = int(vdev.shape[0])
        live = np.zeros((n_rows,), bool)
        if valid is not None:
            v = np.asarray(valid)[:total]
            live[: v.shape[0]] = v
        else:
            live[:total] = True
        live[total:] = False
        mask_dev = _rows_tensor(live, dev)
        self._ensure_adj_capacity(total)

        # -- out-edges: exact KNN of each new row over the live corpus ------
        pend_s, pend_i = [], []
        for s in range(start_row, total, block):
            e = min(s + block, total)
            qrows = torch.arange(s, e, dtype=torch.int32, device=dev)
            top_s, top_i = _knn_block(vdev, mask_dev, vdev[s:e], qrows, deg)
            pend_s.append(top_s)
            pend_i.append(top_i)
        new_rows = np.arange(start_row, total, dtype=np.int32)
        nbrs = torch.cat(pend_i).cpu().numpy()
        nscr = torch.cat(pend_s).cpu().numpy()
        dead = nscr <= NEG_INF / 2  # fewer live rows than degree
        nbrs[dead] = -1
        rng = np.random.default_rng(self.seed + start_row)
        adj_new = np.full((n_new, deg + nlong), -1, np.int32)
        adj_new[:, :deg] = nbrs
        if nlong > 0:
            adj_new[:, deg:] = rng.integers(0, total, (n_new, nlong),
                                            dtype=np.int32)
        self.neighbors = _scatter_adj(self.neighbors, _rows_tensor(new_rows, dev),
                                      _rows_tensor(adj_new, dev))

        # -- back-edges: weakest-KNN-edge replacement on the targets --------
        e_flat = nbrs.reshape(-1)
        v_flat = np.repeat(new_rows, deg)
        s_flat = nscr.reshape(-1)
        keep = e_flat >= 0
        e_flat, v_flat, s_flat = e_flat[keep], v_flat[keep], s_flat[keep]
        if e_flat.size:
            order = np.argsort(e_flat, kind="stable")
            e_s, v_s, s_s = e_flat[order], v_flat[order], s_flat[order]
            uniq, starts, counts = np.unique(e_s, return_index=True,
                                             return_counts=True)
            cmax = int(counts.max())
            cand_ids = np.full((len(uniq), cmax), -1, np.int32)
            cand_scr = np.full((len(uniq), cmax), np.float32(NEG_INF))
            cols = np.arange(len(e_s)) - starts.repeat(counts)
            rowi = np.arange(len(uniq)).repeat(counts)
            cand_ids[rowi, cols] = v_s
            cand_scr[rowi, cols] = s_s
            # fetch only the target rows' adjacency
            uniq_dev = _rows_tensor(uniq.astype(np.int32), dev)
            cur_rows = self.neighbors[uniq_dev.long()].cpu().numpy()
            cur_adj = cur_rows[:, :deg]
            # drop candidates already present as edges (two new nodes that
            # are mutual nearest neighbors would otherwise occupy two slots)
            for cs in range(0, len(uniq), 65536):
                ce = min(cs + 65536, len(uniq))
                dup = (cand_ids[cs:ce, :, None] == cur_adj[cs:ce, None, :]).any(-1)
                cand_scr[cs:ce][dup] = np.float32(NEG_INF)
                cand_ids[cs:ce][dup] = -1
            cur_adj_dev = _rows_tensor(np.ascontiguousarray(cur_adj), dev)
            pend = [_edge_scores(vdev, mask_dev, uniq_dev[s:s + block], cur_adj_dev[s:s + block])
                    for s in range(0, len(uniq), block)]
            cur_scr = torch.cat(pend).cpu().numpy()
            merged_ids = np.concatenate([cur_adj, cand_ids], axis=1)
            merged_scr = np.concatenate([cur_scr, cand_scr], axis=1)
            sel = np.argsort(-merged_scr, axis=1, kind="stable")[:, :deg]
            new_knn = np.take_along_axis(merged_ids, sel, axis=1)
            new_knn_scr = np.take_along_axis(merged_scr, sel, axis=1)
            new_knn[new_knn_scr <= NEG_INF / 2] = -1
            updated = cur_rows
            updated[:, :deg] = new_knn
            self.neighbors = _scatter_adj(self.neighbors, uniq_dev,
                                          _rows_tensor(updated, dev))

        self.built_rows = total
        # refresh entry points + coarse-entry sample so new regions are
        # directly enterable
        pool = np.nonzero(live[:total])[0]
        if len(pool):
            entries = rng.choice(pool, size=min(self.n_entry_points, len(pool)),
                                 replace=False).astype(np.int32)
            self.entry_points = _rows_tensor(entries, dev)
            self._refresh_entry_sample(vdev, pool, rng)

    def search(self, vecs_dev: torch.Tensor, queries: np.ndarray, k: int,
               ef: int = 64, mask: Optional[torch.Tensor] = None,
               steps: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        if self.neighbors is None:
            raise RuntimeError("graph not built")
        qdev = _rows_tensor(np.asarray(queries, np.float32), self.device)
        ef = max(ef, k)
        s, i = graph_search(vecs_dev, self.neighbors, self.entry_points, qdev,
                            mask, k, ef=ef, steps=steps or self.steps,
                            entry_sample_rows=self.entry_sample_rows,
                            entry_sample_vecs=self.entry_sample_vecs)
        return s.cpu().numpy(), i.cpu().numpy().astype(np.int64)
