"""Seeded inputs of the BM25 candidate rescore (`ops/cuda_kernels.py`
`bm25_rescore_topk`), with its edges, for the CPU and the card tests."""

from __future__ import annotations

import numpy as np

VOCAB = 521  # term ids; a prime, so a row's ids (a + j s) mod VOCAB are distinct
TIE_SOURCE = 5  # rows n - 1 and n // 2 copy this row: exact ties between rows


def rescore_inputs(seed: int, n: int, b: int, kc: int, width: int, t: int):
    """numpy (dm_tids, dm_tfs, doc_lens, avgdl, cand, q_tids, q_idfs).

    Doc-major rows of every length (every 7th full: no -1 slot); three rows
    with one content, listed first in every query's candidates, highest row
    first; -1 pads scattered over query 1's candidates and filling query
    2's; query 0 with the tied rows' terms, query 3 without a term, query 4
    with a term id in two slots; live
    term slots scattered among dead ones, which hold idfs that must not
    count. Query terms come from a candidate's row, the tied rows and the
    vocabulary, so most candidates match some."""
    rng = np.random.default_rng(seed)
    j = np.arange(width)
    start = rng.integers(0, VOCAB, (n, 1))
    step = rng.integers(1, VOCAB, (n, 1))
    dm_tids = ((start + j * step) % VOCAB).astype(np.int32)
    lens = rng.integers(0, width + 1, n)
    lens[::7] = width
    lens[TIE_SOURCE] = width // 2 + 1
    dm_tids[j[None, :] >= lens[:, None]] = -1
    dm_tfs = np.where(dm_tids >= 0, rng.integers(1, 8, (n, width)), 0).astype(np.int32)
    doc_lens = rng.integers(1, 400, n).astype(np.float32)
    tie_rows = [n - 1, n // 2, TIE_SOURCE]
    for r in tie_rows[:2]:
        dm_tids[r], dm_tfs[r], doc_lens[r] = dm_tids[TIE_SOURCE], dm_tfs[TIE_SOURCE], \
            doc_lens[TIE_SOURCE]
    cand = rng.integers(0, n, (b, kc)).astype(np.int32)
    cand[:, :min(3, kc)] = tie_rows[:kc]
    if b > 1:
        cand[1, rng.random(kc) < 0.3] = -1
    if b > 2:
        cand[2] = -1
    q_tids = np.full((b, t), -1, np.int32)
    for i in range(b):
        src = cand[i, rng.integers(0, kc)]
        pool = np.unique(np.concatenate([dm_tids[max(src, 0)], dm_tids[TIE_SOURCE],
                                         rng.integers(0, VOCAB, 8)]))
        pool = pool[pool >= 0]
        m = min(int(rng.integers(1, t + 1)), pool.size) if t else 0
        q_tids[i, rng.choice(t, m, replace=False)] = rng.choice(pool, m, replace=False)
    own = dm_tids[TIE_SOURCE][dm_tids[TIE_SOURCE] >= 0][:t]
    q_tids[0] = -1
    q_tids[0, :own.size] = own  # the tied rows match every term of query 0
    if b > 3:
        q_tids[3] = -1
    if b > 4 and t > 1:
        q_tids[4, :2] = dm_tids[TIE_SOURCE, 0]
    q_idfs = rng.uniform(0.05, 6.0, (b, t)).astype(np.float32)
    return dm_tids, dm_tfs, doc_lens, np.float32(doc_lens.mean()), cand, q_tids, q_idfs
