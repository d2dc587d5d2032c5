"""The fusion calibration the configuration states (retrieval
fusion_weighting "auto"), worked out again: which mode the fusion runs in
and with which leg weights.

  probes      the corpus rows in insertion order, shuffled by numpy's
              default_rng(seed); each row one draw r: r < paraphrase_share
              gives a paraphrase probe, the first m words from a start drawn
              in [0, max(1, W - 2m)) (no word of the vocabulary is a
              stopword or has a synonym, so none is dropped or swapped),
              else an ICT probe: a draw < 0.5 gives the lead m words, else m
              words from a start drawn in [0, max(1, W - m)); m = 8
  legs        the probes as host queries (float32 embeddings; rounded
              through float16 on the sketch route), the binary stage 1 at
              rescore multiplier 4, top 10 at the fused depth; each leg's
              MRR@10 of its probe's own row
  candidates  weighted RRF at the weights of fusion.calibrated_weights, and
              score fusion at dense weights 0.15, 0.3, 0.5, 0.7, 0.85, then
              +-0.05 and +-0.1 around the best of those; fused MRR@10 on the
              even probes (select) and the odd (confirm)
  one draw    the three best by select MRR (ties: weighted RRF first, then
              the lower dense weight), a later one taking over when its
              confirm MRR is higher by more than 0.005
  draws       seeds seed .. seed + seeds - 1; if their modes differ or their
              dense weights spread by more than 0.1, once more at twice the
              probes (at most 512)
  choice      over the candidates every draw scored, the mean of each draw's
              MRRs (each rounded to 4 places); the near set within 0.02 of
              the best select MRR; weighted RRF (at the median of the draws'
              weights) if the mean dense MRR is under a quarter of BM25's or
              no score weight is near; else the median near score weight, a
              near candidate taking over when its confirm MRR is higher by
              more than 0.03

The probes' embeddings are the port's (`embed`): the reference follows
them, and the judge holds them to its own (judge.py embed_gap).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from reference.fusion import calibrated_weights

PROBE_WORDS = 8
GRID = (0.15, 0.3, 0.5, 0.7, 0.85)
REFINE = (-0.1, -0.05, 0.05, 0.1)


def probes(words: np.ndarray, n: int, seed: int, paraphrase_share: float
           ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(target rows, each probe's word indices) of one draw."""
    rng = np.random.default_rng(seed)
    rows = list(range(words.shape[0]))
    rng.shuffle(rows)
    m, w = PROBE_WORDS, words.shape[1]
    targets, spans = [], []
    for r in rows[:n]:
        if rng.random() < paraphrase_share:
            start = int(rng.integers(0, max(1, w - 2 * m)))
        elif rng.random() < 0.5:
            start = 0
        elif w <= m:
            start = 0
        else:
            start = int(rng.integers(0, max(1, w - m)))
        targets.append(r)
        spans.append(words[r, start:start + m])
    return np.asarray(targets, np.int64), spans


def mrr(rows: np.ndarray, targets: np.ndarray, idxs) -> float:
    """Mean reciprocal rank of each probe's target among its live rows."""
    rr = 0.0
    for qi in idxs:
        hits = [int(r) for r in rows[qi] if r >= 0]
        if int(targets[qi]) in hits:
            rr += 1.0 / (hits.index(int(targets[qi])) + 1)
    return rr / max(1, len(idxs))


def _key(mode: str, w: np.ndarray) -> str:
    return mode if mode == "confidence" else f"score@{w[0]:.2f}"


def one_draw(search: Callable, words: np.ndarray, n: int, seed: int,
             paraphrase_share: float) -> Dict:
    """search(targets, spans, mode, weights) -> (dense rows, bm25 rows, fused
    rows), each (n, 10) int64."""
    targets, spans = probes(words, n, seed, paraphrase_share)
    sel, conf = np.arange(0, len(spans), 2), np.arange(1, len(spans), 2)
    d_rows, b_rows, _ = search(spans, "equal", np.asarray([0.5, 0.5], np.float32))
    every = range(len(spans))
    m_d, m_b = mrr(d_rows, targets, every), mrr(b_rows, targets, every)
    cal_w = np.asarray(calibrated_weights([m_d, m_b]), np.float32)
    done: Dict[str, Tuple[str, np.ndarray, float, float]] = {}

    def evaluate(mode: str, w: np.ndarray) -> None:
        if _key(mode, w) not in done:
            fused = search(spans, mode, w)[2]
            done[_key(mode, w)] = (mode, w, mrr(fused, targets, sel), mrr(fused, targets, conf))

    evaluate("confidence", cal_w)
    for wd in GRID:
        evaluate("score", np.asarray([wd, 1.0 - wd], np.float32))
    best_score = max((c for c in done.values() if c[0] == "score"), key=lambda c: c[2])
    w0 = float(best_score[1][0])
    for dw in REFINE:
        wd = round(min(0.95, max(0.05, w0 + dw)), 2)
        evaluate("score", np.asarray([wd, 1.0 - wd], np.float32))
    ranked = sorted(done.values(), key=lambda c: (-c[2], c[0] != "confidence", c[1][0]))
    best = ranked[0]
    for c in ranked[1:3]:
        if c[3] > best[3] + 0.005:
            best = c
    return {"dense_mrr": round(m_d, 4), "bm25_mrr": round(m_b, 4),
            "mode": best[0], "w_dense": float(best[1][0]),
            "confidence_weights": [float(x) for x in cal_w],
            "scored": {k: (round(s, 4), round(c, 4)) for k, (_, _, s, c) in done.items()}}


def calibrate(search: Callable, words: np.ndarray, n_probes: int, seeds: int,
              paraphrase_share: float, seed: int = 0, max_probes: int = 512
              ) -> Tuple[str, List[float], Dict]:
    """(mode, leg weights (float32 values), a summary)."""
    n = n_probes
    for _ in range(2):
        runs = [one_draw(search, words, n, seed + i, paraphrase_share)
                for i in range(max(1, seeds))]
        spread = max(r["w_dense"] for r in runs) - min(r["w_dense"] for r in runs)
        if (len({r["mode"] for r in runs}) == 1 and spread <= 0.1) or n >= max_probes:
            break
        n = min(n * 2, max_probes)
    pool: Dict[str, List[Tuple[float, float]]] = {}
    for r in runs:
        for k, sc in r["scored"].items():
            pool.setdefault(k, []).append(sc)
    full = {k: v for k, v in pool.items() if len(v) == len(runs)} or pool
    stats = {k: (float(np.mean([s for s, _ in v])), float(np.mean([c for _, c in v])))
             for k, v in full.items()}
    top = max(s for s, _ in stats.values())
    near = sorted(k for k, (s, _) in stats.items() if s >= top - 0.02)
    m_d = float(np.mean([r["dense_mrr"] for r in runs]))
    m_b = float(np.mean([r["bm25_mrr"] for r in runs]))
    score_ws = sorted(float(k.split("@")[1]) for k in near if k.startswith("score@"))
    if m_d < 0.25 * m_b or not score_ws:
        best = "confidence"
    else:
        best = f"score@{score_ws[len(score_ws) // 2]:.2f}"
        for k in near:
            if stats[k][1] > stats[best][1] + 0.03:
                best = k
    if best == "confidence":
        w = np.asarray(np.median([r["confidence_weights"] for r in runs], axis=0), np.float32)
    else:
        wd = float(best.split("@")[1])
        w = np.asarray([wd, 1.0 - wd], np.float32)
    mode = "confidence" if best == "confidence" else "score"
    summary = {"mode": mode, "weights": [float(x) for x in w], "dense_mrr": m_d,
               "bm25_mrr": m_b, "probes": n}
    return mode, [float(x) for x in w], summary


def texts_of(spans: Sequence[np.ndarray], vocab: Sequence[str]) -> Tuple[str, ...]:
    return tuple(" ".join(vocab[t] for t in s.tolist()) for s in spans)
