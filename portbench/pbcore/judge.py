"""The comparison that decides `correct`.

After the window the harness frees the port's state and builds the plain
reference (`reference/`) from the inputs it made. It then judges the
outputs the timed path produced for a sample of its requests (drawn from
the seed among those that finished), stage by stage:

  embed_gap   largest |port - reference| of a query embedding coordinate
  dense_gap   per query and rank j < top_k: |ref_j - ref(port row j)| and
              |port score j - ref(port row j)|, ref() the float64 dot with
              the stored vectors (dequantised codes where none are stored),
              ref_j the reference leg's j-th row; the largest, in cosine units
  bm25_gap    the same over exact BM25, as a share of the query's best
              reference score
  fused_gap   the same over the fused (weighted RRF) score, as a share of
              the query's best reference fused score
  ce_gap      largest |port logit - reference logit| over the reranked
              rows, as a share of max(1, the query's largest |logit|)
  rerank_gap  per rank j < top_k: |ref_j - ref(port row j)| of the blend
              score z(logit) + w z(prior), in z units

Each of the traffic's stages (stages/<stage>.py) then judges its own
outputs (`judge(world, batch, out)`, after the numbers above) and stands
in the port's place for the control (`outputs(world, batch, prec)`); a
stage reads the corpus, the seed and the device from the world.

A rank holding a row on one side and none on the other reads 1. The
reference follows the port's own state in three places, each judged by
itself first: the dense and BM25 legs start from the port's query
embeddings (embed_gap judges them); the fusion's mode and weights come
from the calibration worked out again (reference/calibration.py) over the
same probes, which start from the port's probe embeddings (embed_gap
judges them too, in the cells that judge it; a probe the port did not
embed reads fused_gap 1); and the rerank takes the port's fused rows and
scores as its candidates and prior (fused_gap judges them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference import calibration as rcal
from reference import dense as rd
from reference import encoder as renc
from reference import fusion as rfu
from reference import lexical as rlex
from reference import rerank as rrr
from reference.precision import CONTROL, FULL, Precision, tf32_off
from reference.text import single_token_words

MISSING = 1.0


@dataclasses.dataclass
class Batch:
    """One sampled request: its inputs and the outputs judged."""
    texts: List[str]  # the whole batch's query texts
    words: np.ndarray  # (B, query_words) word indices
    vectors: Optional[np.ndarray]  # (B, D) for vector queries
    pick: np.ndarray  # the judged queries' positions in the batch
    out: Dict  # stage -> tensors/arrays of the judged queries


def _gap(ref_sorted: torch.Tensor, ref_of_port: torch.Tensor,
         port_scores: Optional[torch.Tensor], scale: torch.Tensor) -> float:
    """Largest gap per rank (module doc); -inf marks an empty rank."""
    a_live, b_live = torch.isfinite(ref_sorted), torch.isfinite(ref_of_port)
    g = torch.where(a_live & b_live, (ref_sorted - ref_of_port).abs(), 0.0)
    g = torch.where(a_live ^ b_live, MISSING * scale, g)
    if port_scores is not None:
        g = torch.maximum(g, torch.where(b_live, (port_scores.double() - ref_of_port).abs(), 0.0))
    return float((g / scale).max()) if g.numel() else 0.0


def _neg(x: torch.Tensor) -> torch.Tensor:
    """float64 with the port's empty-slot scores (<= -1e29) as -inf."""
    x = x.double()
    return torch.where(x > -1e29, x, float("-inf"))


class World:
    """The reference's state: what the port derives in set-up, worked out again."""

    def __init__(self, config: Dict, traffic: Dict, plan: Dict, corpus, params: Dict,
                 device, row_capacity: int, probe_embeddings: Dict[tuple, np.ndarray],
                 seed: int, stages: Sequence = ()) -> None:
        self.config, self.traffic, self.plan = config, traffic, plan
        self.seed, self.stages = seed, list(stages)
        self.row_capacity = row_capacity
        self.pc = config["program_config"]
        self.device = device
        self.corpus = corpus
        self.params = params
        if not single_token_words(corpus.word_strings):
            raise ValueError("the reference reads words as tokens: a word is not one token")
        vecs = corpus.vecs
        first = min(int(config["ingest_batch"]), vecs.shape[0])
        calib = min(first, int(config["int8_calibration_rows"])) if plan["store_fp32"] else first
        self.lo, self.hi = rd.int8_ranges(vecs[:calib])
        self.codes = rd.int8_codes(vecs, self.lo, self.hi)
        self.s, self.o = rd.scale_offset(self.lo, self.hi)
        self.binary = plan["dense_stage1"] == "binary"
        self.csign = rd.sign_matrix(vecs)  # the calibration's probes take the binary stage 1
        self.codes_f = None if self.binary else self.codes.to(torch.float32)
        self.vectors = vecs if plan["store_fp32"] else None
        self.dequant = None if plan["store_fp32"] else (self.codes, self.s, self.o)
        self.lex = rlex.build(corpus.words, corpus.word_strings, self.pc["bm25"], device)
        self.probe_embeddings = probe_embeddings
        self.probe_gap = 0.0
        self.probes_followed = True
        self.mode, self.weights, self.calibration = self._calibrate()

    # -- stages ---------------------------------------------------------------
    def embed(self, texts: Sequence[str], prec: Precision = FULL) -> torch.Tensor:
        return renc.embed_texts(self.params["embedder"], self.config, texts,
                                self.device, prec)

    def dense_leg(self, q: torch.Tensor, prec: Precision = FULL, binary: Optional[bool] = None,
                  depth: Optional[int] = None, kc: Optional[int] = None):
        depth = self.plan["depth"] if depth is None else depth
        kc = self.plan["candidates"] if kc is None else kc
        if self.binary if binary is None else binary:
            cand = rd.stage1(self.csign, rd.sign_matrix(q), kc)
        else:
            cand = rd.stage1(self.codes_f, rd.int8_queries(q, self.s), kc)
        return rd.rescore(q, cand, self.vectors, depth, prec, self.dequant)

    def bm25_leg(self, tids: np.ndarray, pages: bool, prec: Precision = FULL,
                 depth: Optional[int] = None, kc: Optional[int] = None):
        depth = self.plan["depth"] if depth is None else depth
        if pages:
            return rlex.pages_leg(self.lex, tids, depth,
                                  int(self.pc["bm25"]["max_postings_per_query"]), prec)
        kc = self.plan["candidates"] if kc is None else kc
        return rlex.sketch_leg(self.lex, tids, kc, depth, prec)

    def fuse(self, legs, leg_scores, k: int, prec: Precision = FULL):
        return rfu.fuse(self.mode, legs, leg_scores, self.weights,
                        int(self.pc["retrieval"]["rrf_k"]), k, prec)

    def tids(self, words: np.ndarray) -> np.ndarray:
        return rlex.query_terms(self.lex, words, int(self.pc["bm25"]["max_query_terms"]))

    def route_pages(self, words: np.ndarray) -> bool:
        return rlex.routes_pages(self.lex, self.tids(words),
                                 {**self.pc["bm25"], **self.config}, self.row_capacity)

    def queries(self, batch: Batch, qdev: Optional[torch.Tensor], pages: bool) -> torch.Tensor:
        """The dense leg's query vectors: the embeddings, or the given
        vectors (rounded through float16 on the sketch route, as the port's
        host path does)."""
        if qdev is not None:
            return qdev.to(self.device, torch.float32)
        return self._host_queries(batch.vectors[batch.pick], pages)

    def _host_queries(self, v: np.ndarray, pages: bool) -> torch.Tensor:
        if not pages:
            v = v.astype(np.float16).astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(self.device)

    # -- the fusion calibration -------------------------------------------------
    def _probe_vectors(self, spans) -> np.ndarray:
        """The port's embeddings of the probes' texts; where the port
        embedded no such batch, the reference's own, and the fusion judged
        as not followed."""
        texts = rcal.texts_of(spans, self.corpus.word_strings)
        ref = self.embed(list(texts))
        port = self.probe_embeddings.get(texts)
        if port is None:
            self.probes_followed = False
            return ref.cpu().numpy()
        self.probe_gap = max(self.probe_gap, float(
            (torch.from_numpy(port).to(self.device) - ref).abs().max()))
        return port

    def _calibrate(self):
        r = self.pc["retrieval"]
        if r["fusion_weighting"] == "equal":
            return "equal", [1.0, 1.0], {"mode": "equal"}
        fd = int(r["fused_depth"])
        fd = 4 * int(r["fused_top_k"]) if fd < 0 else fd
        top = 10
        depth = max(top, min(fd, self.corpus.words.shape[0]))
        kc = max(depth, int(round(depth * 4.0)))
        rrf_k = 60
        cache: Dict[int, tuple] = {}

        def search(spans, mode, w):
            key = id(spans)
            if key not in cache:
                words = np.stack(spans)
                tids = self.tids(words)
                pages = rlex.routes_pages(self.lex, tids, {**self.pc["bm25"], **self.config},
                                          self.row_capacity)
                q = self._host_queries(self._probe_vectors(spans), pages)
                ds, dr = self.dense_leg(q, binary=True, depth=depth, kc=kc)
                bs, br = self.bm25_leg(tids, pages, depth=depth, kc=kc)
                cache.clear()
                cache[key] = (spans, ds, dr, bs, br)
            _, ds, dr, bs, br = cache[key]
            _, fr = rfu.fuse(mode, [dr, br], [ds, bs], [float(x) for x in w], rrf_k, top)
            return (dr[:, :top].cpu().numpy(), br[:, :top].cpu().numpy(), fr.cpu().numpy())

        with torch.no_grad(), tf32_off():
            return rcal.calibrate(search, self.corpus.words, int(r["calibration_probes"]),
                                  int(r["calibration_seeds"]),
                                  float(r["calibration_paraphrase_fraction"]))

    # -- the reference in the port's place --------------------------------------
    def outputs(self, batch: Batch, prec: Precision = FULL) -> Dict:
        """What the port's timed path returns for the judged queries, computed
        by the reference at `prec` (the control at CONTROL)."""
        k = int(self.traffic["top_k"])
        pages = self.route_pages(batch.words)
        out: Dict = {}
        qdev = None
        if self.traffic["query_form"] == "text":
            qdev = self.embed([batch.texts[i] for i in batch.pick], prec)
            out["qdev"] = qdev
        q = self.queries(batch, qdev, pages)
        ds, dr = self.dense_leg(q, prec)
        bs, br = self.bm25_leg(self.tids(batch.words[batch.pick]), pages, prec)
        fs, fr = self.fuse([dr, br], [ds, bs], min(k, 2 * self.plan["depth"]), prec)
        out["dense"], out["bm25"], out["fused"] = (ds[:, :k], dr[:, :k]), (bs[:, :k], br[:, :k]), \
            (fs, fr)
        rr = self.traffic.get("rerank")
        if rr:
            logits, blend = self._rerank(batch, fr, fs, prec)
            order = torch.sort(blend, dim=1, descending=True, stable=True).indices
            order = order[:, :int(rr["top_k"])]
            rows = fr.gather(1, order)
            out["rerank"] = (torch.where(rows >= 0, logits.gather(1, order), float("-inf")),
                             rows)
        for st in self.stages:
            out.update(st.outputs(self, batch, prec))
        return out

    def _rerank(self, batch: Batch, rows: torch.Tensor, prior: torch.Tensor,
                prec: Precision = FULL):
        rr = self.traffic["rerank"]
        texts = [batch.texts[i] for i in batch.pick]
        qs, ds = [], []
        rows_h = rows.cpu().numpy()
        for i, r in enumerate(rows_h):
            for row in r:
                qs.append(texts[i])
                ds.append(self.corpus.texts[int(row)] if row >= 0 else "")
        logits = renc.pair_logits(self.params["cross_encoder"], self.config, qs, ds,
                                  int(rr["q_len"]), int(rr["d_len"]), self.device, prec)
        logits = logits.view(rows.shape)
        prior = torch.nan_to_num(prior.to(self.device, torch.float32), neginf=0.0, posinf=0.0)
        blend = rrr.blend(logits, prior, rows >= 0, float(rr["prior_weight"]), prec)
        return logits, blend

    # -- the judge ---------------------------------------------------------------
    def judge(self, batch: Batch, out: Dict) -> Dict[str, float]:
        k = int(self.traffic["top_k"])
        pages = self.route_pages(batch.words)
        nums: Dict[str, float] = {}
        qdev = out.get("qdev")
        if qdev is not None:
            ref_q = self.embed([batch.texts[i] for i in batch.pick])
            nums["embed_gap"] = max(self.probe_gap, float(
                (qdev.to(self.device).float() - ref_q).abs().max()))
        q = self.queries(batch, qdev, pages)
        dev = self.device

        def t(x, dtype=None):
            x = torch.as_tensor(x).to(dev)
            return x if dtype is None else x.to(dtype)

        # dense (the reference leg at its full depth feeds the fusion below)
        ref_ds, ref_dr = self.dense_leg(q)
        ps, pr = (t(x) for x in out["dense"])
        one = torch.ones((q.shape[0], 1), dtype=torch.float64, device=dev)
        nums["dense_gap"] = _gap(rd.dot_scores(q, ref_dr[:, :k], self.vectors, self.dequant),
                                 rd.dot_scores(q, pr.long(), self.vectors, self.dequant),
                                 _neg(ps), one)
        # bm25
        tids = self.tids(batch.words[batch.pick])
        tt = torch.from_numpy(tids).to(dev)
        ref_bs, ref_br = self.bm25_leg(tids, pages)
        ps, pr = (t(x) for x in out["bm25"])
        scale = _neg(ref_bs[:, :1]).clamp_min(1e-6).nan_to_num(1.0, 1.0, 1.0)
        nums["bm25_gap"] = _gap(_neg(ref_bs[:, :k]),
                                _neg(rlex.exact_scores(self.lex, tt, pr.long())),
                                _neg(ps), scale)
        # fusion of the reference legs
        cand, score = rfu.fused_scores(self.mode, [ref_dr, ref_br], [ref_ds, ref_bs],
                                       self.weights, int(self.pc["retrieval"]["rrf_k"]))
        fk = min(k, 2 * self.plan["depth"])
        ref_fs, _ = rd.topk_first(score, fk)
        ps, pr = (t(x) for x in out["fused"])
        match = cand[:, None, :] == pr.long()[:, :, None]
        of_port = torch.where(match, score[:, None, :].double(), float("-inf")).amax(-1)
        of_port = torch.where((pr >= 0) & ~match.any(-1), 0.0, of_port)
        scale = _neg(ref_fs[:, :1]).clamp_min(1e-12)
        nums["fused_gap"] = _gap(_neg(ref_fs), of_port, _neg(ps), scale) \
            if self.probes_followed else MISSING
        if "rerank" in out:
            rr = self.traffic["rerank"]
            cand_r, prior = t(out["fused"][1]).long(), t(out["fused"][0])
            logits, blend = self._rerank(batch, cand_r, prior)
            ps, pr = (t(x) for x in out["rerank"])
            kk = int(rr["top_k"])
            ref_sorted = torch.sort(blend, dim=1, descending=True).values[:, :kk].double()
            pos = (cand_r[:, None, :] == pr.long()[:, :, None])
            found = pos.any(-1)
            slot = pos.float().argmax(-1)
            of_port = torch.where(found & (pr >= 0), blend.gather(1, slot).double(),
                                  float("-inf"))
            nums["rerank_gap"] = _gap(ref_sorted, of_port, None,
                                      torch.ones_like(ref_sorted[:, :1]))
            lg = torch.where(found & (pr >= 0), logits.gather(1, slot), 0.0)
            big = logits.abs().amax(1, keepdim=True).clamp_min(1.0)
            err = torch.where(found & (pr >= 0), (ps.float() - lg).abs(), 0.0) / big
            err = torch.where(found | (pr < 0), err, MISSING)
            nums["ce_gap"] = float(err.max())
        for st in self.stages:
            for name, v in st.judge(self, batch, out).items():
                if name in nums:
                    raise ValueError(f"stage {st.__name__}: number {name!r} is judged twice")
                nums[name] = float(v)
        return nums


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge_all(world: World, batches: List[Batch], prec: Optional[Precision] = None
              ) -> Dict[str, float]:
    """The worst reading of each number over the sampled requests: of the
    port's outputs, or (prec given) of the reference at `prec` in its place."""
    readings = []
    with torch.no_grad(), tf32_off():
        for b in batches:
            out = b.out if prec is None else world.outputs(b, prec)
            readings.append(world.judge(b, out))
    return worst(readings)

