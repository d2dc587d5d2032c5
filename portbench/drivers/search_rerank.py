"""Hybrid search then cross-encoder rerank: one request is one batch of
text queries through embed_queries_device -> search_rows(_qdev) -> the
fused rows and scores fetched -> DeviceReranker.rerank_rows(texts, rows,
top_k, prior_scores=fused scores, prior_weight) (the rerank agent's blend).

A request's outputs: the query embeddings on the device, the legs, and the
reranked (logits, rows).
"""

from __future__ import annotations


class Driver:
    def __init__(self, system, queries, tracer) -> None:
        self.system, self.queries, self.tracer = system, queries, tracer

    def issue(self, i: int):
        texts = self.queries.texts[i]
        with self.tracer.span("embed"):
            qdev = self.system.embed(texts)
        with self.tracer.span("search"):
            res = self.system.search(texts, qdev=qdev, fetch=True)
        with self.tracer.span("rerank"):
            reranked = self.system.rerank(texts, res["fused"])
        out = {leg: res[leg] for leg in ("dense", "bm25", "fused")}
        out["qdev"] = qdev
        out["rerank"] = reranked
        return out

    def complete(self, pending):
        return pending
