"""Fused hybrid search: one request is one batch through the app's fused
searcher, `in_flight` requests queued before the oldest is fetched (as
`search_batch_async` and the coalescer do).

  text queries    embed_queries_device -> search_rows(_qdev, fetch=False)
  vector queries  search_rows(vectors, texts, fetch=False)

A request's outputs: the query embeddings on the device (text queries) and
the fetched legs: dense, bm25 and fused (scores, rows).
"""

from __future__ import annotations


class Driver:
    def __init__(self, system, queries, tracer) -> None:
        self.system, self.queries, self.tracer = system, queries, tracer
        self.text = system.traffic["query_form"] == "text"

    def issue(self, i: int):
        texts = self.queries.texts[i]
        qdev = None
        if self.text:
            with self.tracer.span("embed"):
                qdev = self.system.embed(texts)
            with self.tracer.span("search"):
                _, unpack = self.system.search(texts, qdev=qdev, fetch=False)
        else:
            with self.tracer.span("search"):
                _, unpack = self.system.search(texts, vectors=self.queries.vectors[i],
                                               fetch=False)
        return qdev, unpack

    def complete(self, pending):
        qdev, unpack = pending
        with self.tracer.span("fetch"):
            res = unpack()
        out = {leg: res[leg] for leg in ("dense", "bm25", "fused")}
        if qdev is not None:
            out["qdev"] = qdev
        return out
