"""bm25_ms: device milliseconds per request of the operations launched
inside the program's "hybrid.bm25" span (`HybridSearcher.search_rows`'
BM25 leg, its "hybrid.bm25.prep" uploads included: sketch scan and exact
rescore, or the pages route)."""

from pbcore.readers import program_span_ms


def read(run):
    return program_span_ms(run, "hybrid.bm25")
