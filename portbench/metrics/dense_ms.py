"""dense_ms: device milliseconds per request of the operations launched
inside the program's "hybrid.dense" span (`HybridSearcher.search_rows`'
dense leg: row mask, stage-1 scan, rescore)."""

from pbcore.readers import program_span_ms


def read(run):
    return program_span_ms(run, "hybrid.dense")
