"""fuse_ms: device milliseconds per request of the operations launched
inside the program's "hybrid.fuse" span (`HybridSearcher.search_rows`'
fusion of the two legs and the packing of the result)."""

from pbcore.readers import program_span_ms


def read(run):
    return program_span_ms(run, "hybrid.fuse")
