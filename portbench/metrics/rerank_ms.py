"""rerank_ms: device milliseconds per request of the kernels launched under
the harness's "rerank" span (profiler correlation ids)."""

from pbcore.readers import span_ms


def read(run):
    return span_ms(run, "rerank")
