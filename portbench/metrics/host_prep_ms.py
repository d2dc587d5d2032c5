"""host_prep_ms: host milliseconds per request inside any of the program's
"*.prep" spans (tokenizing, padding, query terms and uploads before a
stage's device work: "embed.prep", "hybrid.prep", "hybrid.bm25.prep",
"rerank.prep"), less the time in full garbage collections ("gc")."""

from pbcore.readers import program_host_ms


def read(run):
    return program_host_ms(run, lambda name: name.endswith(".prep"), less=("gc",))
