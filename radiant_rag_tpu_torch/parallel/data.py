"""Probe queries for fusion calibration: the pseudo-query makers.

The port's copy of `make_pseudo_query`, `make_paraphrase_query` and the
`_SENT_RE`, `SYNONYMS` and `STOPWORDS` tables they read, from
`radiant_rag_tpu/parallel/data.py`, unchanged: a probe drawn from the same
text with the same numpy generator is the same string in both packages.
`HybridSearcher.calibrate_fusion` makes its self-retrieval probes with them.
The training side of that module (`train_embedder`, `paraphrase_augment`,
the pair samplers) waits for ROADMAP queue A item 12.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def make_pseudo_query(text: str, rng: np.random.Generator,
                      max_words: int = 12) -> str:
    """A query-like span: the lead sentence, or a random window of words."""
    sentences = [s for s in _SENT_RE.split(text[:1000]) if len(s.split()) >= 3]
    if sentences and rng.random() < 0.5:
        return " ".join(sentences[0].split()[:max_words])
    words = text.split()
    if len(words) <= max_words:
        return text
    start = int(rng.integers(0, max(1, len(words) - max_words)))
    return " ".join(words[start : start + max_words])


# Technical-domain synonym map used two ways: (a) paraphrase-style probe
# queries for fusion calibration — a probe whose content words are swapped
# for synonyms measures the dense leg on the semantic gap it exists for,
# where ICT spans only measure verbatim match; (b) query augmentation during
# contrastive training (`synonym_augment`) so the encoder learns those
# correspondences instead of only span identity. ICT-only probes were the
# round-3 conservatism source (VERDICT r3 weak #2).
SYNONYMS = {
    "fast": "quick", "quick": "rapid", "slow": "sluggish", "speed": "pace",
    "error": "fault", "errors": "faults", "failure": "breakdown",
    "function": "routine", "functions": "routines", "method": "procedure",
    "methods": "procedures", "parameter": "argument", "parameters": "arguments",
    "argument": "input value", "arguments": "input values",
    "return": "give back", "returns": "gives back", "result": "outcome",
    "results": "outcomes", "value": "quantity", "values": "quantities",
    "array": "grid of numbers", "arrays": "grids of numbers",
    "matrix": "rectangular array", "vector": "one dimensional array",
    "compute": "calculate", "computes": "calculates",
    "computation": "calculation", "calculate": "work out",
    "create": "make", "creates": "makes", "build": "construct",
    "builds": "constructs", "delete": "remove", "removed": "deleted",
    "store": "keep", "stores": "keeps", "storage": "persistence",
    "memory": "ram", "cache": "fast lookaside store",
    "search": "look up", "find": "locate", "finds": "locates",
    "query": "request", "queries": "requests", "index": "lookup structure",
    "document": "text record", "documents": "text records",
    "model": "learned network", "models": "learned networks",
    "train": "fit", "training": "fitting", "trained": "fitted",
    "weights": "learned coefficients", "gradient": "derivative signal",
    "batch": "group", "batches": "groups", "size": "extent",
    "shape": "dimensions", "type": "kind", "types": "kinds",
    "large": "big", "small": "tiny", "default": "preset choice",
    "config": "settings", "configuration": "settings",
    "file": "saved record", "files": "saved records", "path": "location",
    "directory": "folder", "load": "read in", "loads": "reads in",
    "save": "write out", "saves": "writes out", "input": "incoming data",
    "output": "produced data", "test": "check", "tests": "checks",
    "example": "sample", "examples": "samples", "support": "allow",
    "supports": "allows", "requires": "needs", "required": "needed",
    "optional": "not mandatory", "performance": "efficiency",
    "slice": "sub range", "dimension": "axis extent", "random": "stochastic",
    "distribution": "spread of values", "precision": "numeric accuracy",
    "token": "text unit", "tokens": "text units", "string": "text sequence",
    "number": "numeric amount", "numbers": "numeric amounts",
    "process": "handle", "processing": "handling", "server": "service host",
    "client": "caller", "thread": "execution lane", "threads": "execution lanes",
    "device": "accelerator", "devices": "accelerators", "chip": "accelerator die",
    "kernel": "compute routine", "compile": "translate to machine code",
    "compiled": "translated to machine code", "graph": "node link structure",
    "layer": "network stage", "layers": "network stages",
    "attention": "token mixing mechanism", "embedding": "dense representation",
    "embeddings": "dense representations", "similarity": "closeness",
    "distance": "separation", "score": "rating", "scores": "ratings",
    "rank": "ordering position", "retrieval": "fetching relevant items",
}

STOPWORDS = set(
    "the a an of to in for on with and or is are was were be been this "
    "that these those it its as by from at which when if then else not "
    "no all any each such same than but into over under also can may "
    "will would should could has have had do does did done".split())


def make_paraphrase_query(text: str, rng: np.random.Generator,
                          max_words: int = 9) -> str:
    """A probe query whose content words are synonym-swapped, so exact
    lexical match fails wherever a synonym exists (the dense leg's job)."""
    words = [w for w in text.split() if w.strip()]
    start = int(rng.integers(0, max(1, len(words) - max_words * 2)))
    out: List[str] = []
    for w in words[start : start + max_words * 2]:
        lw = "".join(ch for ch in w.lower() if ch.isalnum())
        if not lw or lw in STOPWORDS:
            continue
        out.extend(SYNONYMS.get(lw, lw).split())
        if len(out) >= max_words:
            break
    if not out:
        out = [w.lower() for w in words[start : start + max_words]]
    return " ".join(out)
