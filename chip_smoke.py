#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `radiant_rag_tpu_torch/csrc` (nvcc, into
`build/kernels`), holds every kernel against its plain PyTorch version at
edge shapes and at the main paths' own inputs, then drives two main paths
over the JAX package's bench corpus (bench.py's generator, made from a
seed: 1M docs of clustered 384-d vectors and zipfian 48-token texts):

  phase 4  `HybridSearcher.search_rows` over a `DeviceVectorIndex` +
           `BM25Index` at B = 2048, k = 10, fused_k = 15, int8 dense mode:
           the BM25 sketch route (fused depth 0 and 40), the block-max
           select, an auto-routed rare-term pages batch and fetch=False
           pipelining;
  phase 4q the quality-optimized preset (config.quality-optimized.example.yaml:
           dense_k = bm25_k = 20, fused_k = 30, auto fused depth 120 x
           rescore multiplier 8.0) over phase 4's engine and BM25 index:
           kc = 960 on both legs, past the scan kernels' lists, so stage 1
           takes the exact-product route through `int8_scores`;
  phase 5  the memory-optimized preset (config.memory-optimized.example.yaml:
           no fp32 vectors, binary Hamming stage 1, rescore multiplier 6.0,
           BM25 sketch S = 512) through its store layer: `create_vector_store`
           -> `TpuVectorStore.upsert_batch`, `PersistentBM25Index`, then
           `search_rows` at the auto fused depth (60), sequential and
           pipelined, one batch of queries nearer their documents, and
           `retrieve_by_embedding_batch`; the stored sign words are held
           against numpy's packing of the corpus vectors;
  phase 6  hybrid + rerank over phase 4's engine, BM25 index and corpus
           texts with MiniLM-L12-width models (hidden 384, 12 layers, 12
           heads, FFN 1536, vocab 30522; bf16, random weights from seeded
           generators, hash tokenizer): `LocalNLPModels.embed_device` via
           `embed_queries_device` -> `search_rows(_qdev=...)` at k = 40 ->
           `DeviceReranker.rerank_rows` of the fused top-40 to 10 over a
           token table of the 1M texts (q_len 31, d_len 93, L = 127, 4096
           pairs a chunk), with its stage times, the cross-encoder's rate,
           a profile and the checks of the models against host packing, the
           host embed path and a CPU float32 forward; then the shipped
           128 x 6 artifacts on the card against the CPU, and one batch at
           bench.py's cross-encoder shape;
  phase 7  the serving entry point at that width (after phase 5): a
           `TpuVectorStore` of the corpus under the default preset,
           `RadiantTPU` over it (its BM25 index built from the store),
           `ingest_chunks` of 16,384 more chunks, the fusion calibration
           the first search runs, `warmup`, then `make_server` on
           127.0.0.1 under 256 concurrent keep-alive clients through the
           request coalescer, a profiled window, the batch API at 2048
           queries, one batch's stage split and the dense leg's recall;
           every response is held against `search_batch` of its batch.
  phase 8  the agentic query path over phase 7's app and server, with a
           scripted mock LLM (`ScriptedLLM`: 8 effective queries a run,
           multihop on every fourth question, one critic retry on every
           other): 64 questions through `app.query` (default config; the
           rerank auto-disable probes run in the first), 64 through a
           second `RAGOrchestrator` with the rerank on every run (fused and
           reranked docs held against direct `search_rows` / store / BM25
           calls and `rerank.rerank`), 8 through one that compresses its
           context, then 16 concurrent `/query` beside `/search` load, a
           `/query/stream` and a two-turn conversation; per-run and
           per-phase ms, the device stages' ms, the cross-encoder's
           TFLOP/s, the idle share of 8 profiled runs, the launches by
           shape, and kernel rows for the shapes it adds.
  phase 9  training over phase 7's app: `app.train` (40 steps at batch
           256 with 2 BM25-mined hard negatives: 1,024 sequences a step,
           lr 1e-4, warmup + cosine, a checkpoint) and
           `train_cross_encoder` at the cross-encoder's width (20 steps of
           16 groups of 1 positive + 2 mined + 1 random negative) over the
           corpus texts and the app's BM25 index; step ms, tokens/s,
           TFLOP/s and the bf16 peak share, mining and sampler ms, the idle
           share of 4 profiled iterations, peak memory; checks: a bf16
           card step against a float32 CPU step, a repeated batch's
           falling loss, the checkpoint restored bit for bit by a fresh
           Embedder that embeds as the swapped encoder, the calibration
           run again, and kernel rows at the mining's shapes. (c) the dp x
           tp layout on logical shards: a (2, 2) mesh of cuda:0 against
           the (1, 1) mesh from one init over 3 mined batches of (a)'s
           shape, float32 and bf16, to the CPU tests' tolerances, then
           `train_cross_encoder` on (2, 1) against (1, 1); step ms, device
           work, launches and peak memory of each. (d) with more than one
           visible card only: the same on a real mesh of the cards and a
           two-rank NCCL `merge_across_processes`; otherwise one line
           says it did not run (not a pass).

  phase 10 the corpus-sharded pod store over phase 7's corpus (after phase
           9): `create_vector_store` with `index.backend: sharded` and
           `index.docstore: spill` (a mesh of every visible card, one
           shard here), its source filled by the load path from phase 7's
           store and docstore (migrated into the spill log), `RadiantTPU`
           over it; app.search_batch at buckets 1 to 2048 held against the
           plain kernels, the dense leg's recall, 4 logical shards of one
           card (exact mode against the single-device search, both legs
           against the plain kernels per shard), 16,384 chunks ingested into
           the delta segment (held against a host oracle of base + delta),
           tombstones and a rebase (held against a freshly built pod), 16
           app.query runs, /search under 256 clients, a one-rank NCCL group's
           merge, and the spill docstore's hydration, hit share, save and
           load; its kernel rows are the pod's shapes at N = rows_per_shard
           for 1 and 4 shards.
  phase 11 the graph engine over phase 7's corpus (after phase 10): a
           `TpuVectorStore` from `create_vector_store` with
           `index.use_graph: true`, filled by the same load path, and
           `RadiantTPU` over it; the exact build over the first 200,000
           rows held to the exact top-16, `store.build_graph()` over every
           row (NN-descent + cluster polish: rounds, per-round host ms and
           device span, structure, sampled edge agreement),
           `app.search_batch(mode="dense")` in graph mode at B = 1 to 2048
           (ms, QPS, the bound, a profile, recall@10 beside flat int8), the
           card's beam search held to the port's plain run on the CPU, the
           fused hybrid under use_graph held to mode="int8", and 16,384
           ingested chunks inserted by the query path (out-edges held to
           the exact top-16, back-edges to a numpy oracle of the
           weakest-edge rule). The graph path is plain PyTorch: no kernel
           row of its own.
  phase 12 the query path's host layers over phase 7's app (after phase
           11): the language phase (32 runs of phase 8's questions in
           German, French, Spanish and English, each held exactly against
           a direct run of the English question), web search over a
           loopback `http.server` site (73 pages; a blocked domain, the TTL
           cache), the crawled ingests (`ingest_urls` at depth 2,
           `ingest_github` of the checkout's own sources served as a GitHub
           look-alike, then `/ingest/urls` and `/ingest/github` beside
           /search clients, every answer held against `search_batch` of its
           batch, each page's phrase at rank 1), the reports and the CLI
           (`ingest`, `query --report`, `search --save`, `tui` in
           subprocesses), the metrics exporters (ImportError naming a
           missing package), a `torch.profiler` trace of one agentic run
           and `device_timer` against CUDA events, and the template agent's
           MMR on the card against the CPU. Host layers: no kernel of
           their own.
  phase 13 the transformers backends (after phase 12): which of
           transformers, tokenizers and PIL are installed; over tiny
           random-weight models built in the script, `llm.backend: local`
           (greedy chat and stream on the card in float32 against the CPU,
           tokens/s in float32 and float16), one `app.query` over phase
           7's app with the local generator, `TransformersEmbeddingBackend`
           and the VLM captioner on the card against the CPU; then each
           backend's error naming transformers when it is hidden (or
           missing: then only that, and not a pass of the backends).

Other modes, each on a card: `--step-launches ROOT` prints the launches
and step ms of the (1, 1) training step of the package under ROOT (this
checkout or an older one, to compare two); `--cards` runs phase 9 (d)
alone on random batches of (a)'s shape (for a machine with more than one
card); `--nccl-merge ADDR WORLD RANK` is one rank of (d)'s merge.

Prints the card's name and power limit, the phases' numbers, one
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA card, outside a checkout
of the repository, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

CLS_ID, SEP_ID = 101, 102  # the tokenizers' special ids (models/tokenizer.py)
N_DOCS = 1_000_000  # the bench's corpus; the engine rounds it to 2^20 rows
DIM = 384
BATCH = 2048
TOP_K = 10
FUSED_K = 15
FUSED_DEPTH = 40
N_BATCHES = 3
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: device memory rate
# H100 SXM: dense int8 tensor-core peak. The Hamming kernels' bound counts
# their work at this rate too: the same function is a product of +-1 int8
# sign matrices (<s_q, s_c> = 32 W - 2 distance), 2 x 32 W operations per
# (query, row), which the library yardstick below runs on the tensor cores.
INT8_OPS_PER_S = 1.979e15
UPSERT_BATCH = 65_536
LOW_NOISE = 0.05  # query noise of phase 5's second batch (the bench's is 0.25)
MIN_LOW_NOISE_RECALL = 0.45

# config.memory-optimized.example.yaml, as yaml.safe_load reads it (PyYAML
# is not assumed here; tests/test_torch_store.py holds the two equal)
MEMORY_OPTIMIZED_PRESET = {
    "index": {"store_fp32": False},
    "quantization": {"precision": "binary", "rescore_multiplier": 6.0},
    "bm25": {"sketch_dim": 512},
}
# config.quality-optimized.example.yaml, likewise (tests/test_torch_stage1_route.py)
QUALITY_OPTIMIZED_PRESET = {
    "quantization": {"rescore_multiplier": 8.0},
    "retrieval": {"dense_top_k": 20, "bm25_top_k": 20, "fused_top_k": 30},
    "rerank": {"top_k": 10, "candidate_multiplier": 6},
    "agentic": {"max_critic_retries": 3},
    "context_eval": {"use_llm": True},
    "pipeline": {"use_expansion": True, "use_multihop": True},
}
QUALITY_BATCHES = 2
# phase 6: the embedding section at "preset: none" keeps MiniLM-L12's widths
# for both models (config.py's EmbeddingConfig / CrossEncoderConfig defaults)
MINILM_PRESET = {"embedding": {"preset": "none"}}
RERANK_K = 4 * TOP_K  # the hybrid top-40 (bench.py's k_cand)
Q_LEN, D_LEN, PAIR_CHUNK = 31, 93, 4096
BF16_FLOPS_PER_S = 989e12  # H100 SXM: dense bf16 tensor-core peak
# bf16 on the card against a float32 forward of the same weights on the CPU
# (and against another batch composition on the card): L2-normalized
# embeddings within 3e-2 per coordinate and cosine >= 0.998, logits within
# 5% of the batch's largest |logit| (at least 0.05). That is ~3x what bf16
# measured against float32 on the CPU: MiniLM-L12 at random init 1.7e-3 /
# cosine 0.99995 / 1.7e-2 at |logit| <= 0.45; the shipped 128 x 6 models
# 8.6e-3 / 0.99958 / 0.21 at |logit| <= 12.1.
BF16_EMB_ATOL, BF16_MIN_COS, BF16_LOGIT_RTOL = 3e-2, 0.998, 5e-2


def logit_tol(ref) -> float:
    return BF16_LOGIT_RTOL * max(1.0, float(np.abs(ref).max()))

KERNEL_STEMS = ("blockmax2", "hamming", "int8_scan_topk", "int8_scores")  # csrc/<stem>.cu
PALLAS = "radiant_rag_tpu/ops/pallas_kernels.py"
KERNEL_SOURCES = {  # name -> (source, the TPU kernel it replaces)
    "int8_scan_topk": ("int8_scan_topk.cu", f"{PALLAS}:315"),
    "blockmax2": ("blockmax2.cu", f"{PALLAS}:269"),
    "hamming_scan_topk": ("hamming.cu", f"{PALLAS}:42"),
    "hamming_scores": ("hamming.cu", f"{PALLAS}:42"),
    "hamming_scores_t": ("hamming.cu", f"{PALLAS}:117"),
    "int8_scores": ("int8_scores.cu", f"{PALLAS}:77"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what="check failed") -> None:
    """A failed check fails the run (kept under python -O, unlike assert)."""
    if not cond:
        raise AssertionError(what)


def make_corpus(rng: np.random.Generator, n: int):
    """Clustered embeddings + zipfian token texts (the bench's generator)."""
    n_clusters = 256
    centers = rng.standard_normal((n_clusters, DIM)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    vecs = centers[assign] + 0.7 * rng.standard_normal((n, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    zipf = rng.zipf(1.3, size=(n, 48)) % 30_000
    words = [f"w{t}" for t in range(30_000)]
    texts = [" ".join(map(words.__getitem__, row)) for row in zipf.tolist()]
    return vecs, texts


def cuda_ms(fn, reps: int = 3, warm: bool = True) -> float:
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(moved_bytes: float, ops: float):
    """Least time for the work: each input read once and each output
    written once at the memory rate, against the int8 operations at the
    tensor-core peak. Returns (ms, "bytes" | "operations")."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def same(out, ref) -> float:
    """Kernel output vs plain output, exactly (integer work); returns the
    max abs error of the first output (0.0)."""
    import torch

    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(out, ref):
        if not torch.equal(a, b):
            bad = int((a != b).reshape(a.shape[0], -1).any(dim=1).sum()) if a.numel() else 0
            raise AssertionError(f"differs from the plain version in {bad} query rows")
    return float((out[0].float() - ref[0].float()).abs().max()) if out[0].numel() else 0.0


def check_kernel_pair(name, kernel, plain, args) -> float:
    import torch

    out = kernel(*args)
    torch.cuda.synchronize()
    try:
        return same(out, plain(*args))
    except AssertionError as exc:
        raise AssertionError(f"{name}: {exc}") from None


def kernel_row(name, label, kernel, plain, args, library, moved, ops, key, library_mm=None):
    """One kernel at one shape: exact agreement with its plain version on
    the same inputs, the kernel's, the plain version's and the library
    call's times, and the bound (operations at the int8 tensor-core peak).
    Launches made here are comparisons, not main-path launches (the counts
    are reset before each main path); `key` is the shape's key in
    `cuda_kernels.launches_by_shape`, whose main-path count the row gets.
    `library_mm`, where given, is a second yardstick timed as
    `library_mm_ms`: the library's product alone, without the selection."""
    import torch

    out = kernel(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    try:
        err = same(out, ref)
    except AssertionError as exc:
        raise AssertionError(f"{name} [{label}]: {exc}") from None
    del out, ref
    ms = cuda_ms(lambda: kernel(*args), warm=False)
    lib_ms = cuda_ms(library, reps=1)
    b_ms, b_by = bound(moved, ops)
    src, replaces = KERNEL_SOURCES[name]
    row = {"name": name, "shape": label, "route": "cuda",
           "source": f"radiant_rag_tpu_torch/csrc/{src}", "replaces": replaces,
           "launches": 0, "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "_key": key}
    mm = ""
    if library_mm is not None:
        row["library_mm_ms"] = cuda_ms(library_mm, reps=1)
        mm = f", library product alone {row['library_mm_ms']:.3f}"
    log(f"kernel {name} [{label}]: {ms:.3f} ms (plain {plain_ms:.3f}, library {lib_ms:.3f}{mm}, "
        f"bound {b_ms:.3f} by {b_by}), exact")
    return row


def scan_rows(ck, label, codes, qi, mask, k):
    """An int8_scan_topk row at a main-path shape. `torch._int_mm` takes
    more than 16 rows: at B <= 16 the library's queries are zero-padded to
    17 and its scores cut back to B."""
    import torch

    n, d = codes.shape
    b = qi.shape[0]
    ql = qi if b > 16 else torch.nn.functional.pad(qi, (0, 0, 0, 17 - b))

    def library_mm():
        sc = torch._int_mm(ql, codes.T)[:b]
        return sc.masked_fill_(~mask[None, :], torch.iinfo(torch.int32).min)

    return kernel_row("int8_scan_topk", label, ck.int8_scan_topk, ck.int8_scan_topk_reference,
                      (codes, qi, mask, k), lambda: torch.topk(library_mm(), k, dim=1),
                      n * d + b * d + n + b * k * 8, 2.0 * b * n * d,
                      ("int8_scan_topk", d, k, b), library_mm)


def blockmax_row(ck, label, codes, qi, mask):
    import torch

    n, d = codes.shape
    b = qi.shape[0]

    def library_mm():
        sc = torch._int_mm(qi, codes.T)
        return sc.masked_fill_(~mask[None, :], torch.iinfo(torch.int32).min)

    return kernel_row("blockmax2", label, ck.blockmax2, ck.blockmax2_reference,
                      (codes, qi, mask),
                      lambda: torch.topk(library_mm().view(b, -1, 512), 2, dim=2),
                      n * d + b * d + n + b * 2 * (n // 512) * 8, 2.0 * b * n * d,
                      ("blockmax2", d, 0, b), library_mm)


def hamming_scan_row(ck, label, codes, qwords, mask, k, csign):
    """A hamming_scan_topk row; `csign` is the codes' +-1 sign matrix, the
    library yardstick's operand (<s_q, s_c> = 32 W - 2 hamming). At B <= 16
    the yardstick's queries are zero-padded to 17, as in scan_rows."""
    import torch

    n, w = codes.shape
    b = qwords.shape[0]
    qsign = ck.sign_matrix(qwords)
    if b <= 16:
        qsign = torch.nn.functional.pad(qsign, (0, 0, 0, 17 - b))

    def library_mm():
        sc = torch._int_mm(qsign, csign.T)[:b]
        return sc.masked_fill_(~mask[None, :], torch.iinfo(torch.int32).min)

    return kernel_row("hamming_scan_topk", label, ck.hamming_scan_topk,
                      ck.hamming_scan_topk_reference, (codes, qwords, mask, k),
                      lambda: torch.topk(library_mm(), k, dim=1),
                      n * w * 4 + b * w * 4 + n + b * k * 8, 2.0 * b * n * 32 * w,
                      ("hamming_scan_topk", w, k, b), library_mm)


def hamming_rows(ck, codes, qwords, mask):
    """The Hamming kernels at the main path's inputs: the engine's sign
    words, the batch's packed queries (B = 2048 for the fused scan, 1024 for
    the (B, N) outputs, which no main path runs)."""
    import torch

    n, w = codes.shape
    csign = ck.sign_matrix(codes)
    qsign = ck.sign_matrix(qwords)
    b = qwords.shape[0]
    rows = [hamming_scan_row(ck, f"W={w} B={b} k={k}", codes, qwords, mask, k, csign)
            for k in (60, 240, 360)]
    b = 1024
    q1, qs1 = qwords[:b].contiguous(), qsign[:b].contiguous()
    codes_t = codes.T.contiguous()
    hlib = lambda: torch._int_mm(qs1, csign.T)  # noqa: E731 (32 W - 2 hamming)
    moved = n * w * 4 + b * w * 4 + b * n * 4
    rows.append(kernel_row("hamming_scores", f"W={w} B={b}", ck.hamming_scores,
                           ck.hamming_scores_reference, (codes, q1), hlib, moved,
                           2.0 * b * n * 32 * w, ("hamming_scores", w, 0, b)))
    rows.append(kernel_row("hamming_scores_t", f"W={w} B={b} (W, N) codes",
                           ck.hamming_scores_t, ck.hamming_scores_t_reference, (codes_t, q1),
                           hlib, moved, 2.0 * b * n * 32 * w, ("hamming_scores_t", w, 0, b)))
    return rows


def scores_row(ck, label, codes, qi):
    """An int8_scores row: the (B, N) product of the exact-product route."""
    import torch

    n, d = codes.shape
    b = qi.shape[0]
    return kernel_row("int8_scores", f"{label} B={b}", ck.int8_scores, ck.int8_scores_reference,
                      (codes, qi), lambda: torch._int_mm(qi, codes.T),
                      n * d + b * d + b * n * 4, 2.0 * b * n * d, ("int8_scores", d, 0, b))


def phase_edges(ck):
    """Edge shapes of every kernel: ragged N, masked rows and a fully dead
    512-row tile, forced ties (duplicated rows, narrow value range), B = 1,
    and the k the presets reach at the auto fused depth. For the tensor-core
    tile (128-row tiles, 128-, 64- or 32-query blocks, 32-byte mma steps):
    N and B off its multiples (B = 129, 255 for the block-max's 128-query
    block), D = 16 and 48, D = 100 (zero-padded to 112 by the wrappers) and
    D = 1536, k on both sides of the query-block switch (363 | 364) and
    k = 512 at D = 1024; for its sign producer W = 1, 3 and 13 (odd: a
    half-used last 64-byte slice), 24, 32 and 48, with the same k and N, B
    edges. Then `blockmax2` past the old 65535-tile grid and stage 1 past
    k = 512."""
    import torch

    check(ck.int8_scan_qb(363) == 64 and ck.int8_scan_qb(364) == 32, "query-block switch moved")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(5000, 384, 33, 40, -127, 128), (5000, 1024, 1, 160, -2, 3),
             (70_000, 384, 70, 160, -1, 2), (3000, 64, 5, 256, -127, 128),
             (20_001, 384, 40, 360, -2, 3), (9000, 512, 3, 360, -1, 2),
             (12_000, 1024, 33, 240, -2, 3), (5000, 384, 1, 512, -1, 2),
             (3001, 16, 65, 40, -127, 128), (4099, 48, 7, 100, -2, 3),
             (2177, 48, 1, 16, -1, 2), (6000, 64, 65, 363, -2, 3),
             (6000, 64, 65, 364, -2, 3), (5000, 1024, 3, 512, -1, 2),
             # D past 1024 and D off 16 (padded by the wrappers); B off the
             # block-max kernel's 128-query block
             (5000, 1536, 33, 40, -127, 128), (3000, 1536, 3, 360, -2, 3),
             (4099, 100, 65, 100, -2, 3), (2177, 100, 130, 240, -127, 128),
             (70_000, 384, 129, 160, -1, 2), (9000, 64, 255, 40, -2, 3)]
    for n, d, b, k, lo, hi in cases:
        codes = torch.randint(lo, hi, (n, d), dtype=torch.int8, device="cuda", generator=g)
        codes[n // 2: n // 2 + 7] = codes[11]  # exact duplicates: ties at one score
        qi = torch.randint(lo, hi, (b, d), dtype=torch.int8, device="cuda", generator=g)
        mask = torch.ones(n, dtype=torch.bool, device="cuda")
        mask[3:40] = False
        mask[1024:1536] = False  # a dead 512-row tile
        check_kernel_pair(f"int8_scan_topk edge n={n} d={d} b={b} k={k}",
                          ck.int8_scan_topk, ck.int8_scan_topk_reference, (codes, qi, mask, k))
        check_kernel_pair(f"blockmax2 edge n={n} d={d} b={b}",
                          ck.blockmax2, ck.blockmax2_reference, (codes, qi, mask))
        check_kernel_pair(f"int8_scores edge n={n} d={d} b={b}", ck.int8_scores,
                          ck.int8_scores_reference, (codes, qi))
    hcases = [(20_001, 12, 40, 360, True), (5001, 12, 1, 60, True), (70_001, 24, 65, 240, False),
              (3000, 12, 8, 512, True), (100, 12, 4, 360, False), (3001, 1, 65, 40, True),
              (4099, 3, 7, 100, True), (6001, 13, 65, 363, True), (6001, 13, 65, 364, True),
              (5000, 32, 3, 512, False), (2177, 24, 130, 16, True), (1500, 13, 129, 300, False),
              (9000, 32, 64, 363, True), (6001, 48, 65, 100, False)]
    for n, w, b, k, ties in hcases:
        words = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32, device="cuda",
                              generator=g)
        if ties:  # few distinct words: raw takes few values, ties at every k
            words &= 0x0F0F0F0F
        words[n // 2: n // 2 + 9] = words[5]  # a block of duplicate codes
        q = torch.randint(-2**31, 2**31 - 1, (b, w), dtype=torch.int32, device="cuda",
                          generator=g)
        mask = torch.ones(n, dtype=torch.bool, device="cuda")
        mask[2:50] = False
        check_kernel_pair(f"hamming_scan_topk edge n={n} w={w} b={b} k={k}",
                          ck.hamming_scan_topk, ck.hamming_scan_topk_reference,
                          (words, q, mask, k))
        check_kernel_pair(f"hamming_scores edge n={n} w={w} b={b}", ck.hamming_scores,
                          ck.hamming_scores_reference, (words, q))
        check_kernel_pair(f"hamming_scores_t edge n={n} w={w} b={b}", ck.hamming_scores_t,
                          ck.hamming_scores_t_reference, (words.T.contiguous(), q))
    log(f"edge shapes: {len(cases)} int8 cases x 3 kernels, {len(hcases)} Hamming cases x 3 "
        "kernels, all exact")
    blockmax_past_tile_cap(ck, g)
    product_route_edges(ck, g)


def blockmax_past_tile_cap(ck, g):
    """blockmax2 at 65,536 x 512 + 700 rows (D = 16, B = 3; 537 MB of codes):
    more 512-row tiles than a grid dimension of 65535 holds."""
    import torch

    n, d, b = 65_536 * 512 + 700, 16, 3
    codes = torch.randint(-2, 3, (n, d), dtype=torch.int8, device="cuda", generator=g)
    qi = torch.randint(-2, 3, (b, d), dtype=torch.int8, device="cuda", generator=g)
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    mask[-1200:-900] = False
    check_kernel_pair(f"blockmax2 n={n} d={d} b={b}", ck.blockmax2, ck.blockmax2_reference,
                      (codes, qi, mask))
    log(f"blockmax2 past the old 65535-tile grid: {-(-n // 512)} tiles, exact")


def product_route_edges(ck, g):
    """Stage 1 past the scan kernels' lists (k = 513, 960): the exact-product
    route of `similarity.scan_select` / `hamming_scan_topk` against the scans'
    plain versions, in steps of 16 queries under a budget, and in one step
    under the card's measured free memory."""
    import torch

    from radiant_rag_tpu_torch.ops import similarity as sim

    n, b = 20_001, 40
    measured = sim.route_budget
    check(sim.product_query_block(n, b, measured(torch.device("cuda"))) == b, "route budget")
    for k in (513, 960):
        codes = torch.randint(-2, 3, (n, 384), dtype=torch.int8, device="cuda", generator=g)
        codes[n // 2: n // 2 + 7] = codes[11]
        qi = torch.randint(-2, 3, (b, 384), dtype=torch.int8, device="cuda", generator=g)
        mask = torch.ones(n, dtype=torch.bool, device="cuda")
        mask[1024:1536] = False
        ref = ck.int8_scan_topk_reference(codes, qi, mask, k)
        for steps in (3, 1):
            if steps > 1:
                sim.route_budget = lambda device: 16 * n * sim.SCORE_BYTES_PER_CELL
            before = (ck.int8_scan_topk.launches, ck.int8_scores.launches)
            out = sim.scan_select(codes, qi, mask, k, "f32")
            sim.route_budget = measured
            torch.cuda.synchronize()
            check((ck.int8_scan_topk.launches, ck.int8_scores.launches)
                  == (before[0], before[1] + steps), "product route launches")
            same(out, ref)
        words = torch.randint(-2**31, 2**31 - 1, (n, 12), dtype=torch.int32, device="cuda",
                              generator=g) & 0x0F0F0F0F
        q = torch.randint(-2**31, 2**31 - 1, (b, 12), dtype=torch.int32, device="cuda",
                          generator=g)
        raw, rows = ck.hamming_scan_topk_reference(words, q, mask, k)
        before = (ck.hamming_scan_topk.launches, ck.hamming_scores.launches)
        s, r = sim.hamming_scan_topk(words, q, mask, k)
        torch.cuda.synchronize()
        check((ck.hamming_scan_topk.launches, ck.hamming_scores.launches)
              == (before[0], before[1] + 1), "Hamming product route launches")
        inv = float(torch.tensor(1.0 / 384, dtype=torch.float32))
        same((s, r), (torch.where(rows >= 0, raw * inv, sim.NEG_INF), rows))
    log("stage 1 at k = 513, 960: the exact-product route (int8 and Hamming) == the plain "
        "versions")


def small_path_check():
    """The whole path on a small corpus on the card against the same path
    on the CPU (plain versions): scores within rtol 1e-5 / atol 1e-6 (fp32
    summation order), rows equal up to swaps of rows tied within that."""
    from radiant_rag_tpu_torch.index.bm25 import BM25Index
    from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
    from radiant_rag_tpu_torch.index.hybrid import HybridSearcher

    rng = np.random.default_rng(SEED + 1)
    n = 6000
    vecs, texts = make_corpus(rng, n)
    q = vecs[:37] + 0.25 * rng.standard_normal((37, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = [" ".join(t.split()[:6]) for t in texts[:37]]
    variants = (("int8", "sketch", 0, "", 4.0), ("int8", "sketch", FUSED_DEPTH, "", 4.0),
                ("int8", "pages", 0, "", 4.0), ("int8", "sketch", 0, "blockmax", 4.0),
                ("binary", "sketch", 60, "", 6.0), ("binary", "pages", 60, "", 6.0))
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = []
        for store_fp32 in (True, False):
            eng = DeviceVectorIndex(DIM, initial_capacity=n, device=dev, store_fp32=store_fp32)
            eng.append(vecs, np.zeros(n, np.int8), np.zeros(n, np.int32),
                       np.full(n, 48, np.float32))
            bm = BM25Index(device=dev)
            bm.bulk_build(list(range(n)), texts)
            hs = HybridSearcher(eng, bm)
            out[dev] += [hs.search_rows(q, qt, mode=mode, bm25_mode=route, fused_depth=fd,
                                        select=sel, rescore_multiplier=mult)
                         for mode, route, fd, sel, mult in variants]
    for i, (a, c) in enumerate(zip(out["cpu"], out["cuda"])):
        for leg in ("dense", "bm25", "fused"):
            (ref_s, ref_r), (got_s, got_r) = a[leg], c[leg]
            np.testing.assert_allclose(got_s, ref_s, rtol=1e-5, atol=1e-6)
            # rows equal, except a swap of two rows whose CPU scores are tied
            # within that tolerance (the sums run in another order on the card)
            for q_, slot in zip(*np.nonzero(ref_r != got_r)):
                other = np.nonzero(ref_r[q_] == got_r[q_, slot])[0]
                check(len(other) == 1 and got_r[q_, other[0]] == ref_r[q_, slot]
                      and abs(ref_s[q_, slot] - ref_s[q_, other[0]])
                      <= 1e-6 + 1e-5 * abs(ref_s[q_, slot]),
                      f"small path run {i} {leg}: card rows differ from CPU, query {q_}")
    log(f"small path: card == CPU plain path on {len(out['cpu'])} mode/route/select/fp32 "
        "variants")


def sass_counts(_build, stem: str):
    """{kernel function: (tensor-core instructions (IMMA, IGMMA), IDP.4A
    instructions, POPC instructions)} in the built library of csrc/<stem>.cu,
    read from `cuobjdump -sass` (the toolkit's, beside nvcc)."""
    bindir = Path(_build.nvcc_path()).parent
    text = subprocess.run([str(bindir / "cuobjdump"), "-sass", str(_build.library_path(stem))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0, 0]
        elif fn is not None:
            counts[fn][0] += bool(re.search(r"\b(IMMA|IGMMA)\b", line))
            counts[fn][1] += "IDP.4A" in line
            counts[fn][2] += bool(re.search(r"\bPOPC\b", line))
    filt = bindir / "cu++filt"
    if counts and filt.is_file():
        names = subprocess.run([str(filt)], input="\n".join(counts), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(names) == len(counts):
            counts = dict(zip(names, counts.values()))
    return counts


def log_sass(_build) -> None:
    """One line per built library: its kernels' tensor-core, IDP.4A and POPC
    instruction counts. Every partial or score kernel of the tensor-core
    tile's libraries must show the first and no IDP.4A (the merge kernel,
    which sorts, is exempt)."""
    for stem in KERNEL_STEMS:
        counts = sass_counts(_build, stem)
        log(f"sass {stem}: " + "; ".join(f"{fn} IMMA/IGMMA {t} IDP.4A {i} POPC {p}"
                                         for fn, (t, i, p) in counts.items()))
        if stem in ("int8_scan_topk", "int8_scores", "hamming", "blockmax2"):
            tiles = {fn: c for fn, c in counts.items() if "topk_merge" not in fn}
            check(tiles and all(t > 0 and i == 0 for t, i, _ in tiles.values()),
                  f"{stem}: expected tensor-core instructions and no IDP.4A in {list(tiles)}")


def profile_batch(fn, what: str):
    """Device time by kernel and the device's idle share over one batch
    (torch.profiler, CUPTI); returns the idle share. Measurement only:
    without device events it says "not measured", returns None and the run
    goes on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    return device_report(prof, wall_us, what)


def device_report(prof, wall_us: float, what: str):
    """Device busy time, idle share and the top kernels of a finished
    torch.profiler window of `wall_us` host microseconds; returns the idle
    share (None without device events)."""
    import torch

    kernels = [e for e in prof.events()  # kernels and copies, not annotated ranges
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log(f"profile ({what}): no device events (device time not measured)")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    log(f"profile ({what}): wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms, idle share {max(0.0, 1 - busy / wall_us):.3f}, "
        f"{len(kernels)} device kernels and copies")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / 1e3:9.3f} ms  {name[:110]}")
    return max(0.0, 1 - busy / wall_us)


def exact_top10(vecs, q: np.ndarray, valid=None, k: int = TOP_K):
    """Recall oracle: exact fp32 cosine top-10 (or top-k), a plain matmul on
    the card in row chunks (off the path under test). `vecs`: host vectors,
    or an engine's device rows with their `valid` mask."""
    import torch

    qd = torch.from_numpy(q).cuda()
    best_s = torch.full((q.shape[0], k), -2.0, device="cuda")
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device="cuda")
    step = 1 << 17
    for s in range(0, vecs.shape[0], step):
        v = vecs[s:s + step]
        sc = qd @ (torch.from_numpy(v).cuda() if isinstance(v, np.ndarray) else v).T
        if valid is not None:
            sc.masked_fill_(~valid[s:s + step][None, :], -3.0e38)
        cs, ci = torch.topk(sc, min(k, sc.shape[1]), dim=1)
        alls = torch.cat([best_s, cs], 1)
        alli = torch.cat([best_i, ci + s], 1)
        top = torch.topk(alls, k, dim=1).indices
        best_s, best_i = alls.gather(1, top), alli.gather(1, top)
    return best_i.cpu().numpy()


def stage1_rescored_top10(vecs: np.ndarray, q: np.ndarray, cand) -> np.ndarray:
    """Top-10 of (B, kc) stage-1 candidate rows (a device tensor, -1 =
    empty) rescored exactly in fp32 against the host vectors."""
    import torch

    out = np.empty((q.shape[0], TOP_K), np.int64)
    step = 256
    for s in range(0, q.shape[0], step):
        c = cand[s:s + step].cpu().numpy().astype(np.int64)
        cv = torch.from_numpy(vecs[np.maximum(c, 0)]).cuda()  # (b, kc, D)
        sc = torch.einsum("bd,bkd->bk", torch.from_numpy(q[s:s + step]).cuda(), cv)
        sc = torch.where(torch.from_numpy(c >= 0).cuda(), sc, -3.0e38)
        top = torch.topk(sc, TOP_K, dim=1).indices.cpu().numpy()
        out[s:s + step] = np.take_along_axis(c, top, 1)
    return out


def recall_at_10(rows: np.ndarray, exact: np.ndarray) -> float:
    return float(np.mean([len(set(rows[i]) & set(exact[i])) / TOP_K
                          for i in range(rows.shape[0])]))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "radiant_rag_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 rescore and exact oracle stay fp32
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmul and cudnn")
    t_start = time.perf_counter()

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"device: {kind}")
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")

    from radiant_rag_tpu_torch import _build
    from radiant_rag_tpu_torch.ops import cuda_kernels as ck

    build_s = _build.build_all()
    log(f"kernel build: {build_s:.2f} s")
    for stem, text in _build.build_log.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "wgmma")):
                log(f"  {stem}: {line.strip()}")
    log_sass(_build)
    log("scan partial CTAs per SM (occupancy API), int8_scan_topk / hamming: " + ", ".join(
        f"k={k} ({ck.int8_scan_qb(k)} queries, {ck.int8_scan_smem_bytes(ck.int8_scan_qb(k), k)} B)"
        f" {ck.int8_scan_ctas_per_sm('int8_scan_topk', k, torch.device('cuda'))} / "
        f"{ck.int8_scan_ctas_per_sm('hamming', k, torch.device('cuda'))}"
        for k in (40, 60, 160, 240, 360, 512)))
    bm_note = "C7520" in _build.build_log.get("blockmax2", "")
    log(f"blockmax2: {ck.blockmax2_ctas_per_sm(torch.device('cuda'))} CTAs per SM (occupancy "
        f"API) at {ck.mma_ring_bytes(ck.BLOCKMAX_QB)} B of shared memory; ptxas C7520 note: "
        f"{'yes' if bm_note else 'no'}")

    phase_edges(ck)
    torch.cuda.synchronize()
    small_path_check()
    torch.cuda.synchronize()

    from radiant_rag_tpu_torch.index.bm25 import BM25Index
    from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
    from radiant_rag_tpu_torch.index.hybrid import HybridSearcher
    from radiant_rag_tpu_torch.ops import quantize as qz
    from radiant_rag_tpu_torch.ops import similarity as sim
    from radiant_rag_tpu_torch.ops.similarity import quantize_queries

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    vecs, texts = make_corpus(rng, N_DOCS)
    nq = N_BATCHES * BATCH
    qidx = rng.integers(0, N_DOCS, nq)
    queries = vecs[qidx] + 0.25 * rng.standard_normal((nq, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    qtexts = [" ".join(texts[i].split()[:6]) for i in qidx]
    log(f"corpus: {N_DOCS} docs in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    eng = DeviceVectorIndex(DIM, initial_capacity=N_DOCS)
    for s in range(0, N_DOCS, UPSERT_BATCH):
        m = min(UPSERT_BATCH, N_DOCS - s)
        eng.append(vecs[s:s + m], np.zeros(m, np.int8), np.zeros(m, np.int32),
                   np.full(m, 48, np.float32))
    torch.cuda.synchronize()
    t_eng = time.perf_counter() - t0
    bm = BM25Index()
    native = bm.bulk_build(list(range(N_DOCS)), texts)
    bm._finalize_csr()
    searcher = HybridSearcher(eng, bm)
    bm.ensure_sketch(eng.capacity)
    bm.ensure_doc_major(eng.capacity)
    torch.cuda.synchronize()
    log(f"index build: {time.perf_counter() - t0:.1f} s (engine {t_eng:.1f} s, native bm25 "
        f"{native}); capacity {eng.capacity}, sketch S={bm.sketch_dim}, "
        f"L={bm.doc_major_width}, max bucket {searcher.max_query_bucket()}")
    check(eng.capacity == 1 << 20 and bm.sketch_dim == 1024 and bm.doc_major_width == 128)

    # phase 3 at the main paths' own inputs: the dense leg's quantized
    # queries over the engine codes, the sketch leg's indicators over the
    # sketch, the batch's packed sign words over the engine's sign words
    qb, tb = queries[:BATCH], qtexts[:BATCH]
    q16 = torch.from_numpy(qb.astype(np.float16).astype(np.float32)).cuda()
    scale, _ = qz.int8_scale_offset(eng.i8_lo, eng.i8_hi)
    qi_dense, _ = quantize_queries(q16, scale)
    qwords = qz.pack_binary(q16)
    qind = torch.from_numpy(bm.make_query_indicator(tb, bm.query_tids(tb))).cuda()
    mask = eng.valid.clone()
    krows = [scan_rows(ck, "dense D=384 k=40", eng.i8, qi_dense, mask, 4 * TOP_K),
             scan_rows(ck, "dense D=384 k=40 B=16 (rare-term batch)", eng.i8,
                       qi_dense[:16].contiguous(), mask, 4 * TOP_K),
             scan_rows(ck, "dense D=384 k=160", eng.i8, qi_dense, mask, 4 * FUSED_DEPTH),
             scan_rows(ck, "dense D=384 k=360", eng.i8, qi_dense, mask, 360),
             scan_rows(ck, "sketch S=1024 k=40", bm._sketch, qind, mask, 4 * TOP_K),
             scan_rows(ck, "sketch S=1024 k=160", bm._sketch, qind, mask, 4 * FUSED_DEPTH),
             scan_rows(ck, "sketch S=1024 k=240", bm._sketch, qind, mask, 240),
             blockmax_row(ck, "dense D=384 blockmax", eng.i8, qi_dense, mask),
             blockmax_row(ck, "sketch S=1024 blockmax", bm._sketch, qind, mask)]
    krows += hamming_rows(ck, eng.codes, qwords, mask)
    # phase 4q's exact-product route runs int8_scores on both legs, a block
    # of queries at a time as the card's free memory allows (the block is
    # part of each row's key: a step of another size fails the shape check)
    step = sim.product_query_block(eng.capacity, BATCH, sim.route_budget(eng.device))
    krows += [scores_row(ck, "dense D=384", eng.i8, qi_dense[:step].contiguous()),
              scores_row(ck, f"sketch S={bm.sketch_dim}", bm._sketch, qind[:step].contiguous())]
    del qi_dense, qind, mask, qwords, q16
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # phase 4: the main path. Counts are set to 0 just before each run and
    # read just after; comparison launches above and below do not count.
    launches = {fn.__name__: 0 for fn in ck.KERNELS}
    shape_launches = {}  # (kernel, D or W, k or 0, B) -> main-path launches

    def main_path(fn, tag=()):
        """Drive a main path once: every count set to 0 just before, read
        just after. Returns (its output, its launches by kernel, seconds).
        `tag` extends this run's shape keys (phase 10's pod rows)."""
        ck.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        delta = {fn_.__name__: fn_.launches for fn_ in ck.KERNELS}
        for name, n in delta.items():
            launches[name] += n
        for key, n in ck.launches_by_shape.items():
            key = key + tuple(tag)
            shape_launches[key] = shape_launches.get(key, 0) + n
        return out, delta, dt

    def run(label, fn, n_batches):
        out, delta, dt = main_path(fn)
        shown = ", ".join(f"{k} {v}" for k, v in delta.items() if v)
        log(f"{label}: {dt / n_batches * 1e3:.1f} ms/batch, {n_batches * BATCH / dt:.1f} QPS; "
            f"launches {shown or 'none'}")
        return out, delta

    def batches(fd, select="", n=N_BATCHES):
        return [searcher.search_rows(
            queries[i * BATCH:(i + 1) * BATCH], qtexts[i * BATCH:(i + 1) * BATCH],
            dense_k=TOP_K, bm25_k=TOP_K, fused_k=FUSED_K, mode="int8",
            fused_depth=fd, select=select) for i in range(n)]

    torch.cuda.reset_peak_memory_stats()
    batches(0, n=1)  # warm-up (allocator, host caches)
    res0, d = run("sketch route, fused_depth 0", lambda: batches(0), N_BATCHES)
    check(d["int8_scan_topk"] == 2 * N_BATCHES,
          f"expected 2 scan launches per sketch batch, got {d['int8_scan_topk']}")
    res40, d = run(f"sketch route, fused_depth {FUSED_DEPTH}", lambda: batches(FUSED_DEPTH),
                   N_BATCHES)
    check(d["int8_scan_topk"] == 2 * N_BATCHES)
    resbm, d = run("sketch route, select=blockmax", lambda: batches(0, "blockmax", 2), 2)
    check(d["blockmax2"] == 4 and d["int8_scan_topk"] == 0, d)
    profile_batch(lambda: batches(0, "blockmax", 1), "one select=blockmax batch")

    # a small rare-term batch the router sends to the exact pages route
    lengths = np.diff(bm._term_start)
    rare = [t for t in np.argsort(lengths, kind="stable") if lengths[t] > 0][:64]
    picks = rng.choice(np.asarray(rare), size=(16, 2), replace=False)
    rare_texts = [f"{bm.terms[a]} {bm.terms[c]}" for a, c in picks]
    check(bm.routes_pages(rare_texts, bm.query_tids(rare_texts), num_docs=eng.capacity))
    rq = queries[:16]
    resp, d = run("rare-term batch (B=16), auto route", lambda: searcher.search_rows(
        rq, rare_texts, dense_k=TOP_K, bm25_k=TOP_K, fused_k=FUSED_K, mode="int8"), 1)
    check(d["int8_scan_topk"] == 1 and d["blockmax2"] == 0,
          "the rare-term batch did not take the pages route")
    for qi_, (a, c) in enumerate(picks):
        hits = [r for r in resp["bm25"][1][qi_] if r >= 0]
        check(hits, f"pages route found nothing for {rare_texts[qi_]!r}")
        for r in hits:
            words = set(texts[r].split())
            check(bm.terms[a] in words or bm.terms[c] in words)

    def pipelined():
        pend = [searcher.search_rows(queries[i * BATCH:(i + 1) * BATCH],
                                     qtexts[i * BATCH:(i + 1) * BATCH], dense_k=TOP_K,
                                     bm25_k=TOP_K, fused_k=FUSED_K, mode="int8",
                                     fetch=False)[1]
                for i in range(N_BATCHES)]
        return [unpack() for unpack in pend]

    respipe, d = run("fetch=False pipelined, fused_depth 0", pipelined, N_BATCHES)
    check(d["int8_scan_topk"] == 2 * N_BATCHES)
    peak = torch.cuda.max_memory_allocated()
    try:
        profile_batch(lambda: batches(0, n=1), "one int8 sketch-route batch")
    except Exception as exc:  # measurement only: report it, keep the run
        log(f"profile: unavailable ({type(exc).__name__}: {exc}); device time not measured")
    log(f"max_memory_allocated: {peak / 2**30:.2f} GiB")

    # correctness at full size
    for name, res in (("fd0", res0), ("fd40", res40), ("blockmax", resbm), ("pipe", respipe)):
        for r in res:
            for leg, k in (("dense", TOP_K), ("bm25", TOP_K), ("fused", FUSED_K)):
                s, rows = r[leg]
                check(s.shape == (BATCH, k) and rows.shape == (BATCH, k), (name, leg))
                live = rows >= 0
                check(np.isfinite(s[live]).all() and (rows < N_DOCS).all(), (name, leg))
                check(live[:, 0].all(), f"{name} {leg}: a query returned nothing")
    for a, c in zip(res0, respipe):
        for leg in ("dense", "bm25", "fused"):
            check(np.array_equal(a[leg][1], c[leg][1]), f"pipelined {leg} rows differ")
    exact0 = exact_top10(vecs, queries[:BATCH])
    _, ex_rows = eng.search(queries[:BATCH], TOP_K, mode="exact")
    check(recall_at_10(ex_rows, exact0) >= 0.999, "exact mode disagrees with the oracle")
    recall = recall_at_10(res0[0]["dense"][1], exact0)
    recall_bm = recall_at_10(resbm[0]["dense"][1], exact0)
    log(f"dense recall@10 vs exact: {recall:.4f} (fused scan), {recall_bm:.4f} (blockmax)")
    check(recall >= 0.9, recall)
    for i in range(64):  # the bm25 leg returns docs holding a query term
        words = set(qtexts[i].split())
        for r in res0[0]["bm25"][1][i]:
            if r >= 0:
                check(words & set(texts[r].split()), (i, r))
    phase_quality(ck, run, searcher, queries, qtexts, exact0)
    phase_models(run, searcher, vecs, texts, queries, qtexts, smi)
    del searcher, eng, bm, res0, res40, resbm, resp, respipe
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    krows += phase_memory_optimized(ck, run, launches, vecs, texts, queries, qtexts)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    krows += phase_serving(ck, main_path, vecs, texts, smi, {row["_key"] for row in krows})

    # each row gets the main-path launches at its own shape
    row_keys = [row.pop("_key") for row in krows]
    check(len(set(row_keys)) == len(row_keys), "two kernel rows at one shape")
    for row, key in zip(krows, row_keys):
        row["launches"] = shape_launches.get(key, 0)
    check(set(shape_launches) <= set(row_keys),
          f"main-path launches at shapes no row measured: {set(shape_launches) - set(row_keys)}")
    log(f"main-path launches by shape: "
        f"{json.dumps({'/'.join(map(str, k)): v for k, v in sorted(shape_launches.items())})}")
    on_path = ("int8_scan_topk", "blockmax2", "hamming_scan_topk", "int8_scores")
    for name in on_path:
        check(launches[name] > 0, f"kernel {name} was never launched on a main path")
    log(f"main-path launches: {json.dumps(launches)} (hamming_scores and hamming_scores_t have "
        "no caller on these main paths; hamming_scores is the binary stage 1 past k = 512)")
    log(f"total run time: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": krows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def phase_quality(ck, run, searcher, queries, qtexts, exact0):
    """Phase 4q: the quality-optimized preset over phase 4's engine and BM25
    index. Its fused depth 120 x multiplier 8.0 asks stage 1 for kc = 960
    candidates on both legs: the exact-product route (`int8_scores` a block
    of queries at a time, then the top-k), no scan launch."""
    import torch

    from radiant_rag_tpu_torch.config import config_from_dict
    from radiant_rag_tpu_torch.index.hybrid import resolve_fused_depth
    from radiant_rag_tpu_torch.ops import similarity as sim

    cfg = config_from_dict(QUALITY_OPTIMIZED_PRESET)
    r = cfg.retrieval
    depth, mult = resolve_fused_depth(r), cfg.quantization.rescore_multiplier
    kc = int(round(depth * mult))
    check((r.dense_top_k, r.bm25_top_k, r.fused_top_k, depth, mult, kc)
          == (20, 20, 30, 120, 8.0, 960), (r, depth, mult))
    eng, bm = searcher.engine, searcher.bm25

    def batch(i):
        return searcher.search_rows(
            queries[i * BATCH:(i + 1) * BATCH], qtexts[i * BATCH:(i + 1) * BATCH],
            dense_k=r.dense_top_k, bm25_k=r.bm25_top_k, fused_k=r.fused_top_k, mode="int8",
            fused_depth=depth, rescore_multiplier=mult)

    torch.cuda.reset_peak_memory_stats()
    batch(0)  # warm-up
    res, d = run(f"quality preset: search_rows int8, fused depth {depth}, x{mult} (kc {kc})",
                 lambda: [batch(i) for i in range(QUALITY_BATCHES)], QUALITY_BATCHES)
    check(d["int8_scan_topk"] == 0 and d["blockmax2"] == 0, d)
    shapes = dict(ck.launches_by_shape)
    check(sum(n for (name, d, _k, _b), n in shapes.items()
              if name == "int8_scores" and d == DIM) >= QUALITY_BATCHES
          and sum(n for (name, d, _k, _b), n in shapes.items()
                  if name == "int8_scores" and d == bm.sketch_dim) >= QUALITY_BATCHES,
          f"expected int8_scores on both legs, got {shapes}")
    check(not any(key[0] == "int8_scan_topk" for key in shapes), shapes)
    peak = torch.cuda.max_memory_allocated()
    profile_batch(lambda: batch(0), "one quality-preset batch")
    budget = sim.route_budget(eng.device)
    step = sim.product_query_block(eng.capacity, BATCH, budget)
    log(f"quality preset: int8_scores launches {shapes}; query block {step} of {BATCH} "
        f"(measured budget {budget / 2**30:.1f} GiB); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    for out in res:
        for leg, k in (("dense", r.dense_top_k), ("bm25", r.bm25_top_k), ("fused", r.fused_top_k)):
            s, rows = out[leg]
            check(s.shape == (BATCH, k) and rows.shape == (BATCH, k), ("quality", leg))
            live = rows >= 0
            check(np.isfinite(s[live]).all() and (rows < N_DOCS).all(), ("quality", leg))
            check(live[:, 0].all(), f"quality {leg}: a query returned nothing")
    recall = recall_at_10(res[0]["dense"][1][:, :TOP_K], exact0)
    log(f"quality preset dense recall@10 vs exact: {recall:.4f}")
    check(recall >= 0.9, recall)

    # the route alone at the batch's shapes (stage 1 of each leg, kc = 960)
    from radiant_rag_tpu_torch.ops import quantize as qz
    from radiant_rag_tpu_torch.ops.similarity import quantize_queries

    tb = qtexts[:BATCH]
    q16 = torch.from_numpy(queries[:BATCH].astype(np.float16).astype(np.float32)).cuda()
    qi, _ = quantize_queries(q16, qz.int8_scale_offset(eng.i8_lo, eng.i8_hi)[0])
    qind = torch.from_numpy(bm.make_query_indicator(tb, bm.query_tids(tb))).cuda()
    for label, codes, q in (("dense D=384", eng.i8, qi), (f"sketch S={bm.sketch_dim}",
                                                           bm._sketch, qind)):
        ms = cuda_ms(lambda: sim.scan_select(codes, q, eng.valid, kc, "f32"), reps=2)
        log(f"quality preset stage 1 {label} B={BATCH} k={kc} (int8_scores + top-k): "
            f"{ms:.3f} ms")


def encoder_flops(cfg, seqs: int, seq: int) -> float:
    """Operations of one BERT encoder forward over `seqs` sequences of
    `seq` tokens (padded tokens count as work done): 2 x the Dense weights
    per token and layer, and 4 x seq x hidden per token and layer for the
    attention's two products."""
    h, ff = cfg.hidden_size, cfg.intermediate_size
    per_token_layer = 2 * (4 * h * h + 2 * h * ff) + 4 * seq * h
    return cfg.num_layers * seqs * seq * per_token_layer


def ce_flops(cfg, pairs: int, seq: int) -> float:
    """One cross-encoder forward: the encoder, and the pooler and classifier
    on [CLS]."""
    h = cfg.hidden_size
    return encoder_flops(cfg, pairs, seq) + 2 * pairs * (h * h + h)


def host_packed(rr, q_texts, rows, texts):
    """(n, L) ids, mask, types of [CLS] q [SEP] d [SEP] packed on the host
    with the reranker's caps (tests/test_device_rerank.py's layout)."""
    tok = rr.ce.tokenizer
    ids = np.zeros((len(rows), rr.L), np.int32)
    mask, types = np.zeros_like(ids), np.zeros_like(ids)
    for i, (q, r) in enumerate(zip(q_texts, rows)):
        q_ids = tok.tokenize_ids_batch([q], cap=rr.q_len)[0]
        d_ids = tok.tokenize_ids_batch([texts[r]], cap=rr.d_len)[0]
        seq = [CLS_ID] + q_ids + [SEP_ID] + d_ids + [SEP_ID]
        ids[i, :len(seq)] = seq
        mask[i, :len(seq)] = 1
        types[i, len(q_ids) + 2:len(seq)] = 1
    return ids, mask, types


def cpu_twins(embedder, ce):
    """float32 copies of the card's two models on the CPU (same weights)."""
    import torch

    from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
    from radiant_rag_tpu_torch.models.embedder import Embedder

    def cpu_state(model):
        return {k: v.detach().cpu() for k, v in model.state_dict().items()}

    emb = Embedder(dataclasses.replace(embedder.config, dtype="float32"),
                   params=cpu_state(embedder.model), device="cpu")
    ce32 = CrossEncoder(ce.config, bert_cfg=dataclasses.replace(ce.bert_cfg, dtype=torch.float32),
                        params=cpu_state(ce.model), device="cpu")
    return emb, ce32


def check_bf16(card_emb, cpu_emb, card_logits, cpu_logits, what: str) -> str:
    """The card's bf16 embeddings and logits against a float32 reference,
    within the stated bf16 tolerance; returns the measured errors."""
    e_err = float(np.abs(card_emb - cpu_emb).max())
    cos = float(((card_emb * cpu_emb).sum(1) / np.linalg.norm(card_emb, axis=1)
                 / np.linalg.norm(cpu_emb, axis=1)).min())
    l_err = float(np.abs(card_logits - cpu_logits).max())
    check(e_err <= BF16_EMB_ATOL and cos >= BF16_MIN_COS,
          f"{what}: embeddings differ by {e_err} (min cosine {cos})")
    check(l_err <= logit_tol(cpu_logits), f"{what}: logits differ by {l_err}")
    return (f"embeddings max abs {e_err:.2e} (min cosine {cos:.6f}), logits max abs {l_err:.2e} "
            f"at |logit| <= {float(np.abs(cpu_logits).max()):.3f}")


def phase_models(run, searcher, vecs, texts, queries, qtexts, smi):
    """Phase 6: the models slice over phase 4's engine and BM25 index. The
    query embedder feeds `search_rows` on the card (`_qdev`), and the
    cross-encoder reranks the fused top-40 of every query through the
    device token table of the 1M corpus texts."""
    import torch

    from radiant_rag_tpu_torch.config import config_from_dict
    from radiant_rag_tpu_torch.index.hybrid import embed_queries_device
    from radiant_rag_tpu_torch.models.device_rerank import DeviceReranker
    from radiant_rag_tpu_torch.models.registry import LocalNLPModels

    cfg = config_from_dict(MINILM_PRESET)
    e, c = cfg.embedding, cfg.cross_encoder
    widths = (384, 12, 12, 1536, 30522)
    check((e.dim, e.num_layers, e.num_heads, e.hidden_dim, e.vocab_size) == widths
          and (c.dim, c.num_layers, c.num_heads, c.hidden_dim, c.vocab_size) == widths
          and (e.max_seq_len, c.max_seq_len, e.dtype, c.dtype)
          == (256, 384, "bfloat16", "bfloat16"), (e, c))
    t0 = time.perf_counter()
    models = LocalNLPModels(cfg)
    ce = models.cross_encoder
    check(type(models.embedder.tokenizer).__name__ == "HashTokenizer")
    rr = DeviceReranker(ce, q_len=Q_LEN, d_len=D_LEN, pair_chunk=PAIR_CHUNK)
    check(rr.L == 127)
    log(f"models: MiniLM-L12 width (hidden 384, 12 layers, 12 heads, FFN 1536, vocab 30522), "
        f"bf16, seeded init, built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rr.build_table(texts)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    log(f"rerank token table: {rr.n_rows} docs x {D_LEN} tokens in {t_table:.1f} s "
        f"({rr._table.numel() * rr._table.element_size() / 1e9:.2f} GB)")
    eng = searcher.engine

    def chain(i):
        qt = qtexts[i * BATCH:(i + 1) * BATCH]
        qdev = embed_queries_device(models, eng, qt)
        check(qdev is not None and tuple(qdev.shape) == (BATCH, DIM), "no device queries")
        res = searcher.search_rows(None, qt, dense_k=RERANK_K, bm25_k=RERANK_K,
                                   fused_k=RERANK_K, mode="int8", fused_depth=0, _qdev=qdev)
        return qdev, res, rr.rerank_rows(qt, res["fused"][1], top_k=TOP_K)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chain(0)  # warm-up
    log(f"models chain warm-up: {time.perf_counter() - t0:.1f} s")
    out, d = run("models chain: embed_device -> search_rows(_qdev) k=40 -> rerank_rows 40->10",
                 lambda: [chain(i) for i in range(N_BATCHES)], N_BATCHES)
    check(d["int8_scan_topk"] == 2 * N_BATCHES and sum(d.values()) == 2 * N_BATCHES,
          f"expected both legs' k = 160 scans per batch, got {d}")
    peak = torch.cuda.max_memory_allocated()

    # each stage alone on batch 0's inputs
    qt0 = qtexts[:BATCH]
    qdev0, res0, _ = out[0]
    rows0 = res0["fused"][1]
    def each(fn, n):  # single calls: a stall in one of them shows
        return [cuda_ms(fn, reps=1, warm=False) for _ in range(n)]

    ms_embeds = each(lambda: embed_queries_device(models, eng, qt0), 3)
    ms_searches = each(lambda: searcher.search_rows(
        None, qt0, dense_k=RERANK_K, bm25_k=RERANK_K, fused_k=RERANK_K, mode="int8",
        fused_depth=0, _qdev=qdev0), 3)
    ms_embed, ms_search = float(np.median(ms_embeds)), float(np.median(ms_searches))
    ms_rerank = cuda_ms(lambda: rr.rerank_rows(qt0, rows0, top_k=TOP_K), reps=1, warm=False)
    q_ids, q_lens = rr._tokenize(qt0, Q_LEN, np.int32)
    packed = rr.pack_pairs(torch.from_numpy(q_ids).cuda(), torch.from_numpy(q_lens).cuda(),
                           torch.from_numpy(rows0.astype(np.int64)).cuda())
    ms_ce = cuda_ms(lambda: rr._scores(*packed), reps=1, warm=False)
    flat = BATCH * RERANK_K
    chunk = min(PAIR_CHUNK, 1 << (flat - 1).bit_length())  # DeviceReranker's eff_chunk
    pairs = -(-flat // chunk) * chunk
    flops = ce_flops(ce.bert_cfg, pairs, rr.L)
    tflops = flops / (ms_ce / 1e3) / 1e12
    log(f"models stages alone (B={BATCH}): embed_queries_device {ms_embed:.1f} ms (median of "
        f"{[round(m, 1) for m in ms_embeds]}), search_rows (_qdev, k=40) {ms_search:.1f} ms "
        f"({[round(m, 1) for m in ms_searches]}), rerank_rows (40 -> 10) {ms_rerank:.1f} ms; "
        f"cross-encoder forward alone {ms_ce:.1f} ms over {pairs} pairs x {rr.L} tokens = "
        f"{flops:.3e} FLOPs: {tflops:.1f} TFLOP/s, {tflops * 1e12 / BF16_FLOPS_PER_S:.3f} of "
        f"the dense bf16 peak ({smi})")
    log(f"models max_memory_allocated: {peak / 2**30:.2f} GiB")
    del packed
    profile_batch(lambda: chain(0), "one models-chain batch")

    # (a) the reranked rows are each query's fused rows; empty slots last
    for qdev, res, (scores, rows) in out:
        fused = res["fused"][1]
        check(scores.shape == (BATCH, TOP_K) and rows.shape == (BATCH, TOP_K), rows.shape)
        live = rows >= 0
        check(live[:, 0].all() and np.isfinite(scores[live]).all(), "rerank: empty or non-finite")
        check(np.isneginf(scores[~live]).all() and (np.diff(live.astype(int), axis=1) <= 0).all(),
              "rerank: row -1 not last with -inf")
        for i in range(BATCH):
            check(set(rows[i][live[i]]) <= set(fused[i][fused[i] >= 0]),
                  f"query {i}: reranked rows outside its fused rows")
    # (b) device packing == host packing, 64 sampled (query, row) pairs
    scores0, rrows0 = out[0][2]
    pick = np.random.default_rng(SEED + 6).choice(BATCH, min(64, BATCH), replace=False)
    picked_rows = [int(rrows0[i, 0]) for i in pick]
    host = host_packed(rr, [qt0[i] for i in pick], picked_rows, texts)
    card_host_logits = ce.forward(*(torch.from_numpy(a).cuda() for a in host)).cpu().numpy()
    err_b = float(np.abs(card_host_logits - scores0[pick, 0]).max())
    check(err_b <= logit_tol(card_host_logits),
          f"device-packed logits differ from host-packed by {err_b}")
    # (c) embed_device == embed (the host path), padded rows exactly zero
    host_emb = models.embed([qt0[i] for i in pick])
    dev_emb = qdev0[torch.from_numpy(pick).cuda()].cpu().numpy()
    err_c = float(np.abs(host_emb - dev_emb).max())
    check(err_c <= BF16_EMB_ATOL, f"embed_device differs from embed by {err_c}")
    padded = models.embed_device(qt0[:100], pad_to=128)
    check(bool((padded[100:] == 0).all()), "embed_device: padded rows are not zero")
    # (d) the card's bf16 against a CPU float32 forward of the same weights
    emb32, ce32 = cpu_twins(models.embedder, ce)
    cpu_emb = emb32.embed_device([qt0[i] for i in pick], pad_to=len(pick)).numpy()
    cpu_logits = ce32.forward(*(torch.from_numpy(a) for a in host)).numpy()
    err_d = check_bf16(dev_emb, cpu_emb, scores0[pick, 0], cpu_logits, "MiniLM-L12 bf16")
    # (e) the _qdev dense leg's recall against exact fp32 search of the same vectors
    qhost = qdev0.cpu().numpy()
    recall = recall_at_10(res0["dense"][1][:, :TOP_K], exact_top10(vecs, qhost))
    check(recall >= 0.9, f"_qdev dense recall@10 {recall}")
    log(f"models checks: (a) reranked rows within the fused rows, -1 last; (b) device vs host "
        f"packing max abs {err_b:.2e}; (c) embed_device vs embed max abs {err_c:.2e}, padded "
        f"rows zero; (d) card bf16 vs CPU float32: {err_d}; (e) _qdev dense recall@10 "
        f"{recall:.4f}")
    log("phase 6 summary: " + json.dumps({
        "device": smi, "table_build_s": t_table, "chain_launches": d,
        "stage_ms": {"embed_queries_device": ms_embed, "search_rows_qdev": ms_search,
                     "rerank_rows": ms_rerank, "ce_forward": ms_ce},
        "ce_pairs": pairs, "ce_seq": rr.L, "ce_flops": flops, "ce_tflops": tflops,
        "ce_peak_share": tflops * 1e12 / BF16_FLOPS_PER_S, "max_memory_gib": peak / 2**30,
        "recall_at_10_qdev": recall}))
    del models, ce, rr, out, emb32, ce32
    torch.cuda.empty_cache()
    phase_shipped(searcher, texts, queries, qtexts)


def phase_shipped(searcher, texts, queries, qtexts):
    """The shipped 128 x 6 artifacts under the default config (preset
    trainable-small) on the card against a CPU float32 forward, then one
    hybrid + rerank batch at bench.py's cross-encoder shape (128 hidden, 4
    layers, 4 heads, FFN 256, vocab 8192, 8192 pairs a chunk; random
    weights as there)."""
    import torch

    from radiant_rag_tpu_torch.config import CrossEncoderConfig, config_from_dict
    from radiant_rag_tpu_torch.models.bert import BertConfig
    from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoder
    from radiant_rag_tpu_torch.models.device_rerank import DeviceReranker
    from radiant_rag_tpu_torch.models.embedder import Embedder
    from radiant_rag_tpu_torch.models.pretrained import PRETRAINED_DIR

    cfg = config_from_dict({})
    emb, ce = Embedder(cfg.embedding), CrossEncoder(cfg.cross_encoder)
    with np.load(PRETRAINED_DIR / "embedder_128x6.npz") as z:
        check(np.array_equal(emb.model.layer_5.mlp_out.weight.detach().cpu().numpy(),
                             z["params/layer_5/mlp_out/kernel"].T), "shipped embedder not loaded")
    with np.load(PRETRAINED_DIR / "cross_encoder_128x6.npz") as z:
        check(np.array_equal(ce.model.classifier.weight.detach().cpu().numpy(),
                             z["params/classifier/kernel"].T), "shipped cross-encoder not loaded")
    qt = qtexts[:64]
    rows = np.random.default_rng(SEED + 7).integers(0, N_DOCS, len(qt))
    host = host_packed(DeviceReranker(ce, q_len=Q_LEN, d_len=D_LEN), qt, rows, texts)
    emb32, ce32 = cpu_twins(emb, ce)
    card = (emb.embed_device(qt, pad_to=len(qt)).cpu().numpy(),
            ce.forward(*(torch.from_numpy(a).cuda() for a in host)).cpu().numpy())
    cpu = (emb32.embed_device(qt, pad_to=len(qt)).numpy(),
           ce32.forward(*(torch.from_numpy(a) for a in host)).numpy())
    log(f"shipped 128 x 6 artifacts, card bf16 vs CPU float32 on 64 queries: "
        f"{check_bf16(card[0], cpu[0], card[1], cpu[1], 'shipped artifacts')}")
    del emb, ce, emb32, ce32

    bench_ce = CrossEncoder(CrossEncoderConfig(max_seq_len=128, batch_size=512),
                            bert_cfg=BertConfig(vocab_size=8192, hidden_size=128, num_layers=4,
                                                num_heads=4, intermediate_size=256,
                                                dtype=torch.bfloat16))
    brr = DeviceReranker(bench_ce, pair_chunk=8192)
    t0 = time.perf_counter()
    brr.build_table(texts)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0

    def bench_batch(i):  # bench.py's hybrid_rerank_batch: host queries, k_cand 40
        qd, qt_ = queries[i * BATCH:(i + 1) * BATCH], qtexts[i * BATCH:(i + 1) * BATCH]
        res = searcher.search_rows(qd, qt_, dense_k=RERANK_K, bm25_k=RERANK_K, fused_k=RERANK_K,
                                   mode="int8")
        return res["fused"][1], brr.rerank_rows(qt_, res["fused"][1], top_k=TOP_K)

    fused0, (_, rows0) = bench_batch(0)  # warm-up
    check((rows0[:, 0] >= 0).all() and set(rows0[0]) <= set(fused0[0]))
    ms = [cuda_ms(lambda i=i: bench_batch(i), reps=1, warm=False) for i in range(N_BATCHES)]
    ms_rr = cuda_ms(lambda: brr.rerank_rows(qtexts[:BATCH], fused0, top_k=TOP_K), reps=2,
                    warm=False)
    log(f"bench.py shape (CE 128 hidden x 4 layers, vocab 8192, pair_chunk 8192): token table "
        f"{t_table:.1f} s; hybrid + rerank {np.median(ms):.1f} ms/batch, median of "
        f"{[round(m, 1) for m in ms]} ({BATCH / np.median(ms) * 1e3:.1f} QPS); rerank_rows alone "
        f"{ms_rr:.1f} ms")
    del bench_ce, brr
    torch.cuda.empty_cache()


def phase_memory_optimized(ck, run, launches, vecs, texts, queries, qtexts):
    """Phase 5: the memory-optimized preset at 1M docs through the store
    layer. Returns the kernel row of its sketch-leg shape (S = 512, k = 360)."""
    import torch

    from radiant_rag_tpu_torch.config import config_from_dict
    from radiant_rag_tpu_torch.index.bm25 import PersistentBM25Index
    from radiant_rag_tpu_torch.index.factory import create_vector_store
    from radiant_rag_tpu_torch.index.hybrid import HybridSearcher, resolve_fused_depth
    from radiant_rag_tpu_torch.ops import quantize as qz

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    cfg = config_from_dict(MEMORY_OPTIMIZED_PRESET)
    # the bench corpus is 384-d (the default MiniLM-class embedder; with its
    # weights set the JAX package's embedding preset leaves index.dim alone),
    # and the store starts empty in a fresh directory
    cfg = dataclasses.replace(cfg, index=dataclasses.replace(
        cfg.index, dim=DIM, data_dir=str(Path(tmp.name) / "index")))
    check(not cfg.index.store_fp32 and cfg.quantization.precision == "binary"
          and cfg.quantization.rescore_multiplier == 6.0 and cfg.bm25.sketch_dim == 512)
    fused_depth = resolve_fused_depth(cfg.retrieval)
    check(fused_depth == 60, fused_depth)

    t0 = time.perf_counter()
    store = create_vector_store(cfg)
    store.reserve(N_DOCS)
    ids = []
    for s in range(0, N_DOCS, UPSERT_BATCH):
        e = min(N_DOCS, s + UPSERT_BATCH)
        ids += store.upsert_batch([(texts[i], {"source": f"bench/doc{i}"}, vecs[i])
                                   for i in range(s, e)])
    torch.cuda.synchronize()
    t_upsert = time.perf_counter() - t0
    check(len(set(ids)) == N_DOCS, "doc ids are not unique")
    check(all(store.row_of(ids[i]) == i for i in range(0, N_DOCS, 997)),
          "store rows do not follow corpus order")
    eng = store.engine
    mem = eng.memory_bytes()
    log(f"preset store: upsert {N_DOCS} docs in {t_upsert:.1f} s "
        f"({N_DOCS / t_upsert:.0f} docs/s); capacity {eng.capacity}; engine.memory_bytes() "
        f"{mem} = {sum(mem.values()) / eng.capacity:.0f} B/row")
    check(type(store).__name__ == "TpuVectorStore" and store.default_search_mode == "binary")
    check(mem == {"fp32": 0, "binary": eng.capacity * 48, "int8": eng.capacity * DIM}, mem)

    t0 = time.perf_counter()
    pbm = PersistentBM25Index.from_config(store, cfg.bm25,
                                          path=str(Path(tmp.name) / "bm25.json.gz"))
    check(pbm.build_from_store() == N_DOCS)
    bm = pbm.index
    searcher = HybridSearcher(eng, bm)
    searcher.default_fused_depth = fused_depth
    bm.ensure_sketch(eng.capacity)
    bm.ensure_doc_major(eng.capacity)
    torch.cuda.synchronize()
    log(f"preset BM25: build_from_store + sketch in {time.perf_counter() - t0:.1f} s; "
        f"S={bm.sketch_dim}, L={bm.doc_major_width}; file written: "
        f"{(Path(tmp.name) / 'bm25.json.gz').exists()} (persist_max_docs "
        f"{cfg.bm25.persist_max_docs})")
    check(bm.sketch_dim == 512)

    mult = cfg.quantization.rescore_multiplier

    def batch(i, fetch=True):
        return searcher.search_rows(
            queries[i * BATCH:(i + 1) * BATCH], qtexts[i * BATCH:(i + 1) * BATCH],
            dense_k=TOP_K, bm25_k=TOP_K, fused_k=FUSED_K, mode=store.default_search_mode,
            rescore_multiplier=mult, fusion="confidence", fetch=fetch)

    torch.cuda.reset_peak_memory_stats()
    batch(0)  # warm-up
    res, d = run("preset: search_rows binary, fused depth 60, x6.0",
                 lambda: [batch(i) for i in range(N_BATCHES)], N_BATCHES)
    check(d["hamming_scan_topk"] == N_BATCHES and d["int8_scan_topk"] == N_BATCHES
          and d["blockmax2"] == 0,
          f"expected one Hamming and one (sketch-leg) int8 scan per batch, got {d}")
    respipe, d = run("preset: search_rows pipelined (fetch=False)",
                     lambda: [u() for u in [batch(i, fetch=False)[1]
                                            for i in range(N_BATCHES)]], N_BATCHES)
    check(d["hamming_scan_topk"] == N_BATCHES and d["int8_scan_topk"] == N_BATCHES, d)
    # a batch of the same shape whose queries lie nearer their documents
    # (noise LOW_NOISE per coordinate against the bench's 0.25, under which
    # a query's sign bits are mostly noise)
    lrng = np.random.default_rng(SEED + 2)
    lidx = lrng.integers(0, N_DOCS, BATCH)
    qlow = vecs[lidx] + LOW_NOISE * lrng.standard_normal((BATCH, DIM)).astype(np.float32)
    qlow /= np.linalg.norm(qlow, axis=1, keepdims=True)
    qlow_t = [" ".join(texts[i].split()[:6]) for i in lidx]
    reslow, d = run(f"preset: one batch at query noise {LOW_NOISE}", lambda: searcher.search_rows(
        qlow, qlow_t, dense_k=TOP_K, bm25_k=TOP_K, fused_k=FUSED_K,
        mode=store.default_search_mode, rescore_multiplier=mult, fusion="confidence"), 1)
    check(d["hamming_scan_topk"] == 1 and d["int8_scan_topk"] == 1, d)
    t0 = time.perf_counter()  # warm-up: first calls of the engine and the store
    eng.search(queries[BATCH:2 * BATCH], TOP_K, mode="binary", rescore_multiplier=mult)
    t1 = time.perf_counter()
    store.retrieve_by_embedding_batch(queries[BATCH:2 * BATCH], top_k=TOP_K)
    log(f"preset: first calls: engine.search {t1 - t0:.2f} s, then "
        f"retrieve_by_embedding_batch {time.perf_counter() - t1:.2f} s")
    hits, d = run("preset: retrieve_by_embedding_batch (top_k 10)",
                  lambda: store.retrieve_by_embedding_batch(queries[:BATCH], top_k=TOP_K), 1)
    check(d["hamming_scan_topk"] == 1 and d["int8_scan_topk"] == 0, d)
    ms = cuda_ms(lambda: eng.search(queries[:BATCH], TOP_K, mode="binary",
                                    rescore_multiplier=mult), reps=2)
    log(f"preset: of which engine.search (binary, kc 60): {ms:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    try:
        profile_batch(lambda: batch(0), "one preset batch")
    except Exception as exc:  # measurement only: report it, keep the run
        log(f"profile: unavailable ({type(exc).__name__}: {exc}); device time not measured")
    log(f"preset max_memory_allocated: {peak / 2**30:.2f} GiB")

    for r in res + respipe + [reslow]:
        for leg, k in (("dense", TOP_K), ("bm25", TOP_K), ("fused", FUSED_K)):
            s, rows = r[leg]
            check(s.shape == (BATCH, k) and rows.shape == (BATCH, k), leg)
            live = rows >= 0
            check(np.isfinite(s[live]).all() and (rows < N_DOCS).all(), leg)
            check(live[:, 0].all(), f"preset {leg}: a query returned nothing")
    for a, c in zip(res, respipe):
        for leg in ("dense", "bm25", "fused"):
            check(np.array_equal(a[leg][1], c[leg][1]), f"preset pipelined {leg} rows differ")
    for i in range(64):  # the bm25 leg returns docs holding a query term
        words = set(qtexts[i].split())
        for r in res[0]["bm25"][1][i]:
            if r >= 0:
                check(words & set(texts[r].split()), (i, r))

    # an independent witness of the stored sign words: the host vectors'
    # sign bits, packed in numpy (bit j of word w is dimension 32 w + j, the
    # JAX package's order), equal the store's words row for row
    host_words = np.packbits(vecs > 0, axis=1, bitorder="little").view("<u4").view(np.int32)
    check(np.array_equal(eng.codes[:N_DOCS].cpu().numpy(), host_words),
          "the store's sign words are not the corpus vectors' sign bits in corpus order")
    check(bool(eng.valid[:N_DOCS].all()) and not bool(eng.valid[N_DOCS:].any()),
          "the store's live rows are not the corpus rows")
    hwords = torch.from_numpy(host_words).cuda()
    del host_words
    log(f"preset sign words == numpy packbits of the corpus vectors ({N_DOCS} rows)")

    # the binary stage-1 candidates of batch 0 (fp16-rounded queries, as
    # the sketch route packs them): kernel == plain version on the same
    # device tensors for the first 256 queries
    def packed(q):
        return qz.pack_binary(torch.from_numpy(q.astype(np.float16).astype(np.float32)).cuda())

    qwords = packed(queries[:BATCH])
    kc = int(round(fused_depth * mult))
    got = ck.hamming_scan_topk(eng.codes, qwords[:256], eng.valid, kc)
    torch.cuda.synchronize()
    same(got, ck.hamming_scan_topk_reference(eng.codes, qwords[:256], eng.valid, kc))
    log(f"preset stage 1: kernel == plain version for 256 queries at kc={kc}")

    # recall: the dense leg against the exact fp32 top-10, and against what
    # a binary stage 1 allows: the plain version's candidates over the
    # witness's words, rescored exactly in fp32. The top-60 prefix of the
    # kc-360 candidates is the kc-60 candidate set (one total order), which
    # retrieve_by_embedding_batch (top_k 10 x 6.0) scans.
    def allowed_recall(q, exact, depths):
        _, cand = ck.hamming_scan_topk_reference(hwords, packed(q), None, max(depths))
        return {c: recall_at_10(stage1_rescored_top10(vecs, q, cand[:, :c]), exact)
                for c in depths}

    exact0 = exact_top10(vecs, queries[:BATCH])
    recall = recall_at_10(res[0]["dense"][1], exact0)
    hit_rows = np.full((BATCH, TOP_K), -1, np.int64)
    for i, h in enumerate(hits):
        for j, (doc, _s) in enumerate(h):
            hit_rows[i, j] = store.row_of(doc.doc_id)
    recall_store = recall_at_10(hit_rows, exact0)
    allowed = allowed_recall(queries[:BATCH], exact0, (kc, TOP_K * int(mult)))
    log(f"preset dense recall@10 vs exact fp32: {recall:.4f} (search_rows, kc {kc}; "
        f"stage 1 + exact rescore allows {allowed[kc]:.4f}), {recall_store:.4f} "
        f"(retrieve_by_embedding_batch, kc {TOP_K * int(mult)}; allows "
        f"{allowed[TOP_K * int(mult)]:.4f})")
    exact_low = exact_top10(vecs, qlow)
    recall_low = recall_at_10(reslow["dense"][1], exact_low)
    allowed_low = allowed_recall(qlow, exact_low, (kc,))[kc]
    log(f"preset dense recall@10 at query noise {LOW_NOISE}: {recall_low:.4f} (search_rows, "
        f"kc {kc}; stage 1 + exact rescore allows {allowed_low:.4f})")
    check(recall >= allowed[kc] - 0.01 and recall_store >= allowed[TOP_K * int(mult)] - 0.01,
          "the int8 rescore loses more than 0.01 recall@10 against an exact rescore")
    check(recall_low >= MIN_LOW_NOISE_RECALL,
          f"recall@10 {recall_low} at query noise {LOW_NOISE} < {MIN_LOW_NOISE_RECALL}")
    check(allowed[kc] >= 0.2, f"binary stage 1 keeps too few neighbours: {allowed[kc]}")
    del hwords

    # the sketch leg's kernel at its own shape (S = 512, k = 360)
    tb = qtexts[:BATCH]
    qind = torch.from_numpy(bm.make_query_indicator(tb, bm.query_tids(tb))).cuda()
    row = scan_rows(ck, "preset sketch S=512 k=360", bm._sketch, qind, eng.valid.clone(), kc)
    tmp.cleanup()
    return [row]


# phase 7: the serving entry point (RadiantTPU + the HTTP server)
INGEST_CHUNKS = 16_384
SERVE_CLIENTS = 256
SERVE_REQUESTS = 16  # /search requests per client in the timed load
PROFILED_REQUESTS = 2  # per client in the profiled window
SERVE_KC = 240  # both legs' stage 1: auto fused depth 60 x rescore multiplier 4.0
SERVE_BUCKETS = (1, 4, 8, 16, 32, 64, 128, 256)  # what the coalescer and warmup reach
CALIBRATION_BUCKETS = (128, 256)  # calibration_probes 128, doubled once when unstable


def serving_rows(ck, eng, bm, qdev, qtexts_):
    """Kernel rows at every (k, B) phase 7 launches: both legs' scans at
    kc = 240 for each query bucket the coalescer and warmup reach and the
    batch API's 2048 (the sketch row at 2048 is phase 3's), and the
    calibration probes' binary stage 1 at 128 and 256. Inputs: phase 7's
    store, its BM25 sketch, and a batch of bench queries embedded on the
    card (quantized, or packed to sign words, as the path does)."""
    import torch

    from radiant_rag_tpu_torch.ops import quantize as qz
    from radiant_rag_tpu_torch.ops.similarity import quantize_queries

    qi, _ = quantize_queries(qdev, qz.int8_scale_offset(eng.i8_lo, eng.i8_hi)[0])
    bm.ensure_sketch(eng.capacity)  # the sketch route's tables, as search_rows builds them
    qind = torch.from_numpy(bm.make_query_indicator(qtexts_, bm.query_tids(qtexts_))).cuda()
    qwords = qz.pack_binary(qdev)
    mask = eng.valid.clone()
    rows = []
    for b in SERVE_BUCKETS + (BATCH,):
        rows.append(scan_rows(ck, f"dense D={DIM} k={SERVE_KC} B={b} (serving)", eng.i8,
                              qi[:b].contiguous(), mask, SERVE_KC))
        if b != BATCH:
            rows.append(scan_rows(ck, f"sketch S={bm.sketch_dim} k={SERVE_KC} B={b} (serving)",
                                  bm._sketch, qind[:b].contiguous(), mask, SERVE_KC))
    csign = ck.sign_matrix(eng.codes)
    for b in CALIBRATION_BUCKETS:
        rows.append(hamming_scan_row(ck, f"W={eng.codes.shape[1]} B={b} k={SERVE_KC} "
                                     "(calibration probes)", eng.codes,
                                     qwords[:b].contiguous(), mask, SERVE_KC, csign))
    return rows


def phase_serving(ck, main_path, vecs, texts, smi, known_keys):
    """Phase 7: the serving entry point at MiniLM-L12 width over the bench
    corpus plus 16,384 ingested chunks: `RadiantTPU` over a `TpuVectorStore`
    (default preset, precision both), the fusion calibration its first
    search runs, `warmup`, then `make_server` on 127.0.0.1 under 256
    concurrent keep-alive clients through the coalescer, and the batch API
    at 2048 queries; then phase 8 over the same app and server. Returns the
    kernel rows of both phases' shapes that `known_keys` lacks."""
    import http.client
    import threading

    import torch

    from radiant_rag_tpu_torch.app import RadiantTPU
    from radiant_rag_tpu_torch.config import config_from_dict
    from radiant_rag_tpu_torch.index.factory import create_vector_store
    from radiant_rag_tpu_torch.index.hybrid import embed_queries_device, resolve_fused_depth
    from radiant_rag_tpu_torch.ingestion.processor import IngestedChunk
    from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
    from radiant_rag_tpu_torch.llm.client import LLMClient
    from radiant_rag_tpu_torch.models.registry import LocalNLPModels
    from radiant_rag_tpu_torch.server import hit_dicts, make_server

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_")
    d = Path(tmp.name)
    cfg = config_from_dict({
        "embedding": {**MINILM_PRESET["embedding"], "checkpoint_dir": str(d / "embedder_ckpt")},
        # a 1M-row save after each ingest is I/O the CPU tests cover at small size
        "index": {"data_dir": str(d / "index"), "auto_persist": False},
        "bm25": {"index_path": str(d / "bm25.json.gz")},
        "strategy_memory": {"path": str(d / "strategy_memory.json.gz")},
        "conversation": {"data_dir": str(d / "conversations")}})
    r, q, srv = cfg.retrieval, cfg.quantization, cfg.server
    check((cfg.index.dim, q.precision, q.rescore_multiplier, r.fusion_weighting,
           resolve_fused_depth(r), srv.max_batch, srv.pipeline_depth, srv.coalesce)
          == (DIM, "both", 4.0, "auto", 60, 256, 2, True), cfg)
    check(round(resolve_fused_depth(r) * q.rescore_multiplier) == SERVE_KC)
    log(f"phase 7 config: default preset, embedding preset none (MiniLM-L12 width), data "
        f"under {d}; index.auto_persist: {cfg.index.auto_persist}; fusion_weighting "
        f"{r.fusion_weighting}, calibration probes {r.calibration_probes} x seeds "
        f"{r.calibration_seeds}; server max_batch {srv.max_batch}, max_wait_ms "
        f"{srv.max_wait_ms}, pipeline_depth {srv.pipeline_depth}, request_workers "
        f"{srv.request_workers}")

    t0 = time.perf_counter()
    store = create_vector_store(cfg)
    store.reserve(N_DOCS + INGEST_CHUNKS)
    for s in range(0, N_DOCS, UPSERT_BATCH):
        e = min(N_DOCS, s + UPSERT_BATCH)
        store.upsert_batch([(texts[i], {"source": f"bench/doc{i}"}, vecs[i])
                            for i in range(s, e)])
    torch.cuda.synchronize()
    t_upsert = time.perf_counter() - t0
    eng = store.engine
    check(type(store).__name__ == "TpuVectorStore" and store.count_documents() == N_DOCS
          and store.default_search_mode == "int8" and eng.store_fp32, "phase 7 store")
    t0 = time.perf_counter()
    models = LocalNLPModels(cfg)
    t_models = time.perf_counter() - t0
    # phase 8's questions: 14-word prefixes of corpus texts, drawn with the
    # seed, and the scripted mock LLM that answers the agents about them
    arng = np.random.default_rng(SEED + 10)
    questions = list(dict.fromkeys(
        " ".join(texts[i].split()[:QUESTION_WORDS])
        for i in arng.integers(0, N_DOCS, 4 * AGENTIC_RUNS)))[:2 * AGENTIC_RUNS + SUMMARY_RUNS
                                                             + HTTP_QUERIES + 3]
    llm = LLMClient(cfg.llm, backend=MockLLMBackend(responder=ScriptedLLM(questions)))
    t0 = time.perf_counter()
    # its orchestrator resolves the BM25 index, which builds from the store
    app = RadiantTPU(cfg, llm=llm, store=store, local_models=models)
    torch.cuda.synchronize()
    t_bm = time.perf_counter() - t0
    n_bm = app.bm25_index.get_stats()["num_docs"]
    check(n_bm == N_DOCS, n_bm)
    log(f"phase 7 store: upsert {N_DOCS} docs in {t_upsert:.1f} s ({N_DOCS / t_upsert:.0f} "
        f"docs/s); models {t_models:.1f} s; RadiantTPU with its PersistentBM25Index built "
        f"from the store {t_bm:.1f} s")

    crng = np.random.default_rng(SEED + 8)
    chunks = [IngestedChunk(" ".join(f"w{t}" for t in row), {"source": f"ingest/chunk{i}"})
              for i, row in enumerate(crng.zipf(1.3, size=(INGEST_CHUNKS, 48)) % 30_000)]
    stats, d_ing, t_ing = main_path(lambda: app.ingest_chunks(chunks))
    check((stats["chunks_ingested"], stats["parents"], stats["bm25_added"], stats["bm25_removed"])
          == (INGEST_CHUNKS, INGEST_CHUNKS, INGEST_CHUNKS, 0), stats)
    n_rows = N_DOCS + INGEST_CHUNKS
    check(store.count_documents() == N_DOCS + 2 * INGEST_CHUNKS and eng.count == n_rows
          and eng.capacity >= n_rows, (store.count_documents(), eng.count, eng.capacity))
    log(f"phase 7 ingest_chunks: {INGEST_CHUNKS} chunks (hierarchical: {stats['parents']} "
        f"parents, {stats['chunks_ingested']} leaves embedded on the card) in {t_ing:.1f} s, "
        f"{INGEST_CHUNKS / t_ing:.0f} chunks/s; corpus {eng.count} rows, capacity {eng.capacity}")

    # the BM25 device tables that the ingest's adds left stale (delta
    # postings, sketch, doc-major), rebuilt here as the next search would
    bm = app.bm25_index.index
    t0 = time.perf_counter()
    bm._finalize_csr()
    bm.ensure_sketch(eng.capacity)
    bm.ensure_doc_major(eng.capacity)
    bm._device_doc_lens(eng.capacity)
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
    log(f"phase 7 BM25 device tables after the ingest (CSR merge, sketch, doc-major, doc "
        f"lengths): {t_tables:.1f} s")

    # query texts: bench-style 6-word prefixes of corpus texts, each used once
    qrng = np.random.default_rng(SEED + 9)
    pool = list(dict.fromkeys(" ".join(texts[i].split()[:6])
                              for i in qrng.integers(0, N_DOCS, 12_000)))
    n_load = SERVE_CLIENTS * SERVE_REQUESTS
    n_prof = SERVE_CLIENTS * PROFILED_REQUESTS
    first_q, pool = pool[:8], pool[8:]
    load_q, prof_q = pool[:n_load], pool[n_load:n_load + n_prof]
    api_q = pool[n_load + n_prof:n_load + n_prof + 2 * BATCH]
    check(len(api_q) == 2 * BATCH, "too few distinct query texts")

    # the first search runs the fusion calibration (fusion_weighting auto)
    orch = app.orchestrator
    hy = orch._hybrid
    check(hy is not None and hy.needs_calibration() and hy.default_fused_depth == 60)
    cal_s = []
    ensure = orch._ensure_fusion_calibration

    def timed_ensure():
        t = time.perf_counter()
        ensure()
        torch.cuda.synchronize()
        cal_s.append(time.perf_counter() - t)

    orch._ensure_fusion_calibration = timed_ensure
    first, d_cal, t_first = main_path(lambda: app.search_batch(first_q, use_cache=False))
    del orch._ensure_fusion_calibration
    cal = hy.last_calibration
    check(cal is not None and "skipped" not in cal and not hy.needs_calibration(),
          f"calibration skipped: {cal}")
    check(hy.fusion_mode == cal["fusion_mode"]
          and np.array_equal(hy.leg_weights, np.asarray(cal["weights"], np.float32)),
          "the served fusion is not the calibrated one")
    check(d_cal["hamming_scan_topk"] > 0 and all(first), d_cal)
    log(f"phase 7 calibration (inside the first search_batch of {len(first_q)}, "
        f"{t_first:.2f} s): {cal_s[0]:.2f} s; " + json.dumps(
            {k: cal[k] for k in ("fusion_mode", "weights", "dense_mrr", "bm25_mrr",
                                 "select_mrr", "confirm_mrr", "n_probes", "n_probes_final",
                                 "n_seeds", "seed_configs", "confidence_weights")})
        + f"; launches {d_cal}")

    timings, d_warm, t_warm = main_path(lambda: app.warmup(max_batch=srv.max_batch))
    check(set(timings) == {f"hybrid/b{b}" for b in SERVE_BUCKETS}, timings)
    log(f"phase 7 warmup(max_batch={srv.max_batch}): {t_warm:.1f} s, {json.dumps(timings)}")

    server = make_server(app, "127.0.0.1", 0)
    port = server.server_address[1]
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    coal = server.api._coalescer
    check(coal is not None and coal.max_batch == 256 and coal.pipeline_depth == 2
          and coal.run_batch_async is not None, "coalescer settings")
    # instrument the coalescer: when each query was submitted, and each
    # dispatched batch (its time and its queries)
    t_submit, dispatched = {}, []
    submit0, dispatch0 = coal.submit, coal.run_batch_async

    def submit(key, item, timeout=None):
        t_submit[item] = time.perf_counter()
        return submit0(key, item, timeout=timeout)

    def dispatch(key, items):
        dispatched.append((time.perf_counter(), list(items)))
        return dispatch0(key, items)

    coal.submit, coal.run_batch_async = submit, dispatch

    def http_json(conn, method, path, body=None):
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()

    def load(queries_, per_client):
        """SERVE_CLIENTS keep-alive clients, each sending its share of
        queries_ one /search at a time; returns ({query: (status, body)},
        client-side seconds per request, wall seconds after all connected)."""
        results, lat, errors = {}, [], []
        barrier = threading.Barrier(SERVE_CLIENTS + 1)

        def client(qs):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            try:
                conn.connect()
                barrier.wait(timeout=300)
                for q_ in qs:
                    t = time.perf_counter()
                    status, raw = http_json(conn, "POST", "/search",
                                            {"query": q_, "mode": "hybrid", "top_k": TOP_K})
                    lat.append(time.perf_counter() - t)
                    results[q_] = (status, json.loads(raw))
            except Exception as exc:  # reported by the caller
                errors.append(exc)
                barrier.abort()
            finally:
                conn.close()

        threads = [threading.Thread(target=client, daemon=True,
                                    args=(queries_[i * per_client:(i + 1) * per_client],))
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        barrier.wait(timeout=300)
        t0_ = time.perf_counter()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0_
        check(not any(t.is_alive() for t in threads), "a client hung")
        check(not errors, f"client errors: {errors[:3]}")
        return results, lat, wall

    (results, lat, wall), d_load, _ = main_path(lambda: load(load_q, SERVE_REQUESTS))
    n_batches_load = len(dispatched)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    status, raw = http_json(conn, "GET", "/stats")
    check(status == 200, status)
    sstats = json.loads(raw)
    serving, lat_srv = sstats["serving"], sstats["search_latency_ms"]
    waits = sorted(t_d - t_submit[q_] for t_d, items in dispatched for q_ in items)
    sizes = [len(items) for _, items in dispatched]
    lat_c = sorted(lat)
    log(f"phase 7 server load: {SERVE_CLIENTS} clients x {SERVE_REQUESTS} /search (hybrid, "
        f"top_k {TOP_K}): {n_load} requests in {wall:.2f} s = {n_load / wall:.1f} requests/s; "
        f"/stats latency p50 {lat_srv['p50']} ms, p90 {lat_srv['p90']} ms, p99 "
        f"{lat_srv['p99']} ms; client-side p50 {lat_c[len(lat_c) // 2] * 1e3:.1f} ms, p99 "
        f"{lat_c[int(0.99 * len(lat_c))] * 1e3:.1f} ms; coalescer {json.dumps(serving)}; "
        f"{n_batches_load} batches, mean size {np.mean(sizes):.1f}, sizes "
        f"{json.dumps(np.bincount(np.asarray(sizes), minlength=1).nonzero()[0].tolist()[:40])};"
        f" coalescer wait (submit -> dispatch) p50 {waits[len(waits) // 2] * 1e3:.2f} ms, p99 "
        f"{waits[int(0.99 * len(waits))] * 1e3:.2f} ms; launches {d_load}")
    check(serving["max_batch"] > 1, "the coalescer formed no batch larger than 1")
    check(serving["pipelined"] > 0, "no batch took the pipelined seam")
    check(d_load["int8_scan_topk"] > 0, d_load)

    # every response against search_batch of the same queries, in the batch
    # each was served in (same bucket, same kernels): doc ids and scores equal
    bad = 0
    for _t, items in dispatched:
        ref = app.search_batch(items, use_cache=False)
        for q_, hits in zip(items, ref):
            status, body = results[q_]
            got = [(h["doc_id"], h["score"]) for h in body["hits"]]
            bad += status != 200 or got != [(d_.doc_id, s_) for d_, s_ in hits] or not got
    check(bad == 0, f"{bad} of {n_load} responses differ from search_batch of the same queries")
    one = app.search_batch(load_q[:BATCH], use_cache=False)
    moved = sum([(h["doc_id"], h["score"]) for h in results[q_][1]["hits"]]
                != [(d_.doc_id, s_) for d_, s_ in hits] for q_, hits in zip(load_q, one))
    log(f"phase 7 responses: all {n_load} equal search_batch(use_cache=False) of their served "
        f"batch; against one {BATCH}-query batch {moved} of {BATCH} differ (the batch's "
        "composition)")

    t_prof = []
    idle, d_prof, _ = main_path(lambda: profile_batch(
        lambda: t_prof.append(load(prof_q, PROFILED_REQUESTS)[2]),
        f"phase 7: {SERVE_CLIENTS} clients x {PROFILED_REQUESTS} /search requests"))
    log(f"phase 7 profiled window: {n_prof} requests in {t_prof[0]:.2f} s "
        f"({n_prof / t_prof[0]:.1f} requests/s under the profiler), device idle share "
        f"{'not measured' if idle is None else f'{idle:.3f}'}; launches {d_prof}")

    api_ms = []
    for part in (api_q[:BATCH], api_q[BATCH:]):  # the first also grows the allocator
        (status, raw), d_api, dt = main_path(
            lambda part=part: http_json(conn, "POST", "/search",
                                        {"queries": part, "mode": "hybrid", "top_k": TOP_K}))
        check(status == 200 and len(json.loads(raw)["hits_batch"]) == BATCH, status)
        api_ms.append(dt * 1e3)
    log(f"phase 7 batch API: POST /search with {BATCH} queries: {api_ms[1]:.1f} ms (first "
        f"{api_ms[0]:.1f} ms), {len(raw) / 1e6:.1f} MB of JSON; launches {d_api}")

    # one batch's split, each stage alone at the largest coalesced batch
    qt = load_q[:srv.max_batch]
    searcher = app._fused_searcher()
    kw = dict(dense_k=TOP_K, bm25_k=TOP_K, fused_k=TOP_K, rrf_k=r.rrf_k,
              mode=store._default_mode(), rescore_multiplier=q.rescore_multiplier,
              fusion=r.fusion_weighting)

    def host_ms(fn, n=3):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return float(np.median(out))

    ms_embed = host_ms(lambda: embed_queries_device(models, eng, qt))
    qdev = embed_queries_device(models, eng, qt)
    ms_search = host_ms(lambda: searcher.search_rows(None, qt, _qdev=qdev, **kw))
    res = searcher.search_rows(None, qt, _qdev=qdev, **kw)
    ms_hydrate = host_ms(lambda: app._resolve_fused_rows(res, len(qt)))
    hits = app._resolve_fused_rows(res, len(qt))
    ms_json = host_ms(lambda: [json.dumps({"hits": hit_dicts(h)}, default=str) for h in hits])
    res2k = searcher.search_rows(None, api_q[:BATCH], **kw,
                                 _qdev=embed_queries_device(models, eng, api_q[:BATCH]))
    ms_hydrate_2k = host_ms(lambda: app._resolve_fused_rows(res2k, BATCH), n=1)
    split = {"coalescer_wait_p50": waits[len(waits) // 2] * 1e3,
             "embed_queries_device": ms_embed, "search_rows_qdev": ms_search,
             "resolve_fused_rows": ms_hydrate, "json_encoding": ms_json}
    log(f"phase 7 one batch of {len(qt)}, each stage alone (ms): {json.dumps(split)}; "
        f"_resolve_fused_rows at B={BATCH}: {ms_hydrate_2k:.1f} ms")

    # the hybrid's dense leg against exact fp32 search of the same embeddings
    qt2k = load_q[:BATCH]
    qdev2k = embed_queries_device(models, eng, qt2k)
    check(qdev2k is not None and tuple(qdev2k.shape) == (BATCH, DIM), "no device queries")
    dense = searcher.search_rows(None, qt2k, _qdev=qdev2k, **kw)["dense"][1]
    recall = recall_at_10(dense, exact_top10(eng.vecs[:eng.count], qdev2k.cpu().numpy(),
                                             eng.valid[:eng.count]))
    log(f"phase 7 dense leg recall@10 vs exact fp32 over {eng.count} rows: {recall:.4f}")
    check(recall >= 0.9, f"phase 7 dense recall@10 {recall}")

    status, raw = http_json(conn, "GET", "/health")
    health = json.loads(raw)
    check(status == 200 and health["ok"] and health["llm"], f"/health {status} {health}")
    conn.close()
    t8 = time.perf_counter()
    agentic_keys = phase_agentic(ck, main_path, app, llm, questions, port, smi)
    log(f"phase 8: {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    train_keys, mining_q = phase_training(ck, main_path, app, texts, smi, d)
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")
    server.shutdown()
    server.server_close()
    server.api.close()
    serve_thread.join(timeout=30)
    check(not serve_thread.is_alive(), "the server thread did not stop")

    rows = serving_rows(ck, eng, bm, qdev2k, qt2k)
    known = set(known_keys) | {row["_key"] for row in rows}
    rows += path_rows(ck, eng, bm, qdev2k, qt2k, sorted(agentic_keys - known), "agentic path")
    known |= {row["_key"] for row in rows}
    rows += path_rows(ck, eng, bm, qdev2k, mining_q, sorted(train_keys - known),
                      "training's BM25 mining")
    log("phase 7 summary: " + json.dumps({
        "device": smi, "corpus_rows": eng.count, "upsert_s": t_upsert, "models_s": t_models,
        "app_with_bm25_build_s": t_bm, "ingest_s": t_ing, "bm25_tables_after_ingest_s": t_tables, "ingest_chunks_per_s": INGEST_CHUNKS / t_ing,
        "calibration_s": cal_s[0], "calibration": {k: cal[k] for k in (
            "fusion_mode", "weights", "dense_mrr", "bm25_mrr", "n_probes", "n_probes_final")},
        "warmup_s": t_warm, "clients": SERVE_CLIENTS, "requests": n_load,
        "requests_per_s": n_load / wall, "p50_ms": lat_srv["p50"], "p99_ms": lat_srv["p99"],
        "coalescer": serving, "batches": n_batches_load, "mean_batch": float(np.mean(sizes)),
        "profiled_window_s": t_prof[0], "idle_share": idle, "batch_api_ms": api_ms[1], "split_ms": split,
        "resolve_fused_rows_2048_ms": ms_hydrate_2k, "dense_recall_at_10": recall}))
    t10 = time.perf_counter()
    rows += phase_pod(ck, main_path, app, vecs, texts, smi, d,
                      set(known_keys) | {row["_key"] for row in rows})
    log(f"phase 10: {time.perf_counter() - t10:.1f} s")
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    phase_graph(ck, main_path, app, vecs, texts, smi, d)
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    host_keys = phase_host_layers(ck, main_path, app, questions, texts, smi, d)
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")
    known = set(known_keys) | {row["_key"] for row in rows}
    rows += path_rows(ck, eng, bm, qdev2k, qt2k, sorted(host_keys - known), "host layers")
    t13 = time.perf_counter()
    tf_keys = phase_transformers(ck, main_path, app, questions, smi, d)
    log(f"phase 13: {time.perf_counter() - t13:.1f} s")
    known = set(known_keys) | {row["_key"] for row in rows}
    rows += path_rows(ck, eng, bm, qdev2k, qt2k, sorted(tf_keys - known),
                      "the local generator's app.query")
    del app, store, models, searcher, res, res2k, qdev, qdev2k
    tmp.cleanup()
    return rows


# phase 8: the agentic query path (RAGOrchestrator.run, the agents, the
# LLM client, /query) over phase 7's app
AGENTIC_RUNS = 64  # questions through app.query (a) and the rerank-on orchestrator (b)
SUMMARY_RUNS = 8  # questions through the compressing orchestrator
HTTP_QUERIES = 16  # concurrent /query requests beside /search load
SEARCH_CLIENTS = 32  # /search clients beside them
PROFILED_RUNS = 8
QUESTION_WORDS = 14


class ScriptedLLM:
    """The mock LLM of phase 8: deterministic replies keyed on each agent's
    fixed prompt phrases (as tests/test_orchestrator.py scripts them), over
    questions of corpus words. The plan turns decomposition, rewrite and
    expansion on (3 sub-questions, 3 rewrites, 2 expansions each: 8
    effective queries) and multihop on for every fourth question; the
    critic asks for one "context" retry at its first call on every other
    question; fact verification and citation get claims and matches that
    parse. Thread-safe (the HTTP phase calls it from 16 threads)."""

    def __init__(self, questions):
        import threading

        self.index = {q: i for i, q in enumerate(questions)}
        self.critiques = {}
        self.lock = threading.Lock()

    @staticmethod
    def _after(text, key, stop="\n"):
        return text.split(key, 1)[1].split(stop, 1)[0].strip()

    @staticmethod
    def _numbered(text):
        return [line.split(". ", 1)[1] for line in text.splitlines()
                if ". " in line and line.split(". ", 1)[0].isdigit()]

    def scripted_retry(self, question) -> bool:
        return self.index.get(question, 0) % 2 == 1

    def multihop(self, question) -> bool:
        return self.index.get(question, 0) % 4 == 3

    def __call__(self, messages):
        last = messages[-1]["content"]
        if "query-planning agent" in last:
            q = self._after(last, "Query: ")
            return json.dumps({"use_decomposition": True, "use_rewrite": True,
                               "use_expansion": True, "use_rrf": True, "use_automerge": True,
                               "use_rerank": True, "use_critic": True,
                               "use_multihop": self.multihop(q), "retrieval_mode": "hybrid",
                               "tools_to_use": []})
        if "Decompose the question" in last:
            w = self._after(last, "Question: ").split()
            return json.dumps([" ".join(w[0:5]), " ".join(w[5:10]), " ".join(w[10:])])
        if "Rewrite each query" in last:
            return json.dumps([" ".join(q.split()[::-1]) for q in self._numbered(last)])
        if "alternative phrasings" in last:
            return json.dumps([alt for q in self._numbered(last)
                               for alt in (" ".join(q.split()[1:]), " ".join(q.split()[:-1]))])
        if "SEQUENCE of sub-questions" in last:
            w = self._after(last, "Question: ").split()
            return json.dumps([" ".join(w[0:6]), "then {prev} " + " ".join(w[6:10])])
        if "Answer the sub-question" in last:
            hop = self._after(last, "Sub-question: ")
            return json.dumps({"answer": hop.split()[-1], "entities": hop.split()[:2],
                               "confidence": 0.9, "sufficient": hop.startswith("then ")})
        if "Evaluate this answer" in last:
            q = self._after(last, "Question: ")
            with self.lock:
                n = self.critiques[q] = self.critiques.get(q, 0) + 1
            retry = n == 1 and self.scripted_retry(q)
            return json.dumps({"ok": not retry, "confidence": 0.3 if retry else 0.9,
                               "relevance": 3 if retry else 9, "faithfulness": 8,
                               "coverage": 3 if retry else 8,
                               "issues": ["the answer needs other sources"] if retry else [],
                               "should_retry": retry,
                               "issue_type": "context" if retry else "none"})
        if "atomic factual claims" in last:
            return json.dumps(["The documents describe the question's terms."])
        if "For each claim" in last:
            return json.dumps([{"status": "supported", "evidence": "the terms",
                                "confidence": 0.9}])
        if "Match each answer sentence" in last:
            n = len(self._numbered(last.split("Sentences:", 1)[1]))
            return json.dumps([{"sources": [str(1 + i % 2)], "confidence": 0.9}
                               for i in range(n)])
        if "Which tools" in last:
            return "[]"
        if "Context:" in last and "Question:" in last:
            w = self._after(last, "Question: ").split()
            return (f"The retrieved documents describe {' '.join(w[:3])} in detail [DOC 1]. "
                    f"They also mention {' '.join(w[3:6])} together [DOC 2].")
        return "ok"


def path_rows(ck, eng, bm, qdev, qtexts_, keys, path):
    """Kernel rows at the (kernel, D or W, k, B) shapes a later phase
    launched that no earlier row measured. Phase 8: the dense scans of the
    dense agent and of the multihop hops (host queries, kc = 4 x top_k),
    the sketch scan, and the rerank calibration's binary stage 1 at B = 64.
    Phase 9: the training's BM25 mining, the sketch scan at kc = 16 over
    its pseudo-queries (`qtexts_`). Inputs as serving_rows takes them."""
    import torch

    from radiant_rag_tpu_torch.ops import quantize as qz
    from radiant_rag_tpu_torch.ops.similarity import quantize_queries

    qi, _ = quantize_queries(qdev, qz.int8_scale_offset(eng.i8_lo, eng.i8_hi)[0])
    qind = torch.from_numpy(bm.make_query_indicator(qtexts_, bm.query_tids(qtexts_))).cuda()
    qwords = qz.pack_binary(qdev)
    mask = eng.valid.clone()
    rows = []
    for name, width, k, b in keys:
        label = f"k={k} B={b} ({path})"
        if name == "int8_scan_topk" and width == DIM:
            rows.append(scan_rows(ck, f"dense D={DIM} {label}", eng.i8, qi[:b].contiguous(),
                                  mask, k))
        elif name == "int8_scan_topk" and width == bm.sketch_dim:
            rows.append(scan_rows(ck, f"sketch S={width} {label}", bm._sketch,
                                  qind[:b].contiguous(), mask, k))
        elif name == "hamming_scan_topk":
            rows.append(hamming_scan_row(ck, f"W={width} {label}", eng.codes,
                                         qwords[:b].contiguous(), mask, k,
                                         ck.sign_matrix(eng.codes)))
        else:
            raise AssertionError(f"the {path} launched {name} at {(width, k, b)}, which no "
                                 "row covers")
        if rows[-1]["_key"] != (name, width, k, b):
            raise AssertionError(f"row key {rows[-1]['_key']} != launch key {(name, width, k, b)}")
    return rows


class StageTimer:
    """Host ms of the pipeline's device stages, each between two device
    synchronizations: wraps methods of the shared objects for one window,
    and counts the cross-encoder's operations from the shapes it ran."""

    def __init__(self):
        self.ms, self.calls, self.ce_flops, self._undo = {}, {}, 0.0, []

    def wrap(self, obj, attr, stage):
        import torch

        fn = getattr(obj, attr)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms[stage] = self.ms.get(stage, 0.0) + (time.perf_counter() - t) * 1e3
            self.calls[stage] = self.calls.get(stage, 0) + 1
            return out

        setattr(obj, attr, timed)
        self._undo.append((obj, attr))

    def count_ce(self, ce):
        fn = ce.forward

        def forward(ids, attn, types):
            self.ce_flops += ce_flops(ce.bert_cfg, ids.shape[0], ids.shape[1])
            return fn(ids, attn, types)

        ce.forward = forward
        self._undo.append((ce, "forward"))

    def install(self, app, models, hy, orchs):
        for attr, stage in (("embed_device", "embed (device queries)"),
                            ("embed", "embed (host)"), ("embed_single", "embed (host)"),
                            ("rerank", "cross-encoder rerank")):
            self.wrap(models, attr, stage)
        self.wrap(hy, "search_rows", "search_rows")
        self.wrap(app.store, "retrieve_by_embedding_batch", "store retrieve (dense agent, hops)")
        self.wrap(app.bm25_index, "search_batch", "bm25 search (bm25 agent)")
        for orch in orchs:
            self.wrap(orch, "_hydrate", "hydration")
            self.wrap(orch, "fused_runs", "hydration")
        self.count_ce(models.cross_encoder)
        return self

    def remove(self):
        for obj, attr in reversed(self._undo):
            delattr(obj, attr)
        self._undo = []


def _pct(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))]


def _docs(hits):
    return [(d.doc_id, s) for d, s in hits]


def _close(got, want, rtol=1e-5, atol=1e-6):
    """Two (doc id, score) lists equal up to float summation order (the
    tolerance of tests/_torch_parity.py): scores within it position by
    position, and a doc out of place only where its score ties the
    expected one within it."""
    if len(got) != len(want):
        return False
    score = dict(want)
    for (gi, gs), (wi, ws) in zip(got, want):
        tol = atol + rtol * abs(ws)
        if abs(gs - ws) > tol or (gi != wi and abs(score.get(gi, float("inf")) - ws) > tol):
            return False
    return True


def _diff(got, want):
    """Where two (doc id, score) lists first differ."""
    i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    return (f"lengths {len(got)} / {len(want)}, first difference at {i}: "
            f"{got[i:i + 3]} != {want[i:i + 3]}")


def phase_agentic(ck, main_path, app, llm, questions, port, smi):
    """Phase 8: RAGOrchestrator.run with its agents over phase 7's app
    (1,016,384 leaf rows at MiniLM-L12 width) and a scripted mock LLM.
    (a) the default config through app.query, the rerank calibration in
    its first run; (b) a second orchestrator with the rerank stage on every
    run, each run's device output held against direct calls; a third
    orchestrator that compresses its context; (c) /query, /query/stream
    and /conversations over HTTP beside /search load. Returns the
    (kernel, D or W, k, B) shapes it launched."""
    import dataclasses
    import http.client
    import threading

    import torch

    from radiant_rag_tpu_torch.index.hybrid import embed_queries_device
    from radiant_rag_tpu_torch.orchestrator import RAGOrchestrator

    orch, hy, store, models = app.orchestrator, app.orchestrator._hybrid, app.store, app.local_models
    cfg, r = app.config, app.config.retrieval
    script = llm.backend.responder
    cal = hy.last_calibration
    launched = set()

    def summary(results, walls, timer, label):
        steps = {}
        for res in results:
            for st in res.metrics["steps"]:
                steps[st["name"]] = steps.get(st["name"], 0.0) + st["duration_ms"]
        per_run = {k: round(v / len(results), 3) for k, v in steps.items()}
        total = sum(walls) * 1e3
        stage = {k: round(v / len(results), 3) for k, v in timer.ms.items()}
        ce_ms = timer.ms.get("cross-encoder rerank", 0.0)
        tflops = timer.ce_flops / (ce_ms / 1e3) / 1e12 if ce_ms else 0.0
        log(f"phase 8 {label}: {len(results)} runs, wall p50 {_pct(walls, 0.5) * 1e3:.1f} ms, "
            f"p99 {_pct(walls, 0.99) * 1e3:.1f} ms, {len(results) / sum(walls):.2f} runs/s; "
            f"phase ms per run (result.metrics) {json.dumps(per_run)}; device-stage ms per run "
            f"(synchronized) {json.dumps(stage)}, calls {json.dumps(timer.calls)}; "
            f"cross-encoder {ce_ms / len(results):.2f} ms per run = "
            f"{ce_ms / total if total else 0:.3f} of the wall, {tflops:.2f} TFLOP/s "
            f"({tflops * 1e12 / BF16_FLOPS_PER_S:.4f} of the bf16 peak)")
        return {"runs": len(results), "p50_ms": _pct(walls, 0.5) * 1e3,
                "p99_ms": _pct(walls, 0.99) * 1e3, "runs_per_s": len(results) / sum(walls),
                "phase_ms_per_run": per_run, "stage_ms_per_run": stage,
                "ce_ms_per_run": ce_ms / len(results), "ce_share": ce_ms / total if total else 0,
                "ce_tflops": tflops}

    def check_result(res, label):
        check(res.success and not res.degraded, f"{label}: {res.query!r} success "
              f"{res.success}, degraded {res.degraded}")
        crit = [st["extra"]["attempt"] for st in res.metrics["steps"] if st["name"] == "critique"]
        # the critic can retry only at an attempt before the last
        want = int(script.scripted_retry(res.query) and bool(crit)
                   and crit[0] < cfg.agentic.max_critic_retries)
        check(res.retry_count == want, f"{label}: {res.query!r} retry_count {res.retry_count}, "
              f"expected {want} (critique attempts {crit})")
        if not res.low_confidence:
            check(res.citations.get("num_matches", 0) > 0 and res.fact_verification,
                  f"{label}: {res.query!r} has no citations")
        else:
            check(want == 0 and script.scripted_retry(res.query),
                  f"{label}: {res.query!r} gave up unscripted")
        json.dumps(res.to_dict())

    def run_all(label, fn, qs):
        results, walls = [], []
        for q in qs:
            t = time.perf_counter()
            results.append(fn(q))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        return results, walls

    def shapes():
        keys = dict(ck.launches_by_shape)
        launched.update(keys)
        return {"/".join(map(str, k)): v for k, v in sorted(keys.items())}

    qa, qb, qs_ = (questions[:AGENTIC_RUNS], questions[AGENTIC_RUNS:2 * AGENTIC_RUNS],
                   questions[2 * AGENTIC_RUNS:2 * AGENTIC_RUNS + SUMMARY_RUNS])
    qh = questions[2 * AGENTIC_RUNS + SUMMARY_RUNS:]
    for q in questions:
        check(len(q.split()) >= 12 and not orch._is_simple_query(q), q)

    # (a) the default config through app.query, in sequence
    timer = StageTimer().install(app, models, hy, [orch])
    cal_ms = []
    ensure = orch._ensure_rerank_calibration

    def timed_ensure():
        t = time.perf_counter()
        ensure()
        torch.cuda.synchronize()
        cal_ms.append(time.perf_counter() - t)

    orch._ensure_rerank_calibration = timed_ensure
    (res_a, walls_a), d_a, t_a = main_path(lambda: run_all(
        "a", lambda q: app.query(q, use_cache=False), qa))
    del orch._ensure_rerank_calibration
    shapes_a = shapes()
    timer.remove()
    check(hy.last_calibration is cal and not hy.needs_calibration(),
          "the fusion calibration ran again")
    verdict = orch.rerank_calibration
    check(verdict and verdict["probes"] >= 32, f"rerank calibration: {verdict}")
    log(f"phase 8 rerank calibration (inside the first run): {cal_ms[0]:.2f} s; "
        f"{json.dumps(verdict)}; rerank enabled after it: {orch.rerank.enabled}")
    for res in res_a:
        check_result(res, "phase 8 (a)")
    modes_a = {}
    for res in res_a:
        seq = "/".join(st["extra"]["mode"] for st in res.metrics["steps"]
                       if st["name"] == "retrieval")
        modes_a[seq] = modes_a.get(seq, 0) + 1
    sum_a = summary(res_a, walls_a, timer, "(a) default config, app.query")
    log(f"phase 8 (a): retrieval modes per run {json.dumps(modes_a)}; retry_count "
        f"{json.dumps({n: sum(x.retry_count == n for x in res_a) for n in (0, 1)})}; low "
        f"confidence {sum(x.low_confidence for x in res_a)}; effective queries "
        f"{json.dumps({n: sum(len(x.effective_queries) == n for x in res_a) for n in range(1, 9)})}"
        f"; launches {d_a}; by (kernel/width/k/B) {json.dumps(shapes_a)}")

    # (b) the rerank stage on every run, over the same store, BM25 index,
    # models, LLM and fused searcher (the calibration is phase 7's)
    cfg_b = dataclasses.replace(cfg, rerank=dataclasses.replace(cfg.rerank,
                                                                auto_disable_probes=0))

    def orchestrator(c):
        o = RAGOrchestrator(c, store, app.bm25_index, models, app.llm,
                            device_lock=app.device_lock)
        o._hybrid = hy
        return o

    orch_b = orchestrator(cfg_b)
    timer = StageTimer().install(app, models, hy, [orch_b])
    (res_b, walls_b), d_b, t_b = main_path(lambda: run_all("b", orch_b.run, qb))
    shapes_b = shapes()
    timer.remove()
    sum_b = summary(res_b, walls_b, timer, "(b) rerank on every run")
    level = {"leaves": 0, "parents": 1, "all": -1}[r.search_scope]

    def doc_of(row):
        did = store.id_for_row(int(row))
        return store.get_doc(did) if did else None

    def dedup(hits):
        best = {}
        for d, s in hits:
            if d.doc_id not in best or s > best[d.doc_id][1]:
                best[d.doc_id] = (d, s)
        return sorted(best.values(), key=lambda ds: -ds[1])

    def rrf(runs, k):
        score, first = {}, {}
        for run in runs:
            for rank, (d, _s) in enumerate(run, start=1):
                score[d.doc_id] = score.get(d.doc_id, 0.0) + 1.0 / (r.rrf_k + rank)
                first.setdefault(d.doc_id, d)
        return [(first[i], s) for i, s in sorted(score.items(), key=lambda kv: -kv[1])[:k]]

    def expected_fused(res, mode):
        eq = res.effective_queries
        if mode == "hybrid":
            qdev = embed_queries_device(models, hy.engine, eq)
            out = hy.search_rows(None, eq, _qdev=qdev, dense_k=r.dense_top_k,
                                 bm25_k=r.bm25_top_k, fused_k=r.fused_top_k, rrf_k=r.rrf_k,
                                 mode=store.default_search_mode,
                                 rescore_multiplier=cfg.quantization.rescore_multiplier,
                                 level_code=level, fusion=r.fusion_weighting)
            fs, fr = out["fused"]
            runs = [[(doc_of(x), float(s)) for s, x in zip(fs[i], fr[i]) if x >= 0]
                    for i in range(len(eq))]
            runs = [run for run in runs if run]
            return rrf(runs, r.fused_top_k) if len(runs) > 1 else runs[0][:r.fused_top_k]
        # one leg, fused with the other leg's docs that an earlier attempt
        # of the run left in the context (as the pipeline does)
        if mode == "dense":
            hits = store.retrieve_by_embedding_batch(models.embed(eq), top_k=r.dense_top_k,
                                                     min_similarity=r.min_similarity,
                                                     doc_level_filter="leaf")
            leg, runs = dedup([h for q in hits for h in q]), None
            check(_docs(res.dense_docs) == _docs(leg), f"dense_docs of {res.query!r}: "
                  f"{_diff(_docs(res.dense_docs), _docs(leg))}")
            runs = [x for x in (leg, res.bm25_docs) if x]
        else:
            # the standalone BM25 search sums postings with a scatter-add,
            # whose float order the card does not fix: its leg is held to
            # the parity tolerance, the fusion of the run's own leg exactly
            hits = app.bm25_index.search_batch(eq, top_k=r.bm25_top_k)
            want = _docs(dedup([h for q in hits for h in q]))
            check(_close(_docs(res.bm25_docs), want),
                  f"bm25_docs of {res.query!r}: {_diff(_docs(res.bm25_docs), want)}")
            leg = res.bm25_docs
            runs = [x for x in (res.dense_docs, leg) if x]
        return rrf(runs, r.fused_top_k) if len(runs) > 1 else leg[:r.fused_top_k]

    checked, hops, by_mode = 0, [], {}
    for res in res_b:
        check_result(res, "phase 8 (b)")
        mode = [st["extra"]["mode"] for st in res.metrics["steps"]
                if st["name"] == "retrieval"][-1]
        by_mode[mode] = by_mode.get(mode, 0) + 1
        if script.multihop(res.query):
            n_hops = sum(st["name"] == "multihop" for st in res.metrics["steps"])
            hops.append((n_hops, sum(s == 0.7 for _, s in res.fused_docs)))
        else:
            want = expected_fused(res, mode)
            check(_docs(res.fused_docs) == _docs(want),
                  f"phase 8 (b) {mode}: fused_docs differ from a direct call for {res.query!r}")
            checked += 1
        merged = orch_b.automerge.merge(res.fused_docs)
        want = orch_b.rerank.rerank(res.query, merged, orch_b.rerank.top_k)
        check(res.reranked_docs and _docs(res.reranked_docs) == _docs(want),
              f"phase 8 (b): reranked_docs differ from rerank.rerank for {res.query!r}")
    log(f"phase 8 (b): fused_docs equal the direct hydrated search of the run's effective "
        f"queries on {checked} runs (final retrieval mode {json.dumps(by_mode)}), doc ids and "
        f"scores exactly; reranked_docs equal rerank.rerank on all {len(res_b)}; multihop runs "
        f"(hop steps, hop docs merged at 0.7): {hops}; launches {d_b}; by "
        f"(kernel/width/k/B) {json.dumps(shapes_b)}")

    idle = profile_batch(lambda: [orch_b.run(q) for q in qb[:PROFILED_RUNS]],
                         f"phase 8: {PROFILED_RUNS} runs of (b)")
    shapes()

    # a third orchestrator whose context is over its compression threshold:
    # the summarization's dedup embeds the docs on the card
    cfg_s = dataclasses.replace(cfg_b, summarization=dataclasses.replace(
        cfg.summarization, max_total_context_chars=1000))
    orch_s = orchestrator(cfg_s)
    stats = []
    compress = orch_s.summarization.compress

    def recorded(docs):
        out, st = compress(docs)
        stats.append(dict(st.__dict__))
        return out, st

    orch_s.summarization.compress = recorded
    (res_s, walls_s), d_s, _ = main_path(lambda: run_all("s", orch_s.run, qs_))
    shapes()
    for res in res_s:
        check_result(res, "phase 8 (summarization)")
        want = [d for d, _ in orch_s.rerank.rerank(res.query, orch_s.automerge.merge(
            res.fused_docs), orch_s.rerank.top_k)]
        got = [d.doc_id for d, _ in res.reranked_docs]
        it = iter(d.doc_id for d in want)
        check(got and all(x in it for x in got),
              f"phase 8 summarization: {got} is not an in-order subset of the rerank")
    check(stats and all(st["docs_deduped"] + st["docs_summarized"] >= 0 for st in stats))
    log(f"phase 8 summarization (max_total_context_chars 1000): {len(res_s)} runs, p50 "
        f"{_pct(walls_s, 0.5) * 1e3:.1f} ms; compression stats {json.dumps(stats)}; "
        f"launches {d_s}")

    # (c) HTTP: concurrent /query beside /search load, one stream, a conversation
    def post(conn, path, body):
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()

    q_lat, search_lat, errors = [], [], []
    stop = threading.Event()
    search_q = [" ".join(q.split()[:6]) for q in questions]

    def connected():  # opened one at a time, before the window (the listen backlog is 5)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.connect()
        return conn

    def querier(q, conn):
        try:
            t = time.perf_counter()
            status, raw = post(conn, "/query", {"question": q})
            q_lat.append(time.perf_counter() - t)
            body = json.loads(raw)
            if status != 200 or not body["success"] or body["degraded"]:
                errors.append((q, status, body.get("error", body.get("degraded"))))
        except Exception as exc:  # reported below
            errors.append((q, exc))
        finally:
            conn.close()

    def searcher_client(i, conn):
        try:
            n = i
            while not stop.is_set():
                t = time.perf_counter()
                status, _raw = post(conn, "/search", {"query": search_q[n % len(search_q)],
                                                      "mode": "hybrid", "top_k": TOP_K})
                search_lat.append(time.perf_counter() - t)
                n += SEARCH_CLIENTS
                if status != 200:
                    errors.append(("/search", status))
        except Exception as exc:
            errors.append(("/search", exc))
        finally:
            conn.close()

    def http_window():
        searchers = [threading.Thread(target=searcher_client, args=(i, connected()),
                                      daemon=True) for i in range(SEARCH_CLIENTS)]
        queriers = [threading.Thread(target=querier, args=(q, connected()), daemon=True)
                    for q in qh[:HTTP_QUERIES]]
        for t in searchers + queriers:
            t.start()
        t0 = time.perf_counter()
        for t in queriers:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        stop.set()
        for t in searchers:
            t.join(timeout=60)
        check(not any(t.is_alive() for t in searchers + queriers), "an HTTP client hung")
        return wall

    wall_c, d_c, _ = main_path(http_window)
    shapes()
    check(not errors, f"phase 8 HTTP errors: {errors[:3]}")
    check(len(q_lat) == HTTP_QUERIES and search_lat, "phase 8: missing HTTP answers")
    log(f"phase 8 HTTP: {HTTP_QUERIES} concurrent /query in {wall_c:.2f} s, latency p50 "
        f"{_pct(q_lat, 0.5) * 1e3:.1f} ms, p99 {_pct(q_lat, 0.99) * 1e3:.1f} ms; beside them "
        f"{len(search_lat)} /search from {SEARCH_CLIENTS} clients "
        f"({len(search_lat) / wall_c:.1f} requests/s), p50 {_pct(search_lat, 0.5) * 1e3:.1f} "
        f"ms, p99 {_pct(search_lat, 0.99) * 1e3:.1f} ms; launches {d_c}")

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    stream_q = qh[HTTP_QUERIES]
    t = time.perf_counter()
    conn.request("POST", "/query/stream", json.dumps({"question": stream_q}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    check(resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream")
    raw = resp.read().decode()
    t_stream = time.perf_counter() - t
    conn.close()
    events = [json.loads(c[len("data: "):]) for c in raw.split("\n\n") if c]
    kinds = [e["event"] for e in events]
    starts = [e["step"] for e in events if e["event"] == "step_start"]
    check(kinds.count("result") == 1 and kinds[-1] == "result" and "error" not in kinds
          and "token" in kinds and starts == [e["step"] for e in events
                                              if e["event"] == "step_end"]
          and {"planning", "retrieval", "post_retrieval", "generation"} <= set(starts),
          f"/query/stream events: {kinds}")
    check(events[-1]["success"] and not events[-1]["degraded"], events[-1])
    log(f"phase 8 /query/stream: {len(events)} events ({kinds.count('token')} tokens, steps "
        f"{starts}) in {t_stream * 1e3:.1f} ms")

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    status, raw = post(conn, "/conversations", {})
    cid = json.loads(raw)["conversation_id"]
    turns = []
    for q in qh[HTTP_QUERIES + 1:HTTP_QUERIES + 3]:
        status, raw = post(conn, "/query", {"question": q, "conversation_id": cid})
        check(status == 200, raw[:300])
        turns.append(json.loads(raw))
    conn.close()
    synth = [c for c in llm.backend.calls if c[-1]["content"].startswith("Context:")
             and c[-1]["content"].endswith(f"Question: {turns[1]['query']}")]
    check(synth and synth[-1][1:3] == [{"role": "user", "content": turns[0]["query"]},
                                      {"role": "assistant", "content": turns[0]["answer"]}],
          "the conversation's second synthesis prompt does not carry the first turn")
    check([x.query for x in app.conversations.get(cid).turns] == [x["query"] for x in turns])
    log(f"phase 8 /conversations: {cid}, two /query turns; the second synthesis prompt "
        f"carries the first turn")
    log("phase 8 summary: " + json.dumps({
        "device": smi, "rerank_calibration_s": cal_ms[0], "rerank_calibration": verdict,
        "a": sum_a, "b": sum_b, "idle_share_b": idle, "b_checked_fused": checked,
        "summarization_p50_ms": _pct(walls_s, 0.5) * 1e3,
        "http_query_p50_ms": _pct(q_lat, 0.5) * 1e3, "http_query_p99_ms": _pct(q_lat, 0.99) * 1e3,
        "http_search_requests_per_s": len(search_lat) / wall_c,
        "stream_ms": t_stream * 1e3}))
    return launched


# phase 9: embedder and cross-encoder training on phase 7's app
TRAIN_STEPS = 40  # app.train: batch 256 with 2 hard negatives, lr 1e-4, warmup + cosine
TRAIN_BATCH = 256
TRAIN_HARD = 2
TRAIN_LR = 1e-4
CE_STEPS = 20  # train_cross_encoder: 16 groups of 1 + 2 hard + 1 random
CE_BATCH = 64
PROFILED_STEPS = 4
PROFILE_FROM = 10  # the first profiled step (the allocator has grown by then)
CHECK_BATCH = 32  # queries of the bf16-vs-float32 step check (x 4 sequences each)
# One AdamW step at bf16 on the card against float32 on the CPU, from the
# same init and batch: the loss within 5e-3, and the update of the first
# and of the last layer (p1 - p0 over the layer's tensors, lr x ~sign(grad)
# after one Adam step) at cosine >= 0.95 / 0.82 to the CPU's. That is 3x
# the worst gap of bf16 against float32 on the CPU at this width over 8
# sampled batches of this size (PERF.md, PR 10): loss 1.7e-3, 1 - cosine
# 0.016 / 0.059. The card's bf16 measured within the same spread (loss
# <= 1.5e-3, cosine >= 0.984 / 0.934; cuBLAS's reduced-precision bf16
# reductions on or off gave equal results). The CPU's own bf16 step runs
# and is logged beside it each time.
TRAIN_LOSS_ATOL, TRAIN_MIN_UPDATE_COS = 5e-3, (0.95, 0.82)


ID_KEYS = ("ids", "q_ids", "d_ids", "n_ids")  # the samplers' token arrays
MASK_KEYS = ("mask", "q_mask", "d_mask", "n_mask")


def train_flops(cfg, batch) -> float:
    """Operations of one training step: 3 x the encoder forward over every
    token array of the batch (the backward takes 2 x the forward; the
    losses, the pooler and the optimizer are left out)."""
    return 3 * sum(encoder_flops(cfg, *batch[k].shape) for k in ID_KEYS if k in batch)


class TrainProbe:
    """Instruments one trainer run without changing it: CUDA events around
    each step (the device's step time; no synchronization added), the
    sampler's next_batch and the BM25 mining searches on the host clock,
    the tokens and operations of each batch, the first step's metrics, and
    a torch.profiler window over PROFILED_STEPS whole iterations."""

    def __init__(self, builder, sampler_cls, bm, cfg):
        from radiant_rag_tpu_torch.parallel import train as train_mod

        self.train_mod, self.builder, self.sampler_cls, self.bm, self.cfg = (
            train_mod, builder, sampler_cls, bm, cfg)
        self.events, self.starts, self.flops, self.padded, self.real = [], [], 0.0, 0, 0
        self.host_ms, self.mine_ms, self.mine_span, self.mine_queries = [], [], [], []
        self.first, self.sampler, self.idle, self.prof_wall = None, None, None, None
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        orig_builder = getattr(self.train_mod, self.builder)
        orig_next = self.sampler_cls.next_batch
        orig_search = self.bm.search_rows_batch
        probe = self

        def builder(*args, **kwargs):
            step, place = orig_builder(*args, **kwargs)

            def timed(state, batch):
                i = len(probe.events)
                if i == PROFILE_FROM:
                    torch.cuda.synchronize()
                    # device activity only: the CPU op records would slow the
                    # host, whose share of the iteration is what idle measures
                    probe._prof = profile(activities=[ProfilerActivity.CUDA])
                    probe._prof.__enter__()
                    probe._t_prof = time.perf_counter()
                elif i == PROFILE_FROM + PROFILED_STEPS:
                    torch.cuda.synchronize()
                    probe.prof_wall = time.perf_counter() - probe._t_prof
                    probe._prof.__exit__(None, None, None)
                    probe.idle = device_report(probe._prof, probe.prof_wall * 1e6,
                                               f"phase 9 {probe.builder}: {PROFILED_STEPS} "
                                               "whole training iterations")
                probe.starts.append(time.perf_counter())
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                state, metrics = step(state, batch)
                e1.record()
                probe.events.append((e0, e1))
                if i == 0:  # one fetch, at the first step
                    probe.first = {k: float(v) for k, v in metrics.items()}
                return state, metrics

            return timed, place

        def next_batch(sampler):
            probe.sampler = sampler
            t = time.perf_counter()
            out = orig_next(sampler)
            probe.host_ms.append((time.perf_counter() - t) * 1e3)
            probe.padded += sum(out[k].size for k in ID_KEYS if k in out)
            probe.real += int(sum(out[k].sum() for k in MASK_KEYS if k in out))
            probe.flops += train_flops(probe.cfg, out)
            return out

        def search_rows_batch(queries, *args, **kwargs):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            e0.record()
            out = orig_search(queries, *args, **kwargs)  # fetched: synchronized
            e1.record()
            probe.mine_ms.append((time.perf_counter() - t) * 1e3)
            probe.mine_span.append((e0, e1))
            probe.mine_queries = list(queries)
            return out

        setattr(self.train_mod, self.builder, builder)
        self.sampler_cls.next_batch = next_batch
        self.bm.search_rows_batch = search_rows_batch
        self._undo = lambda: (setattr(self.train_mod, self.builder, orig_builder),
                              setattr(self.sampler_cls, "next_batch", orig_next),
                              self.bm.__dict__.pop("search_rows_batch"))
        return self

    def __exit__(self, *exc):
        self._undo()
        return False

    def summary(self, label, wall_s, last, peak_bytes, smi):
        step_ms = [a.elapsed_time(b) for a, b in self.events]
        n = len(step_ms)
        dev_s = sum(step_ms) / 1e3
        tflops = self.flops / dev_s / 1e12
        # the sampler's own host work: next_batch less its mining search,
        # whose wall time includes waiting for the step queued before it
        host = [h - m for h, m in zip(self.host_ms, self.mine_ms)] if self.mine_ms else \
            self.host_ms
        span = [a.elapsed_time(b) for a, b in self.mine_span]
        # host wall from one step's start to the next, steady state: after
        # the first two steps (allocator growth), outside the profiled window
        gaps = np.diff(self.starts)
        steady = [g * 1e3 for i, g in enumerate(gaps, 1)
                  if i > 2 and not PROFILE_FROM < i <= PROFILE_FROM + PROFILED_STEPS]
        out = {"device": smi, "steps": n, "wall_s": wall_s,
               "step_ms_p50": _pct(step_ms, 0.5), "step_ms_p99": _pct(step_ms, 0.99),
               "iteration_ms": wall_s / n * 1e3,
               "steady_iteration_ms_p50": _pct(steady, 0.5) if steady else None,
               "padded_tokens_per_step": self.padded / n, "real_tokens_per_step": self.real / n,
               "tokens_per_s": self.padded / wall_s, "real_tokens_per_s": self.real / wall_s,
               "tflop_per_step": self.flops / n / 1e12, "tflops_device": tflops,
               "bf16_peak_share": tflops * 1e12 / BF16_FLOPS_PER_S,
               "tflops_wall": self.flops / wall_s / 1e12,
               "mining_wall_ms_per_step": float(np.mean(self.mine_ms)) if span else 0.0,
               "mining_device_span_ms_p50": _pct(span, 0.5) if span else 0.0,
               "sampler_host_ms_per_step": float(np.mean(host)),
               "idle_share": self.idle, "profiled_window_s": self.prof_wall,
               "peak_gib": peak_bytes / 2**30, "first": self.first, "last": last}
        log(f"phase 9 {label}: {json.dumps(out)}")
        return out


def train_step_check(sampler, ckpt_cfg, card):
    """One AdamW step at bf16 on the card against float32 on the CPU from
    the same seeded init and the same sampled batch (CHECK_BATCH queries,
    their documents and mined negatives): the loss and the update of the
    first and last layer within the stated tolerance. Then the loss on
    that one batch, repeated, falls over 10 steps on the card."""
    import torch

    from radiant_rag_tpu_torch.models.bert import BertConfig, init_params
    from radiant_rag_tpu_torch.parallel.train import contrastive_train_step, make_train_state

    cfg = BertConfig(vocab_size=ckpt_cfg.vocab_size, hidden_size=ckpt_cfg.dim,
                     num_layers=ckpt_cfg.num_layers, num_heads=ckpt_cfg.num_heads,
                     intermediate_size=ckpt_cfg.hidden_dim, dtype=torch.float32)
    init = init_params(cfg, seed=SEED)
    saved = sampler.batch_size
    sampler.batch_size = CHECK_BATCH
    batch = sampler.next_batch()
    sampler.batch_size = saved
    runs = {}
    for label, dev, dtype in (("card bf16", card, torch.bfloat16),
                              ("cpu float32", "cpu", torch.float32),
                              ("cpu bf16", "cpu", torch.bfloat16)):
        state = make_train_state(dataclasses.replace(cfg, dtype=dtype), learning_rate=TRAIN_LR,
                                 init_params_tree=init, device=dev)
        step, place = contrastive_train_step(dev)
        t = time.perf_counter()
        state, met = step(state, place(batch))
        loss = float(met["loss"])
        runs[label] = (state, step, place, loss, time.perf_counter() - t)
    card, cpu = runs["card bf16"], runs["cpu float32"]

    def update_cos(run, layer):
        """Cosine of the layer's whole update to the CPU float32 one; the
        attention key bias is left out: its exact gradient is 0 (softmax
        is invariant to it), so both runs step it by Adam-scaled noise."""
        names = [n for n in init if n.startswith(f"layer_{layer}.")
                 and not n.endswith("attention.key.bias")]
        u = torch.cat([(run[0].params[n].float().cpu() - init[n]).flatten()
                       for n in names]).double()
        u_ref = torch.cat([(cpu[0].params[n] - init[n]).flatten() for n in names]).double()
        return float(u @ u_ref / (u.norm() * u_ref.norm()))

    layers = (0, cfg.num_layers - 1)
    cos = {layer: update_cos(card, layer) for layer in layers}
    cpu_cos = [update_cos(runs["cpu bf16"], layer) for layer in layers]
    gap = abs(card[3] - cpu[3])
    log(f"phase 9 bf16 step check ({CHECK_BATCH} queries, {batch['q_ids'].shape[1]} tokens, "
        f"{sum(v.shape[0] for k, v in batch.items() if k.endswith('ids'))} sequences): loss "
        f"card {card[3]:.6f} / cpu {cpu[3]:.6f} (|diff| {gap:.2e}, tol {TRAIN_LOSS_ATOL}); "
        f"update cosine of the first / last layer {cos[0]:.6f} / "
        f"{cos[cfg.num_layers - 1]:.6f} (tol {TRAIN_MIN_UPDATE_COS}); the CPU's own bf16 step: "
        f"loss |diff| {abs(runs['cpu bf16'][3] - cpu[3]):.2e}, cosine {cpu_cos[0]:.6f} / "
        f"{cpu_cos[1]:.6f}; cpu steps {cpu[4]:.1f} / {runs['cpu bf16'][4]:.1f} s")
    check(gap <= TRAIN_LOSS_ATOL, f"bf16 step loss differs from float32 by {gap}")
    check(all(c >= t for c, t in zip(cos.values(), TRAIN_MIN_UPDATE_COS)),
          f"bf16 step update cosine {cos}")
    state, step, place = card[:3]
    losses = [card[3]]
    for _ in range(9):
        state, met = step(state, place(batch))
        losses.append(float(met["loss"]))
    log(f"phase 9 one batch repeated, 10 steps on the card: losses {json.dumps(losses)}")
    check(losses[-1] < losses[0], f"the loss on a repeated batch did not fall: {losses}")
    return {"loss_gap": gap, "update_cos": [cos[layer] for layer in layers],
            "cpu_bf16_loss_gap": abs(runs["cpu bf16"][3] - cpu[3]), "cpu_bf16_update_cos": cpu_cos,
            "repeated_losses": losses}


def phase_training(ck, main_path, app, texts, smi, tmp_dir: Path):
    """Phase 9: training on phase 7's app (1,016,384 leaf rows, MiniLM-L12
    width, bf16). (a) `app.train` at batch 256 with 2 BM25-mined hard
    negatives (1,024 sequences a step), then the checks: a bf16 card step
    against a float32 CPU step, a repeated batch's falling loss, the
    checkpoint restored bit for bit by a fresh Embedder, the swapped
    encoder serving `app.search`, the calibration run again. (b)
    `train_cross_encoder` at the cross-encoder's width over the corpus
    texts with the app's BM25 index. Returns the (kernel, D or W, k, B)
    shapes the training launched and the last mining queries."""
    import torch

    from radiant_rag_tpu_torch.models.embedder import Embedder
    from radiant_rag_tpu_torch.parallel import data as tdata

    bm = app.bm25_index.index
    emb = app.local_models.embedder
    hy = app.orchestrator._hybrid
    launched = set()
    ckpt_dir = tmp_dir / "train_ckpt"

    # (a) the embedder
    cal_before = hy.last_calibration
    from_store_s = []
    orig_from_store = tdata.ContrastivePairSampler.from_store.__func__

    def timed_from_store(cls, *args, **kwargs):
        t = time.perf_counter()
        out = orig_from_store(cls, *args, **kwargs)
        from_store_s.append(time.perf_counter() - t)
        return out

    tdata.ContrastivePairSampler.from_store = classmethod(timed_from_store)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        with TrainProbe("contrastive_train_step", tdata.ContrastivePairSampler, bm,
                        emb.bert_cfg) as probe:
            metrics, d_train, t_train = main_path(lambda: app.train(
                steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR,
                checkpoint_dir=str(ckpt_dir), hard_negatives=TRAIN_HARD))
    finally:
        tdata.ContrastivePairSampler.from_store = classmethod(orig_from_store)
    launched.update(ck.launches_by_shape)
    peak = torch.cuda.max_memory_allocated()
    mining_queries = probe.mine_queries
    log(f"phase 9 app.train: {TRAIN_STEPS} steps in {t_train:.1f} s (from_store over "
        f"{len(probe.sampler.texts)} docs {from_store_s[0]:.1f} s); metrics {json.dumps(metrics)}"
        f"; device memory resident before {resident / 2**30:.2f} GiB, peak "
        f"{peak / 2**30:.2f} GiB; launches {d_train}, by shape "
        f"{json.dumps({'/'.join(map(str, k)): v for k, v in sorted(ck.launches_by_shape.items())})}")
    check(metrics["steps_run"] == TRAIN_STEPS and np.isfinite(metrics["loss"]), metrics)
    check(d_train["int8_scan_topk"] > 0, f"mining launched no sketch scan: {d_train}")
    sum_a = probe.summary("(a) embedder training", t_train - from_store_s[0], metrics, peak,
                          smi)
    sum_a["from_store_s"] = from_store_s[0]
    check(len(probe.events) == TRAIN_STEPS and len(probe.mine_ms) == TRAIN_STEPS,
          (len(probe.events), len(probe.mine_ms)))

    # the checkpoint, restored by a fresh process's Embedder, is the swap
    from radiant_rag_tpu_torch.parallel.checkpoint import TrainCheckpointer

    check(TrainCheckpointer(str(ckpt_dir)).latest_step() == TRAIN_STEPS,
          f"latest_step {TrainCheckpointer(str(ckpt_dir)).latest_step()}")
    fresh = Embedder(dataclasses.replace(emb.config, checkpoint_dir=str(ckpt_dir)),
                     device=emb.device)
    served = emb.model.state_dict()
    for name, value in fresh.model.state_dict().items():
        check(torch.equal(value, served[name]), f"restored {name} differs from the swap")
    q = mining_queries[:8]
    check(np.array_equal(app.local_models.embed(q), fresh.embed(q)),
          "the served encoder embeds other than the restored one")
    check(hy.needs_calibration(), "app.train left the calibration in place")
    hits, d_search, t_search = main_path(lambda: app.search_batch(q, use_cache=False))
    launched.update(ck.launches_by_shape)
    check(not hy.needs_calibration() and hy.last_calibration is not cal_before
          and all(hits), "the calibration did not run again at the next search")
    log(f"phase 9 after the swap: the checkpoint (step {TRAIN_STEPS}) restores bit for bit in a "
        f"fresh Embedder, which embeds as the served encoder; the next search_batch ran the "
        f"calibration again ({t_search:.2f} s): " + json.dumps(
            {k: hy.last_calibration[k] for k in ("fusion_mode", "weights", "dense_mrr",
                                                 "bm25_mrr")}))
    checks = train_step_check(probe.sampler, emb.config, emb.device)

    # (b) the cross-encoder over the corpus texts and the app's BM25 index
    store = app.store
    for r in (0, 1, N_DOCS // 2, N_DOCS - 1):
        check(store.get_doc(store.id_for_row(r)).content == texts[r], f"row {r} is not doc {r}")
    ce_cfg = app.local_models.cross_encoder.bert_cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with TrainProbe("cross_encoder_train_step", tdata.CrossEncoderPairSampler, bm,
                    ce_cfg) as probe_ce:
        ce_metrics, d_ce, t_ce = main_path(lambda: tdata.train_cross_encoder(
            texts, bert_cfg=ce_cfg, device=app.device, steps=CE_STEPS, batch_size=CE_BATCH, learning_rate=5e-5,
            max_seq_len=128, log_every=CE_STEPS, seed=SEED, bm25=bm, rows=range(N_DOCS),
            hard_negatives=2, random_negatives=1, device_lock=app.device_lock))
    launched.update(ck.launches_by_shape)
    peak_ce = torch.cuda.max_memory_allocated()
    check(ce_metrics["steps_run"] == CE_STEPS and np.isfinite(ce_metrics["loss"]), ce_metrics)
    check(d_ce["int8_scan_topk"] > 0, f"CE mining launched no sketch scan: {d_ce}")
    log(f"phase 9 train_cross_encoder: {CE_STEPS} steps of {CE_BATCH} pairs in {t_ce:.1f} s; "
        f"metrics {json.dumps(ce_metrics)}; launches {d_ce}")
    sum_b = probe_ce.summary("(b) cross-encoder training", t_ce, ce_metrics, peak_ce, smi)

    # (c) the dp x tp layout on logical shards of the card; (d) on real cards
    t_c = time.perf_counter()
    mesh_keys, sum_c, mesh_batches = phase_training_mesh(ck, main_path, app, probe.sampler,
                                                         texts, smi, emb.device)
    launched |= mesh_keys
    log(f"phase 9 (c): {time.perf_counter() - t_c:.1f} s")
    sum_d = phase_training_cards(mesh_batches, emb.bert_cfg, smi)
    log("phase 9 summary: " + json.dumps({"a": sum_a, "b": sum_b, "checks": checks,
                                          "resident_gib": resident / 2**30,
                                          "c_s": time.perf_counter() - t_c,
                                          "d_ran": sum_d is not None}))
    return launched, mining_queries


# phase 9 (c) and (d): the dp x tp training layout
MESH_STEPS = 3  # steps held against the (1, 1) run
MESH_TIMED = 6  # steps timed after them (p50, launches, peak memory)
MESH_SHAPES = ((1, 1), (2, 2))  # logical shards of one card
CE_MESH_SHAPES = ((1, 1), (2, 1))
# float32: the first step's gradients within tests/test_torch_train.py's
# gradient tolerance (rtol 1e-4, atol 1e-6), each step's loss within rtol
# 1e-5, and after 3 steps every parameter within steps x lr, the count
# past the CPU tests' 2e-5 reported (tests/test_torch_parallel_train.py
# holds 2e-5 at its width; at this width an element whose gradient lies
# within float32 summation noise can take Adam's normalized step, up to
# lr a step, either way: the allowance the CPU tests give the attention
# key biases, whose exact gradient is 0). bfloat16, every mesh against the
# bf16 (1, 1) run: each step's loss within 1e-2, and the update of the
# first and last layer at cosine >= 0.99 / 0.9 (the row-split partials
# round to bf16 before their sum, and half a batch's products round
# otherwise; at 12 layers the difference grows with depth: the sound runs
# read 0.997 / 0.972 and the cross-encoder's (2, 1) 0.999 / 0.952). A
# mesh with a model axis also meets the band phase 9 holds the
# single-device bf16 step to against float32 (TRAIN_LOSS_ATOL,
# TRAIN_MIN_UPDATE_COS: the first step's loss and first and last layer's
# update, here against the float32 (1, 1) run). Phase 9 (c) runs a
# planted fault under each bf16 gate set (a per-replica InfoNCE; a
# cross-encoder loss over the first data row only) and fails unless the
# gates reject it.
MESH_LOSS_RTOL, MESH_PARAM_ATOL = 1e-5, 2e-5
MESH_GRAD_RTOL, MESH_GRAD_ATOL = 1e-4, 1e-6
MESH_BF16_LOSS_ATOL = 1e-2
MESH_BF16_MIN_UPDATE_COS = (0.99, 0.9)
SEQ = 128  # the samplers' max_seq_len at this width


def step_profile(step, state, batch):
    """One training step under torch.profiler (device activity only):
    its kernels, copies and memsets, and their summed device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, met = step(state, batch)
        torch.cuda.synchronize()
    counts = {"kernels": 0, "copies": 0, "memsets": 0, "device_ms": 0.0}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        kind = ("copies" if e.name.startswith("Memcpy") else
                "memsets" if e.name.startswith("Memset") else "kernels")
        counts[kind] += 1
        counts["device_ms"] += e.time_range.elapsed_us() / 1e3
    return state, met, counts


def random_train_batch(rng, b=TRAIN_BATCH, hard=TRAIN_HARD, s=SEQ, vocab=30522):
    """A contrastive batch of phase 9 (a)'s shape from a seed: b queries,
    b documents and b * hard negatives of s tokens, random lengths."""
    out = {}
    for side, rows in (("q", b), ("d", b), ("n", b * hard)):
        mask = (np.arange(s)[None, :] < rng.integers(8, s + 1, (rows, 1))).astype(np.int32)
        ids = rng.integers(1000, vocab, (rows, s)).astype(np.int32) * mask
        ids[:, 0] = CLS_ID
        out[f"{side}_ids"], out[f"{side}_mask"] = ids, mask
    return out


def mesh_embedder_run(cfg, init, batches, mesh, label, timed=True):
    """MESH_STEPS steps on `mesh` from `init` over `batches` (the first
    step's gradients and the params after them kept on the host), then
    (if `timed`) MESH_TIMED more timed with CUDA events and one profiled:
    (params, numbers, grads, params after the first step)."""
    import torch

    from radiant_rag_tpu_torch.parallel.train import contrastive_train_step, make_train_state

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    state = make_train_state(cfg, mesh, TRAIN_LR, init_params_tree=init)
    step, place = contrastive_train_step(mesh)
    losses, spans = [], []

    def one(batch):
        nonlocal state
        placed = place(batch)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, met = step(state, placed)
        e1.record()
        spans.append((e0, e1))
        return met["loss"]

    grads = params1 = None
    for batch in batches:
        losses.append(one(batch))
        if grads is None:  # the first step's, before the next zeroes them
            grads = {n: g.float().cpu().clone() for n, g in state.grads.items()}
            params1 = {k: v.detach().float().cpu().clone() for k, v in state.params.items()}
    params = {k: v.detach().float().cpu().clone() for k, v in state.params.items()}
    if not timed:
        numbers = {"mesh": list(mesh.shape), "dtype": str(cfg.dtype).rsplit(".", 1)[-1],
                   "losses": [float(x) for x in losses]}
        log(f"phase 9 {label}: {json.dumps(numbers)}")
        del state, step, place
        torch.cuda.empty_cache()
        return params, numbers, grads, params1
    devices = sorted({d.index for d in mesh.shards if d.type == "cuda"})

    def sync_all():  # every card of the mesh (events time the first one)
        for i in devices:
            torch.cuda.synchronize(i)

    sync_all()
    t = time.perf_counter()
    for i in range(MESH_TIMED):
        one(batches[i % len(batches)])
    sync_all()
    wall_ms = (time.perf_counter() - t) / MESH_TIMED * 1e3
    state, _, counts = step_profile(step, state, place(batches[0]))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in spans]
    numbers = {"mesh": list(mesh.shape), "devices": [str(d) for d in mesh.shards],
               "dtype": str(cfg.dtype).rsplit(".", 1)[-1],
               "losses": [float(x) for x in losses], "step_ms": step_ms,
               "step_ms_p50": _pct(step_ms[MESH_STEPS:], 0.5),
               "wall_ms_per_step": wall_ms, "launches_per_step": counts,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "resident_gib": resident / 2**30}
    log(f"phase 9 {label}: {json.dumps(numbers)}")
    del state, step, place
    torch.cuda.empty_cache()
    return params, numbers, grads, params1


def _layer_of(name: str):
    m = re.search(r"(?:^|\.)layer_(\d+)\.", name)
    return int(m.group(1)) if m else None


def _update_cos(a, b, init, names) -> float:
    """Cosine of two runs' updates (p - init) over the named tensors."""
    u = np.concatenate([(a[n] - init[n]).numpy().ravel() for n in names]).astype(np.float64)
    v = np.concatenate([(b[n] - init[n]).numpy().ravel() for n in names]).astype(np.float64)
    return float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v)))


def compare_mesh_runs(ref, got, init, steps, lr, what, f32=None):
    """A mesh run against the (1, 1) run from the same init and batches, to
    the tolerance for its dtype (MESH_* above; the gradients where both
    runs kept them; `f32`, the float32 (1, 1) run, for a bf16 run with a
    model axis). Returns the gaps, with "failed": the gates they miss."""
    (ref_p, ref_n, ref_g, _), (got_p, got_n, got_g, got_p1) = ref, got
    rl, gl = np.asarray(ref_n["losses"]), np.asarray(got_n["losses"])
    loss_gap = float(np.max(np.abs(gl - rl)))
    if ref_n["dtype"] == "float32":
        # the leaves whose exact gradient is 0: the attention key biases, and
        # the classifier's bias under the listwise loss
        key_bias = [n for n in ref_p if n.endswith("attention.key.bias") or n == "classifier.bias"]
        diff = {n: (got_p[n] - ref_p[n]).abs() for n in ref_p}
        gap, worst = max((float(diff[n].max()), n) for n in ref_p if n not in key_bias)
        kb_gap = max(float(diff[n].max()) for n in key_bias)
        past = sum(int((diff[n] > MESH_PARAM_ATOL).sum()) for n in ref_p if n not in key_bias)
        out = {"loss_gap": loss_gap, "param_gap": gap, "worst_param": worst,
               "key_bias_gap": kb_gap, "elements_past_2e-5": past,
               "elements": sum(t.numel() for t in ref_p.values())}
        gates = {f"losses within rtol {MESH_LOSS_RTOL}": bool(
                     np.allclose(gl, rl, rtol=MESH_LOSS_RTOL, atol=0)),
                 f"params within {steps * lr}": gap <= steps * lr and kb_gap <= steps * lr}
        if ref_g is not None and got_g is not None:
            over = {n: float(((got_g[n] - ref_g[n]).abs() - MESH_GRAD_RTOL * ref_g[n].abs())
                             .max()) for n in ref_g}
            out["grad_excess_over_rtol"], out["grad_worst"] = max(
                (v, n) for n, v in over.items())
            gates[f"first-step gradients within rtol {MESH_GRAD_RTOL} atol {MESH_GRAD_ATOL}"] = (
                out["grad_excess_over_rtol"] <= MESH_GRAD_ATOL)
        out["failed"] = [g for g, ok in gates.items() if not ok]
        log(f"phase 9 {what} float32 against (1, 1): {json.dumps(out)} (gates: "
            f"{list(gates)}; the count past {MESH_PARAM_ATOL} reported)")
        return out
    layers = sorted({_layer_of(n) for n in ref_p} - {None})
    names = {layer: [n for n in ref_p if _layer_of(n) == layer
                     and not n.endswith("attention.key.bias")] for layer in layers}
    cos = {layer: _update_cos(got_p, ref_p, init, names[layer]) for layer in layers}
    ends = (layers[0], layers[-1])
    out = {"loss_gap": loss_gap, "min_update_cos": min(cos.values()),
           "update_cos": [cos[layer] for layer in layers]}
    gates = {f"each step's loss within {MESH_BF16_LOSS_ATOL} of the bf16 (1, 1) run's":
                 loss_gap <= MESH_BF16_LOSS_ATOL,
             f"first / last layer's update cosine to the bf16 (1, 1) run's >= "
             f"{MESH_BF16_MIN_UPDATE_COS}": all(cos[layer] >= t for layer, t in
                                                zip(ends, MESH_BF16_MIN_UPDATE_COS))}
    if f32 is not None:
        f32_p1, f32_loss = f32[3], f32[1]["losses"][0]
        out["first_step_loss_gap_to_float32"] = abs(got_n["losses"][0] - f32_loss)
        out["first_step_update_cos_to_float32"] = [
            _update_cos(got_p1, f32_p1, init, names[layer]) for layer in ends]
        gates[f"first step's loss within {TRAIN_LOSS_ATOL} of the float32 (1, 1) run's"] = (
            out["first_step_loss_gap_to_float32"] <= TRAIN_LOSS_ATOL)
        gates[f"first step's first / last layer's update cosine to the float32 (1, 1) run's >= "
              f"{TRAIN_MIN_UPDATE_COS}"] = all(
            c >= t for c, t in zip(out["first_step_update_cos_to_float32"], TRAIN_MIN_UPDATE_COS))
    out["failed"] = [g for g, ok in gates.items() if not ok]
    log(f"phase 9 {what} bfloat16 after {steps} steps: {json.dumps(out)} (gates: {list(gates)})")
    return out


class Planted:
    """Inside the block `module.name` is `fn(original)`: a deliberately wrong
    program, run to show that the gates reject it."""

    def __init__(self, module, name, make):
        self.module, self.name, self.make = module, name, make

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.make(self.orig))

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def per_replica_info_nce(orig):
    """The planted fault of the InfoNCE: a loss per data row over its own
    block (half the negatives on two rows), averaged over the rows, as a
    DDP-style replica loss would be. On logical shards of one card every
    row's parameters are row 0's, so each row runs as a one-row batch."""
    def loss(state, rows, temperature=0.05):
        outs = [orig(state, [r], temperature) for r in rows]
        mean = sum(x for x, _ in outs) / len(outs)
        return mean, {"loss": mean, "accuracy": sum(m["accuracy"] for _, m in outs) / len(outs)}
    return loss


def first_row_ce_logits(orig):
    """The planted fault of the cross-encoder: the loss over the first data
    row's groups only (half the batch on two rows)."""
    return lambda state, rows: orig(state, rows[:1])


def mesh_embedder_checks(cfg, init, batches, meshes, card, label, plant=False):
    """Each mesh's float32 and bfloat16 runs against the (1, 1) run on
    `card`; with `plant` (logical shards of one card), also a bf16 run of
    each mesh with a model axis under a per-replica InfoNCE, which the
    gates must reject. Returns the numbers."""
    import torch

    from radiant_rag_tpu_torch.parallel import train as tt
    from radiant_rag_tpu_torch.parallel.mesh import create_mesh

    init_t = {k: v.float() for k, v in init.items()}
    out, f32 = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        name = str(dtype).rsplit(".", 1)[-1]
        ref = mesh_embedder_run(c, init, batches, create_mesh(devices=[card]),
                                f"{label} {name} (1, 1)")
        out[name] = {"(1, 1)": ref[1]}
        if dtype == torch.float32:
            f32 = ref
        else:  # the single-device bf16 step against float32: the band
            layers = sorted({_layer_of(n) for n in init_t} - {None})
            ends = [[n for n in init_t if _layer_of(n) == layer
                     and not n.endswith("attention.key.bias")] for layer in (layers[0],
                                                                             layers[-1])]
            out[name]["(1, 1)"]["first_step_update_cos_to_float32"] = [
                _update_cos(ref[3], f32[3], init_t, n) for n in ends]
            out[name]["(1, 1)"]["first_step_loss_gap_to_float32"] = abs(
                ref[1]["losses"][0] - f32[1]["losses"][0])
        for shape, mesh in meshes:
            got = mesh_embedder_run(c, init, batches, mesh, f"{label} {name} {shape}")
            split = mesh.shape[1] > 1
            gaps = compare_mesh_runs(ref, got, init_t, len(batches), TRAIN_LR,
                                     f"{label} {shape}",
                                     f32=f32 if dtype == torch.bfloat16 and split else None)
            check(not gaps["failed"], f"{label} {shape} {name}: {gaps}")
            out[name][str(shape)] = {**got[1], **gaps}
            if plant and dtype == torch.bfloat16 and split:
                with Planted(tt, "info_nce_loss", per_replica_info_nce):
                    bad = mesh_embedder_run(c, init, batches, mesh,
                                            f"{label} {name} {shape} planted", timed=False)
                pg = compare_mesh_runs(ref, bad, init_t, len(batches), TRAIN_LR,
                                       f"{label} {shape} planted per-replica InfoNCE", f32=f32)
                check(pg["failed"], f"the bf16 gates passed a per-replica InfoNCE: {pg}")
                out[name][f"{shape} planted per-replica InfoNCE"] = pg
    return out


def phase_training_mesh(ck, main_path, app, sampler, texts, smi, card):
    """Phase 9 (c): the dp x tp layout on logical shards of the card. A
    (2, 2) mesh of cuda:0 against the (1, 1) mesh at MiniLM-L12 width, from
    one seeded init over MESH_STEPS host batches that (a)'s sampler draws
    (batch 256, 2 hard negatives mined by the sketch scan: 1,024
    sequences), in float32 and bfloat16; then `train_cross_encoder` on a
    (2, 1) mesh against (1, 1). Step ms, device work, launches and peak
    memory of each. Returns the shapes its mining launched and the
    numbers."""
    import torch

    from radiant_rag_tpu_torch.models.bert import init_module, init_params
    from radiant_rag_tpu_torch.models.cross_encoder import CrossEncoderModel
    from radiant_rag_tpu_torch.parallel import data as tdata
    from radiant_rag_tpu_torch.parallel import train as tt
    from radiant_rag_tpu_torch.parallel.mesh import create_mesh

    card = torch.device(card)
    if card.type == "cuda" and card.index is None:
        card = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(app.local_models.embedder.bert_cfg, dtype=torch.float32)
    init = init_params(cfg, seed=SEED)
    check(sampler.batch_size == TRAIN_BATCH and sampler.n_hard == TRAIN_HARD,
          (sampler.batch_size, sampler.n_hard))
    batches, d_mine, t_mine = main_path(lambda: [sampler.next_batch()
                                                 for _ in range(MESH_STEPS)])
    launched = set(ck.launches_by_shape)
    check(d_mine["int8_scan_topk"] > 0, f"(c)'s mining launched no sketch scan: {d_mine}")
    log(f"phase 9 (c): {MESH_STEPS} batches of {batches[0]['q_ids'].shape[0]} queries, "
        f"{sum(v.shape[0] for k, v in batches[0].items() if k.endswith('ids'))} sequences of "
        f"{batches[0]['q_ids'].shape[1]} tokens, mined in {t_mine:.1f} s; launches {d_mine}")
    meshes = [(shape, create_mesh(data=shape[0], model=shape[1],
                                  devices=[card] * (shape[0] * shape[1])))
              for shape in MESH_SHAPES if shape != (1, 1)]
    out = {"embedder": mesh_embedder_checks(cfg, init, batches, meshes, card, "(c)",
                                            plant=True)}

    # the cross-encoder: train_cross_encoder on a (2, 1) mesh against (1, 1);
    # in bf16 also under a loss over the first data row only, which the
    # gates must reject
    ce_cfg = dataclasses.replace(app.local_models.cross_encoder.bert_cfg, dtype=torch.float32)
    ce_init = {k: v.float() for k, v in init_module(CrossEncoderModel(ce_cfg), SEED)
               .state_dict().items()}

    def ce_run(shape, dtype):
        mesh = create_mesh(data=shape[0], model=shape[1], devices=[card] * (shape[0] * shape[1]))
        (metrics, params), d_ce, t_ce = main_path(lambda: tdata.train_cross_encoder(
            texts, bert_cfg=dataclasses.replace(ce_cfg, dtype=dtype), mesh=mesh,
            steps=MESH_STEPS, batch_size=CE_BATCH, learning_rate=5e-5, max_seq_len=128,
            log_every=1, seed=SEED, bm25=app.bm25_index.index, rows=range(N_DOCS),
            hard_negatives=2, random_negatives=1, device_lock=app.device_lock,
            return_params=True))
        launched.update(ck.launches_by_shape)
        check(d_ce["int8_scan_topk"] > 0, f"(c) CE mining launched no sketch scan: {d_ce}")
        return ({k: v.detach().float().cpu().clone() for k, v in params.items()},
                {"dtype": str(dtype).rsplit(".", 1)[-1], "losses": [metrics["loss"]], "s": t_ce,
                 "metrics": metrics}, None, None)

    out["cross_encoder"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).rsplit(".", 1)[-1]
        runs = {shape: ce_run(shape, dtype) for shape in CE_MESH_SHAPES}
        gaps = compare_mesh_runs(runs[(1, 1)], runs[(2, 1)], ce_init, MESH_STEPS, 5e-5,
                                 "(c) train_cross_encoder (2, 1)")
        check(not gaps["failed"], f"(c) train_cross_encoder (2, 1) {name}: {gaps}")
        out["cross_encoder"][name] = {str(s): r[1] for s, r in runs.items()} | {"gaps": gaps}
        if dtype == torch.bfloat16:
            with Planted(tt, "ce_logits", first_row_ce_logits):
                bad = ce_run((2, 1), dtype)
            pg = compare_mesh_runs(runs[(1, 1)], bad, ce_init, MESH_STEPS, 5e-5,
                                   "(c) train_cross_encoder (2, 1) planted first-row loss")
            check(pg["failed"], f"the bf16 gates passed a first-row cross-encoder loss: {pg}")
            out["cross_encoder"][name]["planted first-row loss"] = pg
    log("phase 9 (c) summary: " + json.dumps({"device": smi, **out}))
    return launched, out, batches


def phase_training_cards(batches, cfg, smi):
    """Phase 9 (d): the same step on a real mesh of the visible cards (every
    card on 'data', then half of them on 'model' where there are 4 or more)
    against (1, 1) on cuda:0, and a two-rank NCCL `merge_across_processes`.
    Runs only with more than one visible card; otherwise says so and
    returns None (not a pass)."""
    import torch

    from radiant_rag_tpu_torch.models.bert import init_params
    from radiant_rag_tpu_torch.parallel.mesh import create_mesh

    n = torch.cuda.device_count()
    if n < 2:
        log(f"phase 9 (d): not run: {n} visible card (a real mesh and a two-rank NCCL group "
            "need more than one); not a pass")
        return None
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    init = init_params(cfg, seed=SEED)
    meshes = [((n, 1), create_mesh())]
    if n >= 4 and n % 2 == 0:
        meshes.append(((n // 2, 2), create_mesh(model=2)))
    out = {"cards": n, "device": smi,
           "embedder": mesh_embedder_checks(cfg, init, batches, meshes,
                                            torch.device("cuda", 0), "(d)")}
    out["nccl_merge"] = nccl_merge_two_ranks()
    log("phase 9 (d) summary: " + json.dumps(out))
    return out


NCCL_DOCS, NCCL_DIM, NCCL_K, NCCL_B = 1 << 20, 384, 16, 256


def nccl_merge_two_ranks():
    """Two processes, one card each, join an NCCL group over tcp on
    localhost; each searches its half of a seeded corpus and
    `merge_across_processes` merges the top-k (`nccl_merge_worker`).
    Returns the workers' reports."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, NCCL_SOCKET_IFNAME=os.environ.get("NCCL_SOCKET_IFNAME", "lo"))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--nccl-merge",
                               f"127.0.0.1:{port}", "2", str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for rank in range(2)]
    reports = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            ok = [line for line in out.splitlines() if line.startswith("NCCL_OK ")]
            check(p.returncode == 0 and ok, f"an NCCL rank failed ({p.returncode}): {err[-2000:]}")
            reports.append(json.loads(ok[0][len("NCCL_OK "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"phase 9 (d) two-rank NCCL merge: {json.dumps(reports)}")
    return reports


def nccl_merge_worker(coordinator: str, world: int, rank: int) -> int:
    """One rank of `nccl_merge_two_ranks`: its half of the corpus searched
    exactly on its card, the global rows merged across the ranks, held
    against a full-corpus oracle on its card."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from radiant_rag_tpu_torch.parallel.multihost import (
        host_shard_bounds, initialize_multihost, merge_across_processes,
    )

    check(initialize_multihost(coordinator, world, rank), "the NCCL group has one rank")
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(SEED)
    full = torch.nn.functional.normalize(
        torch.randn(NCCL_DOCS, NCCL_DIM, device=dev, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(NCCL_B, NCCL_DIM, device=dev, generator=g),
                                      dim=1)
    lo, hi = host_shard_bounds(NCCL_DOCS)
    s, i = torch.topk(q @ full[lo:hi].T, NCCL_K, dim=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ms, mi = merge_across_processes(s, i + lo, NCCL_K)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t) * 1e3
    # the oracle: both halves' products (each as its rank computes it), one top-k
    halves = [host_shard_bounds(NCCL_DOCS, r, world) for r in range(world)]
    os_, oi = torch.topk(torch.cat([q @ full[a:b].T for a, b in halves], dim=1), NCCL_K, dim=1)
    check(torch.equal(mi, oi) and torch.equal(ms, os_), "the merged top-k is not the oracle's")
    print("NCCL_OK " + json.dumps({"rank": rank, "device": str(dev), "bounds": [lo, hi],
                                   "backend": dist.get_backend(), "merge_ms": merge_ms}),
          flush=True)
    dist.destroy_process_group()
    return 0


def step_launch_probe(root: str) -> int:
    """The (1, 1) training step of the package under `root` (this checkout,
    or an older one) at phase 9 (a)'s shape, MiniLM-L12 width in bf16 on
    cuda:0, random batches from SEED: the kernels, copies and memsets of
    one step (torch.profiler) and the step ms p50 of 8 (CUDA events).
    Prints one JSON line; the same numbers from two checkouts compare
    their steps."""
    import inspect

    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    from radiant_rag_tpu_torch.models.bert import BertConfig, init_params
    from radiant_rag_tpu_torch.parallel import train as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BertConfig()  # MiniLM-L12 width, bf16 compute
    init = init_params(cfg, seed=SEED)
    if "mesh" in inspect.signature(tt.make_train_state).parameters:
        from radiant_rag_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(devices=["cuda:0"])
        state = tt.make_train_state(cfg, mesh, TRAIN_LR, init_params_tree=init)
        step, place = tt.contrastive_train_step(mesh)
    else:  # the single-device signature of the port before the mesh
        state = tt.make_train_state(cfg, TRAIN_LR, init_params_tree=init, device="cuda:0")
        step, place = tt.contrastive_train_step("cuda:0")
    rng = np.random.default_rng(SEED)
    batches = [place(random_train_batch(rng)) for _ in range(4)]
    spans = []
    for i in range(12):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, met = step(state, batches[i % 4])
        e1.record()
        spans.append((e0, e1))
    state, met, counts = step_profile(step, state, batches[0])
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in spans[4:]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": str(root), "package": str(Path(tt.__file__).parent.parent),
                      "device": smi, "launches_per_step": counts,
                      "step_ms_p50": _pct(step_ms, 0.5), "step_ms": step_ms,
                      "loss": float(met["loss"])}), flush=True)
    return 0


def cards_only() -> int:
    """Phase 9 (d) alone, over random batches of (a)'s shape (no corpus,
    no mining): for a machine with more than one card."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from radiant_rag_tpu_torch.models.bert import BertConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(smi)
    rng = np.random.default_rng(SEED)
    batches = [random_train_batch(rng) for _ in range(MESH_STEPS)]
    out = phase_training_cards(batches, BertConfig(), smi)
    return 0 if out is not None else 1



# phase 10: the corpus-sharded pod store (index.backend: sharded) with the
# spill docstore, over phase 7's corpus
POD_BUCKETS = (1, 8, 64, 256, 2048)  # search_batch on one shard at each query bucket
POD_LOGICAL_SHARDS = 4  # the merge check: 4 logical shards on one card
POD_CHECK_B = 256  # the 4-shard, delta, tombstone and rebase checks' batch
POD_DELETES = 32  # base rows tombstoned
POD_AGENTIC_RUNS = 16
POD_CLIENTS = 256
POD_REQUESTS = 4  # /search requests per client


class PlainKernels:
    """Inside the block every kernel wrapper is its plain PyTorch version,
    on the same (card) tensors: the search runs again without a kernel
    (and counts no launch)."""

    NAMES = ("int8_scan_topk", "blockmax2", "hamming_scan_topk", "hamming_scores",
             "hamming_scores_t", "int8_scores")

    def __init__(self, ck):
        self.ck = ck
        self.saved = {}

    def __enter__(self):
        for n in self.NAMES:
            self.saved[n] = getattr(self.ck, n)
            setattr(self.ck, n, getattr(self.ck, n + "_reference"))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ck, n, fn)


class SpillCounter:
    """Counts a spill docstore's get() calls and the content reads behind
    them (the LRU's misses), for the hit share."""

    def __init__(self, spill):
        self.spill, self.gets, self.reads = spill, 0, 0
        get0, read0 = spill.get, spill._read_record

        def get(doc_id):
            self.gets += 1
            return get0(doc_id)

        def read(*a):
            self.reads += 1
            return read0(*a)

        spill.get, spill._read_record = get, read

    def remove(self):
        del self.spill.get, self.spill._read_record

    def hit_share(self) -> float:
        return 1.0 - self.reads / max(self.gets, 1)


def vm_rss() -> int:
    """This process's resident host memory, bytes (/proc/self/status)."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def doc_bytes(docstore, sample: int = 4096) -> float:
    """Host bytes per doc of a docstore's Python objects, from a sample of
    its docs (sys.getsizeof of the content, meta and map entries): an
    estimate, not a measurement of the process."""
    ids = list(docstore.id_to_row)[:: max(1, len(docstore.id_to_row) // sample)][:sample]
    total = 0
    for doc_id in ids:
        total += sys.getsizeof(doc_id) + 2 * 8 + 2 * 28  # id, map slots, two ints
        if hasattr(docstore, "_loc"):
            total += sys.getsizeof(docstore._loc[doc_id]) + 3 * 28
        else:
            doc = docstore.docs[doc_id]
            total += (sys.getsizeof(doc) + sys.getsizeof(doc.content) + sys.getsizeof(doc.meta)
                      + sum(sys.getsizeof(k) + sys.getsizeof(v) for k, v in doc.meta.items()))
    return total / max(len(ids), 1)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def legs_equal(a, b, what):
    """Two row-space results ({'dense'|'bm25'|'fused': (scores, rows)}),
    exactly equal."""
    for leg in ("dense", "bm25", "fused"):
        check(np.array_equal(a[leg][1], b[leg][1]) and np.array_equal(a[leg][0], b[leg][0]),
              f"{what}: {leg} differs")


def rows_close(got, want, what, rtol=1e-5, atol=1e-6):
    """(scores, rows) equal up to fp32 summation order: scores within the
    tolerance of tests/_torch_parity.py, a row out of place only as a swap
    of two rows tied within it."""
    (gs, gr), (ws, wr) = got, want
    check(np.allclose(gs, ws, rtol=rtol, atol=atol), f"{what}: scores differ")
    for q, slot in zip(*np.nonzero(gr != wr)):
        other = np.nonzero(wr[q] == gr[q, slot])[0]
        check(len(other) == 1 and gr[q, other[0]] == wr[q, slot]
              and abs(ws[q, slot] - ws[q, other[0]]) <= atol + rtol * abs(ws[q, slot]),
              f"{what}: rows differ at query {q}")


def merge_oracle(base, delta, k, tombstones):
    """Host oracle of a leg's base + delta merge: the live pairs of both
    runs, tombstoned base rows dropped, by score descending (ties in run
    order), the first k."""
    bs, bi = base
    out_s = np.full((bi.shape[0], k), -np.inf, np.float32)
    out_i = np.full((bi.shape[0], k), -1, np.int64)
    for q in range(bi.shape[0]):
        pairs = [(float(s), int(r)) for s, r in zip(bs[q], bi[q])
                 if r >= 0 and int(r) not in tombstones]
        if delta is not None:
            pairs += [(float(s), int(r)) for s, r in zip(delta[0][q], delta[1][q]) if r >= 0]
        pairs = sorted(pairs, key=lambda p: -p[0])[:k]  # stable: run order among ties
        for j, (s, r) in enumerate(pairs):
            out_s[q, j], out_i[q, j] = s, r
    return out_s, out_i


def pod_kernel_rows(ck, idx, shards, keys, qvecs, qtexts_, bm):
    """Kernel rows at the pod's own shapes: for each (kernel, W or S, k, B,
    "pod", shards) key a main path launched, the kernel over shard 0's
    block of `idx` (N = rows_per_shard): the sign words against the batch's
    packed query vectors, or the sketch against its query indicators."""
    import torch

    from radiant_rag_tpu_torch.ops import quantize as qz

    dev = idx.shards[0]
    qwords = qz.pack_binary(torch.from_numpy(qvecs / np.linalg.norm(qvecs, axis=1,
                                                                    keepdims=True)).to(dev))
    qind = torch.from_numpy(bm.make_query_indicator(qtexts_, bm.query_tids(qtexts_))).to(dev)
    codes, sketch, mask = idx.codes[0], idx.sketch[0], idx.valid[0].clone()
    csign = None
    rows = []
    for key in sorted(keys):
        name, width, k, b = key[:4]
        label = f"pod {shards} shard(s) N={idx.rows_per_shard} k={k} B={b}"
        if name == "hamming_scan_topk" and width == codes.shape[1]:
            csign = ck.sign_matrix(codes) if csign is None else csign
            rows.append(hamming_scan_row(ck, f"W={width} {label}", codes,
                                         qwords[:b].contiguous(), mask, k, csign))
        elif name == "int8_scan_topk" and width == sketch.shape[1]:
            rows.append(scan_rows(ck, f"sketch S={width} {label}", sketch,
                                  qind[:b].contiguous(), mask, k))
        else:
            raise AssertionError(f"the pod launched {name} at {key}, which no row covers")
        rows[-1]["_key"] = key  # the pod's tagged key
    return rows


def phase_pod(ck, main_path, app7, vecs, texts, smi, d, known_keys, card=None):
    """Phase 10: the corpus-sharded pod store at MiniLM-L12 width over
    phase 7's corpus (1,016,384 rows): `create_vector_store` with
    `index.backend: sharded` and `index.docstore: spill` (a mesh of every
    visible card: one shard here), its source filled from phase 7's store
    by the load path (`DeviceVectorIndex.from_host`, and `load_docstore`'s
    migration loop into the spill log), then `RadiantTPU` over it. Checks
    (1) one shard at 5 query buckets against the plain kernels, and the
    dense leg's recall; (2) 4 logical shards; (3) the delta segment,
    tombstones and a rebase; (4) 16 agentic runs; (5) /search under 256
    clients; (6) a one-rank NCCL group's merge; (7) the spill docstore's
    numbers. Returns the pod's kernel rows and the rows of other shapes it
    launched that `known_keys` lacks."""
    import http.client
    import os
    import threading

    import torch
    import torch.distributed as dist

    from radiant_rag_tpu_torch.agents.base_agent import DeviceStageError
    from radiant_rag_tpu_torch.app import RadiantTPU
    from radiant_rag_tpu_torch.config import config_from_dict
    from radiant_rag_tpu_torch.index.docstore import SpillDocStore
    from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
    from radiant_rag_tpu_torch.index.factory import create_vector_store
    from radiant_rag_tpu_torch.index.hybrid import resolve_fused_depth
    from radiant_rag_tpu_torch.ingestion.processor import IngestedChunk
    from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
    from radiant_rag_tpu_torch.llm.client import LLMClient
    from radiant_rag_tpu_torch.ops import quantize as qz
    from radiant_rag_tpu_torch.parallel import multihost
    from radiant_rag_tpu_torch.parallel.mesh import create_mesh, mesh_info
    from radiant_rag_tpu_torch.parallel.sharded_index import ShardedHybridIndex, merge_topk
    from radiant_rag_tpu_torch.parallel.sharded_store import ShardedVectorStore, _host_fuse
    from radiant_rag_tpu_torch.server import hit_dicts, make_server

    card = torch.device("cuda", 0) if card is None else torch.device(card)
    store7, models = app7.store, app7.local_models
    pod_dir = d / "pod"
    cfg = config_from_dict({
        "embedding": {**MINILM_PRESET["embedding"], "checkpoint_dir": str(d / "embedder_ckpt")},
        "index": {"backend": "sharded", "docstore": "spill", "data_dir": str(pod_dir / "index"),
                  "auto_persist": False},
        "bm25": {"index_path": str(pod_dir / "bm25.json.gz")},
        "strategy_memory": {"path": str(pod_dir / "strategy_memory.json.gz")},
        "conversation": {"data_dir": str(pod_dir / "conversations")}})
    r, q = cfg.retrieval, cfg.quantization
    fd = resolve_fused_depth(r)
    check((fd, round(fd * q.rescore_multiplier), cfg.index.docstore_cache_docs)
          == (60, SERVE_KC, 50_000), "phase 10 config")
    timings, numbers, keys_by_tag, other_keys = {}, {}, {}, set()
    plain = PlainKernels(ck)

    def tagged(fn, shards):
        out, delta, dt = main_path(fn, tag=("pod", shards))
        keys_by_tag.setdefault(shards, set()).update(
            k + ("pod", shards) for k in ck.launches_by_shape)
        return out, delta, dt

    def untagged(fn):
        out, delta, dt = main_path(fn)
        other_keys.update(ck.launches_by_shape)
        return out, delta, dt

    # -- the pod app over phase 7's corpus ---------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pod = create_vector_store(cfg, device=card)
    check(isinstance(pod, ShardedVectorStore)
          and mesh_info(pod.mesh) == {"data": torch.cuda.device_count() if card.type == "cuda"
                                      else 1, "model": 1}, f"phase 10 mesh {pod.mesh}")
    src = pod.source
    spill = src.docstore
    check(isinstance(spill, SpillDocStore) and len(spill) == 0, "phase 10 spill docstore")
    state = store7.engine.to_host()
    src.engine = DeviceVectorIndex.from_host(state, initial_capacity=store7.engine.capacity,
                                             stage1_select=src.index_config.stage1_select,
                                             device=card)
    src.lang_codes = dict(store7.lang_codes)
    torch.cuda.synchronize()
    timings["engine_from_host_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    rss0 = vm_rss()
    for doc in store7.docstore:  # load_docstore's migration loop
        spill.put(doc, row=store7.docstore.id_to_row.get(doc.doc_id))
    spill.save()
    timings["spill_migration_s"] = time.perf_counter() - t1
    numbers["spill_rss_growth_migration_bytes"] = vm_rss() - rss0
    n_docs = store7.count_documents()
    check(len(spill) == n_docs and src.count_documents() == n_docs, "migration count")
    questions = list(dict.fromkeys(" ".join(texts[i].split()[:QUESTION_WORDS])
                                   for i in np.random.default_rng(SEED + 20).integers(
                                       0, N_DOCS, 4 * POD_AGENTIC_RUNS)))[:POD_AGENTIC_RUNS]
    llm = LLMClient(cfg.llm, backend=MockLLMBackend(responder=ScriptedLLM(questions)))
    t1 = time.perf_counter()
    app = RadiantTPU(cfg, llm=llm, store=pod, local_models=models, device=card)
    torch.cuda.synchronize()
    timings["app_bm25_build_and_shard_s"] = time.perf_counter() - t1
    timings["build_s"] = time.perf_counter() - t0
    bm = app.bm25_index.index
    base = pod._hybrid
    check(base is not None and pod._base_rows == src.engine.count == state["vecs"].shape[0]
          and bm.num_docs == src.engine.count, "phase 10 base")
    per = base.rows_per_shard
    log(f"phase 10 build: {timings['build_s']:.1f} s (engine from host "
        f"{timings['engine_from_host_s']:.1f} s; spill migration of {n_docs} docs "
        f"{timings['spill_migration_s']:.1f} s; RadiantTPU with the BM25 index built from the "
        f"spill store and the base sharded {timings['app_bm25_build_and_shard_s']:.1f} s); "
        f"mesh {mesh_info(pod.mesh)}, {pod._base_rows} rows, rows_per_shard {per}, sketch "
        f"S={base.sketch_dim}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counter = SpillCounter(spill)

    # the first search's calibration over the source engine, carried to the pod
    orch = app.orchestrator
    _, d_cal, t_cal = untagged(lambda: orch.calibrate_pod_fusion())
    hy = orch._hybrid
    check(hy is not None and not orch._hybrid_serves and hy.engine is src.engine
          and hy.last_calibration is not None and "skipped" not in hy.last_calibration,
          f"phase 10 calibration: {hy.last_calibration}")
    check(pod._fusion_mode == hy.fusion_mode == base.fusion_mode
          and np.array_equal(pod._fusion_weights, hy.leg_weights), "set_fusion did not reach the pod")
    log(f"phase 10 calibration over the source engine: {t_cal:.1f} s, mode {hy.fusion_mode}, "
        f"weights {hy.leg_weights.tolist()}; launches {d_cal}")

    # -- (1) one shard, through app.search_batch at each bucket ----------------
    qrng = np.random.default_rng(SEED + 21)
    pool = list(dict.fromkeys(" ".join(texts[i].split()[:6])
                              for i in qrng.integers(0, N_DOCS, 12_000)))
    kw = dict(top_k=TOP_K, fused_k=TOP_K, rrf_k=r.rrf_k, fused_depth=fd)
    bucket_ms = {}
    off = 0
    for b in POD_BUCKETS:
        qs = pool[off:off + b]
        off += b
        hits, dl, dt = tagged(lambda qs=qs: app.search_batch(qs, use_cache=False), 1)
        check(dl["hamming_scan_topk"] == 1 and dl["int8_scan_topk"] == 1,
              f"launches at B={b}: {dl}")
        bucket_ms[b] = dt * 1e3
        embs = models.embed(qs)
        got = pod.search_hybrid_rows(embs, qs, **kw)
        with plain:
            want = pod.search_hybrid_rows(embs, qs, **kw)
        legs_equal(got, want, f"phase 10 one shard B={b} (kernels vs plain)")
        check([_docs(h) for h in hits] == [_docs(h) for h in pod._hydrate(*got["fused"])],
              f"phase 10 B={b}: search_batch hits differ from the pod's fused rows")
        check(all(hits) and (got["dense"][1][:, 0] >= 0).all(), f"B={b}: empty results")
    numbers["ms_per_batch"] = bucket_ms
    top = POD_BUCKETS[-1]
    numbers["qps_top_bucket"] = top / (bucket_ms[top] / 1e3)
    log(f"phase 10 one shard, app.search_batch (hybrid, top_k {TOP_K}, fused depth {fd}: "
        f"kc {SERVE_KC} on both legs) ms per batch: {json.dumps(bucket_ms)}; "
        f"{numbers['qps_top_bucket']:.1f} QPS at {top}; every leg equals the plain kernels' "
        "search")

    qs = pool[off:off + POD_CHECK_B]
    off += POD_CHECK_B
    embs = models.embed(qs)

    def split_ms(fn, n=3):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return float(np.median(out))

    res = pod.search_hybrid_rows(embs, qs, **kw)
    split = {"embed": split_ms(lambda: models.embed(qs)),
             "base_search": split_ms(lambda: base.hybrid_search(
                 embs, qs, dense_k=fd, bm25_k=fd, fused_k=TOP_K, rrf_k=r.rrf_k)),
             "search_hybrid_rows": split_ms(lambda: pod.search_hybrid_rows(embs, qs, **kw)),
             "hydrate": split_ms(lambda: pod._hydrate(*res["fused"]))}
    numbers["split_ms_b256_pure_base"] = split
    idle = profile_batch(lambda: app.search_batch(pool[off:off + POD_CHECK_B], use_cache=False),
                         f"phase 10: one pod search_batch of {POD_CHECK_B}")
    off += POD_CHECK_B
    numbers["idle_share_b256"] = idle
    log(f"phase 10 one batch of {POD_CHECK_B}, each stage alone (ms): {json.dumps(split)}")

    # the dense leg's recall at query noise 0.05, against exact fp32 and
    # against what its binary stage 1 (kc 240) allows
    lrng = np.random.default_rng(SEED + 22)
    lidx = lrng.integers(0, N_DOCS, BATCH)
    qlow = vecs[lidx] + LOW_NOISE * lrng.standard_normal((BATCH, DIM)).astype(np.float32)
    qlow /= np.linalg.norm(qlow, axis=1, keepdims=True)
    tlow = [" ".join(texts[i].split()[:6]) for i in lidx]
    dense = base.hybrid_search(qlow, tlow, dense_k=fd, bm25_k=fd, fused_k=TOP_K)["dense"][1]
    eng = src.engine
    exact = exact_top10(eng.vecs[:eng.count], qlow, eng.valid[:eng.count])
    _, cand = ck.hamming_scan_topk_reference(
        base.codes[0], qz.pack_binary(torch.from_numpy(qlow).to(card)), base.valid[0], SERVE_KC)
    allowed = recall_at_10(stage1_rescored_top10(state["vecs"], qlow, cand), exact)
    recall = recall_at_10(dense[:, :TOP_K], exact)
    numbers["dense_recall_at_10_noise_0.05"] = recall
    numbers["stage1_allows"] = allowed
    log(f"phase 10 dense leg recall@10 at query noise {LOW_NOISE} vs exact fp32 over "
        f"{eng.count} rows: {recall:.4f} (its binary stage 1 at kc {SERVE_KC} + exact rescore "
        f"allows {allowed:.4f})")
    check(recall >= allowed - 0.01 and recall >= MIN_LOW_NOISE_RECALL,
          f"pod recall@10 {recall} (allowed {allowed})")
    del cand, exact

    # -- (2) four logical shards over the same rows -----------------------------
    mesh4 = create_mesh(POD_LOGICAL_SHARDS, 1, devices=[card] * POD_LOGICAL_SHARDS)
    t1 = time.perf_counter()
    idx4 = ShardedHybridIndex(mesh4, state["vecs"], bm, valid=state["valid"],
                              level=state["level"], lang=state["lang"],
                              table_rows=eng.capacity)
    idx4.set_fusion(pod._fusion_mode, pod._fusion_weights)
    torch.cuda.synchronize()
    timings["four_shard_build_s"] = time.perf_counter() - t1
    q4 = np.asarray(embs, np.float32)
    ex4 = idx4.search(q4, TOP_K, mode="exact")
    ex1 = eng.search(q4 / np.linalg.norm(q4, axis=1, keepdims=True), TOP_K, mode="exact")
    rows_close(ex4, ex1, "phase 10 four shards exact vs the single-device exact search")
    res4, d4, t4 = tagged(lambda: idx4.hybrid_search(q4, qs, dense_k=fd, bm25_k=fd,
                                                     fused_k=TOP_K, rrf_k=r.rrf_k), 4)
    check(d4["hamming_scan_topk"] == POD_LOGICAL_SHARDS
          and d4["int8_scan_topk"] == POD_LOGICAL_SHARDS, f"four-shard launches {d4}")
    with plain:
        want4 = idx4.hybrid_search(q4, qs, dense_k=fd, bm25_k=fd, fused_k=TOP_K, rrf_k=r.rrf_k)
    legs_equal(res4, want4, "phase 10 four shards (kernels vs plain per shard)")
    rows4 = pod_kernel_rows(ck, idx4, POD_LOGICAL_SHARDS, keys_by_tag[POD_LOGICAL_SHARDS],
                            q4, qs, bm)
    numbers["four_shard_ms_b256"] = t4 * 1e3
    log(f"phase 10 four logical shards (rows_per_shard {idx4.rows_per_shard}, build "
        f"{timings['four_shard_build_s']:.1f} s): exact mode equals the single-device exact "
        f"search; hybrid at B={POD_CHECK_B} {t4 * 1e3:.1f} ms, every leg equals the plain "
        f"per-shard computation; launches {d4}")
    del idx4, want4, res4
    torch.cuda.empty_cache()

    # -- (3) the delta segment, tombstones, a rebase -----------------------------
    crng = np.random.default_rng(SEED + 23)
    chunks = [IngestedChunk(" ".join(f"w{t}" for t in row), {"source": f"pod/chunk{i}"})
              for i, row in enumerate(crng.zipf(1.3, size=(INGEST_CHUNKS, 48)) % 30_000)]
    base_rows = pod._base_rows
    stats, d_ing, t_ing = untagged(lambda: app.ingest_chunks(chunks))
    check(stats["chunks_ingested"] == INGEST_CHUNKS and pod.delta_size == INGEST_CHUNKS
          and pod._base_rows == base_rows and pod._hybrid is base,
          f"phase 10 ingest: {stats}, delta {pod.delta_size}")
    timings["ingest_s"] = t_ing
    t1 = time.perf_counter()
    before = {p.name: p.stat().st_size for p in spill.dir.iterdir()}
    spill.save()
    timings["spill_save_s"] = time.perf_counter() - t1
    after = {p.name: p.stat().st_size for p in spill.dir.iterdir()}
    log_bytes = sum(v for k, v in after.items() if k.startswith("content-"))
    idx_new = sum(v for k, v in after.items() if k.startswith("idx-") and k not in before)
    numbers["spill_save_index_bytes"] = idx_new
    numbers["spill_log_bytes"] = log_bytes
    log(f"phase 10 ingest_chunks of {INGEST_CHUNKS} chunks into the delta segment: "
        f"{t_ing:.1f} s; spill save after it {timings['spill_save_s']:.2f} s, {idx_new} bytes "
        f"of index delta against a {log_bytes}-byte content log; launches {d_ing}")

    own = [c.content for c in chunks[:64]]
    hits, d_own, _ = untagged(lambda: app.search_batch(own, use_cache=False))
    found = sum(any(doc.content == t for doc, _s in h) for t, h in zip(own, hits))
    check(found == len(own), f"only {found} of {len(own)} ingested chunks found by their text")
    embs_own = models.embed(own)
    got = pod.search_hybrid_rows(embs_own, own, **kw)
    d_delta = pod._delta_dense(embs_own, fd)
    s_delta = pod._delta_sparse(own, fd)
    b_res = base.hybrid_search(embs_own, own, dense_k=fd, bm25_k=fd, fused_k=TOP_K,
                               rrf_k=r.rrf_k)
    check(d_delta is not None and s_delta is not None, "the delta answered nothing")
    o_d = merge_oracle(b_res["dense"], d_delta, fd, set())
    o_b = merge_oracle(b_res["bm25"], s_delta, fd, set())
    for leg, o in (("dense", o_d), ("bm25", o_b)):
        check(np.array_equal(got[leg][1], o[1]) and np.array_equal(got[leg][0], o[0]),
              f"phase 10 delta: the merged {leg} leg differs from the host oracle")
    fused_o = _host_fuse(o_d, o_b, TOP_K, r.rrf_k, pod._fusion_mode, pod._fusion_weights)
    check(np.array_equal(got["fused"][1], fused_o[1]), "phase 10 delta: fused differs")
    t_split = {"delta_dense": split_ms(lambda: pod._delta_dense(embs_own, fd)),
               "delta_sparse": split_ms(lambda: pod._delta_sparse(own, fd)),
               "host_fuse": split_ms(lambda: _host_fuse(o_d, o_b, TOP_K, r.rrf_k,
                                                        pod._fusion_mode,
                                                        pod._fusion_weights)),
               "base_search": split_ms(lambda: base.hybrid_search(
                   embs_own, own, dense_k=fd, bm25_k=fd, fused_k=TOP_K, rrf_k=r.rrf_k))}
    numbers["split_ms_b64_with_delta"] = t_split
    log(f"phase 10 delta: all {len(own)} ingested chunks found by their own text; the merged "
        f"legs equal the host oracle of base + delta; one batch of {len(own)}, each stage "
        f"alone (ms): {json.dumps(t_split)}; launches {d_own}")

    dq = pool[off:off + POD_DELETES]
    off += POD_DELETES
    first = pod.search_hybrid_rows(models.embed(dq), dq, **kw)["fused"][1][:, 0]
    doomed = sorted({int(x) for x in first if 0 <= x < pod._base_rows})
    for row in doomed:
        check(app.store.delete_doc(pod.id_for_row(row)), f"delete of row {row}")
    check(pod._tombstones == set(doomed), "tombstones")
    again = pod.search_hybrid_rows(models.embed(dq), dq, **kw)
    for leg in ("dense", "bm25", "fused"):
        check(not np.isin(again[leg][1], doomed).any(), f"a tombstoned row in the {leg} leg")
    o_d = merge_oracle(base.hybrid_search(models.embed(dq), dq, dense_k=fd, bm25_k=fd,
                                          fused_k=TOP_K, rrf_k=r.rrf_k)["dense"],
                       pod._delta_dense(models.embed(dq), fd), fd, pod._tombstones)
    check(np.array_equal(again["dense"][1], o_d[1]), "phase 10 tombstones: dense vs oracle")
    _, d_ref, t_ref = untagged(lambda: pod.refresh())
    timings["refresh_s"] = t_ref
    check(pod.delta_size == 0 and not pod._tombstones and pod._base_rows == eng.count
          and pod._hybrid is not base, "the rebase left a delta")
    base = pod._hybrid
    fresh = ShardedVectorStore(create_mesh(devices=[card]), src, bm25_index=bm)
    fresh.set_fusion(pod._fusion_mode, pod._fusion_weights)
    qf = pool[off:off + POD_CHECK_B]
    off += POD_CHECK_B
    ef = models.embed(qf)
    legs_equal(pod.search_hybrid_rows(ef, qf, **kw), fresh.search_hybrid_rows(ef, qf, **kw),
               "phase 10 rebased pod vs a freshly built pod")
    del fresh
    torch.cuda.empty_cache()
    log(f"phase 10 tombstones: {len(doomed)} base rows deleted, none returned, the dense leg "
        f"equals the host oracle; refresh (rebase of {pod._base_rows} rows) {t_ref:.1f} s, "
        f"then equal to a freshly built pod store; launches {d_ref}")

    # -- (4) the agentic path over the pod ----------------------------------------
    # every pod retrieval of the runs (the first of each, and any retry's)
    # is recorded with its queries and the fused docs it left in the context
    walls, pod_calls = [], []
    run_pod0 = orch._run_hybrid_pod

    def run_pod(ctx, queries_):
        run_pod0(ctx, queries_)
        pod_calls.append((list(queries_), list(ctx.fused_docs)))

    def run_all():
        out = []
        for qn in questions:
            t = time.perf_counter()
            out.append(app.query(qn, use_cache=False))
            walls.append(time.perf_counter() - t)
        return out

    orch._run_hybrid_pod = run_pod
    try:
        results, d_ag, t_ag = untagged(run_all)
    finally:
        del orch._run_hybrid_pod
    modes = {}
    for res_ in results:
        check(res_.success and not res_.degraded, f"phase 10 run {res_.query!r}: "
              f"{res_.degraded}")
        seq = "/".join(st["extra"]["mode"] for st in res_.metrics["steps"]
                       if st["name"] == "retrieval")
        modes[seq] = modes.get(seq, 0) + 1
    check(len(pod_calls) >= len(results), f"{len(pod_calls)} pod retrievals in "
          f"{len(results)} runs")
    for eq, fused in pod_calls:
        got_ = pod.search_hybrid(models.embed(eq), eq, top_k=max(r.dense_top_k, r.bm25_top_k),
                                 fused_k=r.fused_top_k, rrf_k=r.rrf_k, return_legs=True,
                                 fused_depth=fd)
        runs = [run for run in got_["fused"] if run]
        want = (orch.fusion.fuse(runs, top_k=r.fused_top_k) if len(runs) > 1
                else runs[0][:r.fused_top_k])
        check(_docs(fused) == _docs(want),
              f"phase 10: a run's fused docs differ from store.search_hybrid of {eq!r}")
    check(pod._fusion_mode == hy.fusion_mode and not orch.rerank_calibration,
          "the calibration did not reach the pod, or the rerank probes ran on it")
    numbers["agentic"] = {"runs": len(results), "p50_ms": _pct(walls, 0.5) * 1e3,
                          "p99_ms": _pct(walls, 0.99) * 1e3, "pod_retrievals": len(pod_calls),
                          "retrieval_modes": modes}
    log(f"phase 10 agentic: {len(results)} app.query runs, wall p50 "
        f"{numbers['agentic']['p50_ms']:.1f} ms, p99 {numbers['agentic']['p99_ms']:.1f} ms; "
        f"retrieval modes per run {json.dumps(modes)}; the fused docs of all "
        f"{len(pod_calls)} pod retrievals equal store.search_hybrid of their queries; "
        f"launches {d_ag}")

    # -- (5) /search through make_server at 256 clients ----------------------------
    server = make_server(app, "127.0.0.1", 0)
    port = server.server_address[1]
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    coal = server.api._coalescer
    dispatched = []
    dispatch0 = coal.run_batch_async or coal.run_batch

    def dispatch(key, items):
        dispatched.append(list(items))
        return dispatch0(key, items)

    if coal.run_batch_async is not None:
        coal.run_batch_async = dispatch
    else:
        coal.run_batch = dispatch
    load_q = pool[off:off + POD_CLIENTS * POD_REQUESTS]
    off += len(load_q)
    results_http, errors = {}, []

    def client(qs_):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            for q_ in qs_:
                conn.request("POST", "/search", json.dumps({"query": q_, "top_k": TOP_K}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                results_http[q_] = (resp.status, json.loads(resp.read()))
        except Exception as exc:  # reported below
            errors.append(exc)
        finally:
            conn.close()

    def load():
        threads = [threading.Thread(target=client, daemon=True,
                                    args=(load_q[i::POD_CLIENTS],)) for i in range(POD_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads) and not errors, f"clients: {errors[:3]}")

    _, d_http, t_http = tagged(load, 1)
    server.shutdown()
    server.server_close()
    server.api.close()
    serve_thread.join(timeout=30)
    check(not serve_thread.is_alive(), "the phase 10 server thread did not stop")
    bad = 0
    for items in dispatched:
        ref = app.search_batch(items, use_cache=False)
        for q_, h in zip(items, ref):
            status, body = results_http[q_]
            bad += status != 200 or [(x["doc_id"], x["score"]) for x in body["hits"]] != _docs(h)
    check(bad == 0 and len(results_http) == len(load_q),
          f"{bad} /search responses differ from search_batch of their batch")
    numbers["http"] = {"requests": len(load_q), "requests_per_s": len(load_q) / t_http,
                       "batches": len(dispatched),
                       "mean_batch": float(np.mean([len(x) for x in dispatched]))}
    log(f"phase 10 /search: {POD_CLIENTS} clients x {POD_REQUESTS}: {len(load_q)} requests in "
        f"{t_http:.2f} s = {len(load_q) / t_http:.1f} requests/s over {len(dispatched)} "
        f"coalesced batches; every response equals search_batch of its batch; launches "
        f"{d_http}")

    # -- (6) a one-rank NCCL group: the cross-process merge ---------------------------
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    qm = pool[off:off + POD_CHECK_B]
    off += POD_CHECK_B
    em = np.asarray(models.embed(qm), np.float32)
    q0, qc0 = base._queries(em / np.linalg.norm(em, axis=1, keepdims=True), POD_CHECK_B)
    ds, di = base._dense_shard(0, q0, qc0, base.valid[0], fd, SERVE_KC, "binary")
    t1 = time.perf_counter()
    multi = multihost.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                                           device=card if card.type == "cpu" else None)
    try:
        check(not multi and dist.is_initialized() and dist.get_world_size() == 1,
              "one-rank group")
        backend = dist.get_backend()
        ms_, mi_ = multihost.merge_across_processes(ds, di, fd)
        ss_, si_ = merge_topk([ds], [di], fd, ds.device)
        check(torch.equal(ms_, ss_) and torch.equal(mi_, si_),
              "the cross-process merge differs from the single-process merge")
    finally:
        dist.destroy_process_group()
    timings["multihost_s"] = time.perf_counter() - t1
    log(f"phase 10 multihost: a one-rank {backend} group over tcp://127.0.0.1 "
        f"({timings['multihost_s']:.1f} s): all_gather_into_tensor + top-k of a {POD_CHECK_B}"
        f"-query dense leg equals the single-process merge; two ranks wait for a second card")

    # -- (7) the spill docstore -------------------------------------------------------
    rows_h = pod.search_hybrid_rows(ef, qf, **kw)["fused"]
    spill._cache.clear()
    numbers["hydrate_ms_b256_cold"] = split_ms(lambda: pod._hydrate(*rows_h), n=1)
    numbers["hydrate_ms_b256_warm"] = split_ms(lambda: pod._hydrate(*rows_h))
    counter.remove()
    numbers["lru_hit_share"] = counter.hit_share()
    numbers["spill_gets"] = counter.gets
    reads = []
    read0 = SpillDocStore._read_record

    def spy(self, *a):
        reads.append(a)
        return read0(self, *a)

    spill.save()  # the deletes since the save after the ingest
    SpillDocStore._read_record = spy
    try:
        rss0 = vm_rss()
        t1 = time.perf_counter()
        loaded = SpillDocStore.load(str(spill.dir))
        timings["spill_load_s"] = time.perf_counter() - t1
        numbers["spill_load_rss_growth_bytes"] = vm_rss() - rss0
    finally:
        SpillDocStore._read_record = read0
    check(not reads and len(loaded) == len(spill), "the spill load read content bytes")
    numbers["docstore_bytes_per_doc_estimate"] = {"in_ram": doc_bytes(store7.docstore),
                                                  "spill": doc_bytes(loaded)}
    del loaded
    log(f"phase 10 spill docstore: hydration of a {POD_CHECK_B}-query batch's fused rows "
        f"{numbers['hydrate_ms_b256_cold']:.1f} ms from a cold LRU, "
        f"{numbers['hydrate_ms_b256_warm']:.1f} ms warm; LRU hit share over phase 10's "
        f"{counter.gets} gets {numbers['lru_hit_share']:.3f}; load of {len(spill)} docs "
        f"{timings['spill_load_s']:.2f} s reading no content bytes, host RSS growth "
        f"{numbers['spill_load_rss_growth_bytes'] / 2**20:.1f} MiB; sampled host bytes per "
        f"doc {json.dumps(numbers['docstore_bytes_per_doc_estimate'])} (in-RAM docstore of "
        f"phase 7 / spill index)")

    # a forced failure of the pod calibration raises out of the run
    cal0 = hy.calibrate_fusion

    def broken(*a, **k):
        raise RuntimeError("forced calibration failure")

    hy.invalidate_calibration()
    hy.calibrate_fusion = broken
    try:
        app.query(questions[0], use_cache=False)
        raise AssertionError("a failed pod calibration did not raise")
    except DeviceStageError as exc:
        check("forced calibration failure" in str(exc), str(exc))
    finally:
        hy.calibrate_fusion = cal0
    log("phase 10: a forced failure of the pod calibration raises DeviceStageError out of "
        "app.query")

    rows = pod_kernel_rows(ck, base, 1, keys_by_tag[1], vecs[:BATCH], pool[:BATCH], bm)
    rows += rows4
    uncovered = sorted(other_keys - set(known_keys))
    if uncovered:
        qdev = torch.from_numpy(np.asarray(models.embed(pool[:BATCH]), np.float32)).to(card)
        rows += path_rows(ck, eng, bm, qdev, pool[:BATCH], uncovered, "pod app's other paths")
    numbers["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("phase 10 summary: " + json.dumps({"device": smi, "timings_s": timings, **numbers}))
    del app, pod, base, src, state
    return rows


# phase 11: the graph engine (index.use_graph) over phase 7's corpus
GRAPH_EXACT_ROWS = 200_000  # GraphIndex.EXACT_BUILD_MAX_ROWS: the auto path's exact build
GRAPH_DEGREE = 16  # index.graph_degree's default
GRAPH_BUCKETS = (1, 8, 64, 256, 2048)  # app.search_batch(mode="dense") at each
GRAPH_AGREE_ROWS = 4096  # rows whose descent edges meet the exact top-16
GRAPH_SAMPLE_NEW = 256  # inserted rows held to the exact top-16, and searched by their vector
GRAPH_BACK_TARGETS = 64  # back-edge targets held to the weakest-edge oracle
GRAPH_SECOND_INGEST = 2048  # chunks of the second insertion
GRAPH_PLAIN_Q = 64  # queries of the card-vs-CPU beam search
GRAPH_HYBRID_B = 256
EDGE_TIE = 1e-6  # tests/test_torch_graph.py's near-tie rule


class LogRecords(logging.Handler):
    """Keeps the records one logger emits (the descent's per-round lines)."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.logger = logging.getLogger(name)
        self.records, self.level0 = [], self.logger.level

    def __enter__(self):
        self.logger.addHandler(self)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level0)

    def emit(self, record):
        self.records.append(record)


def exact_knn(corpus, rows: np.ndarray, valid, k: int, step: int = 512) -> np.ndarray:
    """Exact top-k neighbours of corpus rows `rows` over the valid rows,
    each row itself excluded: the port's `exact_topk` at k + 1 a block of
    rows at a time, the row dropped (or the last of k + 1 where it is not
    among them). Off the path under test."""
    import torch

    from radiant_rag_tpu_torch.ops import similarity as sim

    out = np.empty((len(rows), k), np.int64)
    for s in range(0, len(rows), step):
        r = np.asarray(rows[s:s + step], np.int64)
        q = corpus[torch.from_numpy(r).to(corpus.device)]
        top = sim.exact_topk(corpus, q, valid, k + 1)[1].cpu().numpy().astype(np.int64)
        keep = np.argsort(top == r[:, None], axis=1, kind="stable")[:, :k]
        out[s:s + len(r)] = np.take_along_axis(top, keep, 1)
    return out


def edge_misses(rows: np.ndarray, want: np.ndarray, got: np.ndarray, hv: np.ndarray):
    """Rows whose edges `got` differ from `want` beyond a near-tie: where the
    two disagree, the two neighbours' float64 cosines to the row differ by
    more than EDGE_TIE (or one side is -1)."""
    bad = []
    for j in np.nonzero((want != got).any(axis=1))[0]:
        a, b = want[j], got[j]
        p = np.nonzero(a != b)[0]
        if (a[p] < 0).any() or (b[p] < 0).any():
            bad.append(int(rows[j]))
            continue
        v = hv[rows[j]].astype(np.float64)
        if np.abs(hv[a[p]].astype(np.float64) @ v - hv[b[p]].astype(np.float64) @ v).max() \
                > EDGE_TIE:
            bad.append(int(rows[j]))
    return bad


def back_edge_oracle(t: int, cur: np.ndarray, cands: np.ndarray, live: np.ndarray,
                     hv: np.ndarray, deg: int) -> np.ndarray:
    """Weakest-edge rule for target t, in numpy float64: its pre-insert
    edges (dead or -1 scored -inf) and the new rows that chose it (in row
    order, those already among its edges dropped), by score descending,
    stable, the first deg; -inf slots are -1."""
    v = hv[t].astype(np.float64)
    cands = np.asarray([c for c in cands if c not in set(cur.tolist())], np.int64)
    ids = np.concatenate([cur.astype(np.int64), cands])
    ok = (ids >= 0) & live[np.maximum(ids, 0)]
    scr = np.where(ok, hv[np.maximum(ids, 0)].astype(np.float64) @ v, -np.inf)
    sel = np.argsort(-scr, kind="stable")[:deg]
    return np.where(np.isfinite(scr[sel]), ids[sel], -1)


def phase_graph(ck, main_path, app7, vecs, texts, smi, d, card=None):
    """Phase 11: the graph engine at MiniLM-L12 width over phase 7's corpus
    (1,016,384 rows): `create_vector_store` with `index.use_graph: true`,
    its engine filled by the load path from phase 7's store
    (`DeviceVectorIndex.from_host`), the docs put into its docstore, then
    `RadiantTPU` over it (its BM25 index built from the store). Checks and
    prints (1) the auto path's exact build over the first 200,000 rows
    against the exact top-16; (2) `store.build_graph()` over every row
    (NN-descent + cluster polish): rounds, per-round ms, structure, sampled
    agreement with the exact top-16; (3) `app.search_batch(mode="dense")`
    at 5 buckets (graph mode at ef 100): ms, QPS, recall@10 beside flat
    int8, a profile, the bound; (4) the card's beam search against the
    port's plain run on the CPU; (6) the fused hybrid under use_graph
    against search_rows(mode="int8"); (5) 16,384 ingested chunks inserted
    by the query path: out-edges exact, back-edges the weakest-edge
    oracle's; (7) peak memory. The graph path launches no kernel; the
    hybrid's stage 1 does (int8_scan_topk)."""
    import torch

    from radiant_rag_tpu_torch.app import RadiantTPU
    from radiant_rag_tpu_torch.config import config_from_dict
    from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
    from radiant_rag_tpu_torch.index.factory import create_vector_store
    from radiant_rag_tpu_torch.index.graph import GraphIndex, graph_search
    from radiant_rag_tpu_torch.index.hybrid import embed_queries_device
    from radiant_rag_tpu_torch.ingestion.processor import IngestedChunk

    card = torch.device("cuda", 0) if card is None else torch.device(card)
    check(not torch.backends.cuda.matmul.allow_tf32, "phase 11 needs TF32 off")
    store7, models = app7.store, app7.local_models
    gdir = d / "graph"
    cfg = config_from_dict({
        "embedding": {**MINILM_PRESET["embedding"], "checkpoint_dir": str(d / "embedder_ckpt")},
        "index": {"use_graph": True, "data_dir": str(gdir / "index"), "auto_persist": False},
        "bm25": {"index_path": str(gdir / "bm25.json.gz")},
        "strategy_memory": {"path": str(gdir / "strategy_memory.json.gz")},
        "conversation": {"data_dir": str(gdir / "conversations")}})
    ic, r, q = cfg.index, cfg.retrieval, cfg.quantization
    check((ic.use_graph, ic.graph_degree, ic.graph_ef_runtime, q.rescore_multiplier)
          == (True, GRAPH_DEGREE, 100, 4.0), "phase 11 config")
    ef = ic.graph_ef_runtime
    timings, numbers = {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # -- the store, its app ---------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = create_vector_store(cfg, device=card)
    check(type(store).__name__ == "TpuVectorStore" and store._default_mode() == "int8",
          "phase 11 store")
    state = store7.engine.to_host()
    store.engine = DeviceVectorIndex.from_host(state, initial_capacity=store7.engine.capacity,
                                               stage1_select=ic.stage1_select, device=card)
    store.lang_codes = dict(store7.lang_codes)
    for doc in store7.docstore:  # the docs, as a load puts them
        store.docstore.put(doc, row=store7.docstore.id_to_row.get(doc.doc_id))
    app = RadiantTPU(cfg, llm=app7.llm, store=store, local_models=models, device=card)
    n_bm = app.bm25_index.get_stats()["num_docs"]
    eng = store.engine
    count = eng.count
    timings["store_and_app_s"] = time.perf_counter() - t0
    check(count == state["vecs"].shape[0] and n_bm == count
          and store.count_documents() == store7.count_documents(), "phase 11 load")
    valid_h = eng.valid[:count].cpu().numpy()
    hv = eng.vecs[:count].cpu().numpy()  # host copy: oracles and the CPU plain run
    log(f"phase 11 store: {count} rows from phase 7's state, {store.count_documents()} docs, "
        f"RadiantTPU with its BM25 index built from the store in "
        f"{timings['store_and_app_s']:.1f} s; index.use_graph {ic.use_graph}, graph_degree "
        f"{ic.graph_degree}, graph_ef_runtime {ef}")

    # -- (1) the auto path's exact build at 200,000 rows ------------------------------
    ne = min(GRAPH_EXACT_ROWS, count)
    check(ne <= GraphIndex.EXACT_BUILD_MAX_ROWS, "phase 11 exact rows")
    g200 = GraphIndex(degree=GRAPH_DEGREE, device=card)
    _, timings["exact_build_200k_s"] = timed(
        lambda: g200.build(eng.vecs[:ne], valid=valid_h[:ne]))
    rows200 = np.arange(ne)
    want = exact_knn(eng.vecs[:ne], rows200, eng.valid[:ne], GRAPH_DEGREE)
    got = g200.neighbors[:ne, :GRAPH_DEGREE].cpu().numpy().astype(np.int64)
    bad = edge_misses(rows200, want, got, hv)
    differ = int((want != got).any(axis=1).sum())
    check(not bad, f"phase 11 exact build: {len(bad)} rows beyond a near-tie, e.g. {bad[:5]}")
    log(f"phase 11 (1) GraphIndex(degree={GRAPH_DEGREE}).build over the first {ne} rows (the "
        f"exact tiled build): {timings['exact_build_200k_s']:.2f} s; every row's "
        f"{GRAPH_DEGREE} edges equal the exact top-{GRAPH_DEGREE} ({differ} rows differ only at "
        f"near-ties within {EDGE_TIE})")
    del g200, want, got

    # -- (2) store.build_graph() over every row: NN-descent + polish ------------------
    with LogRecords("radiant_rag_tpu_torch.index.graph") as rec:
        _, timings["build_graph_s"] = timed(store.build_graph)
    graph = eng.graph
    check(graph is not None and graph.built_rows == count and store._default_mode() == "graph",
          "phase 11 build_graph")
    rounds = [x.args for x in rec.records if str(x.msg).startswith("nn-descent round")]
    polish = [x.args[0] for x in rec.records if str(x.msg).startswith("cluster polish")]
    check(rounds and polish, "phase 11: the descent logged no rounds")
    numbers["rounds"] = len(rounds)
    numbers["converged"] = any("converged" in str(x.msg) for x in rec.records)
    numbers["per_round"] = [{"changes": a[1], "host_ms": round(a[4], 1),
                             "device_span_ms": round(a[5], 1)} for a in rounds]
    timings["polish_s"] = float(polish[0])
    nb = graph.neighbors[:count].cpu().numpy()
    knn = nb[:, :GRAPH_DEGREE]
    live_or_pad = (knn == -1) | ((knn >= 0) & valid_h[np.maximum(knn, 0)])
    srt = np.sort(knn, axis=1)
    check(live_or_pad.all(), "phase 11: a KNN edge to a dead row")
    check(not (knn == np.arange(count)[:, None]).any(), "phase 11: a self-edge")
    check(not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(), "phase 11: a repeated edge")
    check(((nb[:, GRAPH_DEGREE:] >= 0) & valid_h[nb[:, GRAPH_DEGREE:]]).all(),
          "phase 11: a long edge off the live pool")
    arows = np.sort(np.random.default_rng(SEED + 40).choice(count, GRAPH_AGREE_ROWS,
                                                            replace=False))
    ex = exact_knn(eng.vecs[:count], arows, eng.valid[:count], GRAPH_DEGREE)
    numbers["edge_agreement"] = float(np.mean([len(set(ex[j]) & set(knn[rw])) / GRAPH_DEGREE
                                               for j, rw in enumerate(arows)]))
    log(f"phase 11 (2) store.build_graph() over {count} rows (NN-descent + cluster polish): "
        f"{timings['build_graph_s']:.1f} s, {numbers['rounds']} rounds (converged: "
        f"{numbers['converged']}), polish {timings['polish_s']:.1f} s; per round (edge "
        f"changes, host ms, device span ms): "
        f"{[(x['changes'], x['host_ms'], x['device_span_ms']) for x in numbers['per_round']]}; "
        f"structure: every KNN edge live or -1, no self-edge, no repeat; edge agreement with "
        f"the exact top-{GRAPH_DEGREE} over {GRAPH_AGREE_ROWS} sampled rows "
        f"{numbers['edge_agreement']:.4f} (reported, not gated)")
    del nb, knn, srt, ex

    # -- (3) serving: app.search_batch(mode="dense") in graph mode -----------------------
    qrng = np.random.default_rng(SEED + 41)
    pool = list(dict.fromkeys(" ".join(texts[i].split()[:6])
                              for i in qrng.integers(0, N_DOCS, 12_000)))
    r_deg = graph.neighbors.shape[1]
    m_cells = ef * (r_deg + 1)
    ms, eng_ms, bounds, off = {}, {}, {}, 0
    for b in GRAPH_BUCKETS:
        qs = pool[off:off + b]
        off += b
        hits, dl, dt = main_path(lambda qs=qs: app.search_batch(qs, mode="dense", use_cache=False))
        check(not any(dl.values()), f"phase 11: graph search launched kernels {dl}")
        check(len(hits) == b and all(hits), f"phase 11 B={b}: empty results")
        ms[b] = dt * 1e3
        embs = np.asarray(models.embed(qs), np.float32)
        embs /= np.linalg.norm(embs, axis=1, keepdims=True)
        _, t_e = timed(lambda: eng.search(embs, TOP_K, mode="graph", ef_runtime=ef))
        eng_ms[b] = t_e * 1e3
        bounds[b] = graph.steps * b * m_cells * DIM * 4 / HBM_BYTES_PER_S * 1e3
    numbers.update({"search_batch_ms": ms, "engine_graph_ms": eng_ms, "bound_ms": bounds,
                    "qps": {b: b / (ms[b] / 1e3) for b in GRAPH_BUCKETS}})
    log(f"phase 11 (3) app.search_batch(mode='dense'), graph mode at ef {ef}, top_k {TOP_K}: "
        f"ms per batch {json.dumps({b: round(v, 2) for b, v in ms.items()})}, QPS "
        f"{json.dumps({b: round(v, 1) for b, v in numbers['qps'].items()})}; the engine's "
        f"graph search alone (ms) {json.dumps({b: round(v, 2) for b, v in eng_ms.items()})} "
        f"against the bound steps x B x ef(R+1) x D x 4 B / 3.35 TB/s "
        f"{json.dumps({b: round(v, 3) for b, v in bounds.items()})}; no kernel launched")

    rrng = np.random.default_rng(SEED + 42)
    recall = {}
    for noise in (0.25, LOW_NOISE):
        qv = hv[rrng.integers(0, count, BATCH)] + noise * rrng.standard_normal(
            (BATCH, DIM)).astype(np.float32)
        qv /= np.linalg.norm(qv, axis=1, keepdims=True)
        ex50 = exact_top10(eng.vecs[:count], qv, eng.valid[:count], k=50)
        gs, gr = eng.search(qv, TOP_K, mode="graph", ef_runtime=ef)
        fs, fr = eng.search(qv, TOP_K, mode="int8", rescore_multiplier=q.rescore_multiplier,
                            ef_runtime=ef)
        exact_s = np.einsum("bd,bkd->bk", qv, hv[ex50[:, :TOP_K]])
        recall[noise] = {
            "graph": recall_at_10(gr, ex50[:, :TOP_K]),
            "flat_int8": recall_at_10(fr, ex50[:, :TOP_K]),
            "graph_top10_in_exact_top50": float(np.mean([len(set(gr[i]) & set(ex50[i])) / TOP_K
                                                         for i in range(BATCH)])),
            "graph_mean_score_regret": float(np.mean(exact_s.sum(1) - gs.sum(1)) / TOP_K),
            "flat_mean_score_regret": float(np.mean(exact_s.sum(1) - fs.sum(1)) / TOP_K)}
    numbers["recall_at_10"] = recall
    log(f"phase 11 (3) recall@10 against exact fp32 over {count} rows, {BATCH} queries each "
        f"(graph at ef {ef} / flat int8 at kc {ef}): {json.dumps(recall)}")
    qp = np.asarray(models.embed(pool[off:off + GRAPH_HYBRID_B]), np.float32)
    off += GRAPH_HYBRID_B
    qp /= np.linalg.norm(qp, axis=1, keepdims=True)
    try:
        numbers["idle_share_b256"] = profile_batch(
            lambda: eng.search(qp, TOP_K, mode="graph", ef_runtime=ef),
            f"the engine's graph search, B={GRAPH_HYBRID_B}")
    except Exception as exc:  # measurement only: report it, keep the run
        log(f"profile: unavailable ({type(exc).__name__}: {exc}); device time not measured")
    gathered = graph.steps * GRAPH_HYBRID_B * m_cells * DIM * 4
    log(f"phase 11 (3) B={GRAPH_HYBRID_B}: gathered bytes {gathered} ({graph.steps} steps x "
        f"{GRAPH_HYBRID_B} x {m_cells} x {DIM} x 4 B), bound "
        f"{gathered / HBM_BYTES_PER_S * 1e3:.3f} ms")

    # -- (4) the card's beam search against the port's plain run on the CPU ----------------
    qc = qv[:GRAPH_PLAIN_Q]
    built = graph.built_rows
    mask = eng.valid[:built]
    args = dict(k=TOP_K, ef=ef, steps=graph.steps)
    on_card = graph_search(eng.vecs[:built], graph.neighbors, graph.entry_points,
                           torch.from_numpy(qc).to(card), mask,
                           entry_sample_rows=graph.entry_sample_rows,
                           entry_sample_vecs=graph.entry_sample_vecs, **args)
    t1 = time.perf_counter()
    plain = graph_search(torch.from_numpy(hv[:built]), graph.neighbors.cpu(),
                         graph.entry_points.cpu(), torch.from_numpy(qc), mask.cpu(),
                         entry_sample_rows=graph.entry_sample_rows.cpu(),
                         entry_sample_vecs=graph.entry_sample_vecs.cpu(), **args)
    timings["cpu_plain_search_s"] = time.perf_counter() - t1
    rows_close((on_card[0].cpu().numpy(), on_card[1].cpu().numpy()),
               (plain[0].numpy(), plain[1].numpy()), "phase 11 card vs CPU beam search")
    log(f"phase 11 (4) graph_search on the card equals the port's plain run on the CPU "
        f"({GRAPH_PLAIN_Q} queries over {built} rows, ef {ef}; CPU "
        f"{timings['cpu_plain_search_s']:.1f} s): rows equal, scores within 1e-5 but for ties")

    # -- (6) the fused hybrid under use_graph -------------------------------------------------
    hq = pool[off:off + GRAPH_HYBRID_B]
    off += GRAPH_HYBRID_B
    searcher, t_cal = timed(app._fused_searcher)
    check(searcher is not None and store._default_mode() == "graph", "phase 11 hybrid searcher")
    hits, dh, t_h = main_path(lambda: app.search_batch(hq, mode="hybrid", use_cache=False))
    check(dh["int8_scan_topk"] >= 1, f"phase 11 hybrid launches {dh}")
    kw = dict(dense_k=TOP_K, bm25_k=TOP_K, fused_k=TOP_K, rrf_k=r.rrf_k,
              rescore_multiplier=q.rescore_multiplier, fusion=r.fusion_weighting)
    qdev = embed_queries_device(models, searcher.engine, hq)
    res_g = searcher.search_rows(None, hq, _qdev=qdev, mode="graph", **kw)
    res_8 = searcher.search_rows(None, hq, _qdev=qdev, mode="int8", **kw)
    legs_equal(res_g, res_8, "phase 11 hybrid: mode graph against int8")
    check([_docs(h) for h in hits] == [_docs(h) for h in app._resolve_fused_rows(res_8, len(hq))],
          "phase 11: search_batch(hybrid) differs from search_rows(mode='int8')")
    log(f"phase 11 (6) app.search_batch(mode='hybrid') at B={GRAPH_HYBRID_B} under use_graph: "
        f"{t_h * 1e3:.1f} ms (the BM25 device tables and the calibration before it "
        f"{t_cal:.1f} s); its fused rows and scores equal search_rows(mode='int8') on every "
        f"leg; launches {dh}")
    del res_g, res_8, qdev

    # -- (5) incremental insert through the query path -----------------------------------------
    def insert_and_check(n_chunks, seed, label):
        """Ingest n_chunks chunks, run one dense search (the query path
        inserts them), time it against the next search, and hold sampled
        new rows' out-edges to the exact top-16 and sampled targets' edges
        to the weakest-edge oracle. A pre-insert target's edges before the
        merge are its edges before the ingest; a new target's are its exact
        out-edges (which no candidate displaces but at a tie)."""
        base = eng.count
        pre = graph.neighbors[:base, :GRAPH_DEGREE].cpu().numpy()
        crng = np.random.default_rng(seed)
        chunks = [IngestedChunk(" ".join(f"w{t}" for t in row), {"source": f"{label}/chunk{i}"})
                  for i, row in enumerate(crng.zipf(1.3, size=(n_chunks, 48)) % 30_000)]
        stats, t_ing = timed(lambda: app.ingest_chunks(chunks))
        check(stats["chunks_ingested"] == n_chunks and eng.count == base + n_chunks
              and graph.built_rows == base, (stats, eng.count, graph.built_rows))
        nonlocal off
        qs1, qs2 = pool[off:off + 1], pool[off + 1:off + 2]
        off += 2
        _, t_first = timed(lambda: app.search_batch(qs1, mode="dense", use_cache=False))
        check(eng.graph is graph and graph.built_rows == eng.count,
              f"phase 11: built_rows {graph.built_rows} != count {eng.count} after the search")
        _, t_next = timed(lambda: app.search_batch(qs2, mode="dense", use_cache=False))
        total = eng.count
        hv2 = eng.vecs[:total].cpu().numpy()
        live2 = eng.valid[:total].cpu().numpy()
        nb2 = graph.neighbors[:total].cpu().numpy()
        srng = np.random.default_rng(seed + 1)
        new_rows = np.sort(srng.choice(np.arange(base, total), GRAPH_SAMPLE_NEW, replace=False))
        want = exact_knn(eng.vecs[:total], new_rows, eng.valid[:total], GRAPH_DEGREE)
        bad = edge_misses(new_rows, want, nb2[new_rows, :GRAPH_DEGREE].astype(np.int64), hv2)
        check(not bad, f"phase 11 {label}: inserted rows' out-edges beyond a near-tie: {bad[:5]}")
        chose = {}
        for j, row in enumerate(nb2[base:total, :GRAPH_DEGREE]):
            for t in row[row >= 0]:
                chose.setdefault(int(t), []).append(base + j)
        old_t = np.asarray(sorted(t for t in chose if t < base), np.int64)
        new_t = np.asarray(sorted(t for t in chose if t >= base), np.int64)
        n_old = min(len(old_t), GRAPH_BACK_TARGETS)
        targets = np.concatenate([srng.choice(old_t, n_old, replace=False),
                                  srng.choice(new_t, GRAPH_BACK_TARGETS - n_old, replace=False)])
        cur = {int(t): pre[t] for t in targets[:n_old]}
        for t, row in zip(targets[n_old:], exact_knn(eng.vecs[:total], targets[n_old:],
                                                     eng.valid[:total], GRAPH_DEGREE)):
            cur[int(t)] = row
        oracle = np.stack([back_edge_oracle(t, cur[int(t)], chose[int(t)], live2, hv2,
                                            GRAPH_DEGREE) for t in targets])
        bad = edge_misses(targets, oracle, nb2[targets, :GRAPH_DEGREE].astype(np.int64), hv2)
        check(not bad, f"phase 11 {label}: back-edges differ from the weakest-edge oracle: "
                       f"{bad[:5]}")
        gained = int(sum((nb2[t, :GRAPH_DEGREE] >= base).any() for t in targets[:n_old]))
        _, sr = eng.search(hv2[new_rows], TOP_K, mode="graph", ef_runtime=ef)
        out = {"ingest_s": t_ing, "first_search_with_insert_s": t_first,
               "insert_s": t_first - t_next, "pre_insert_targets": int(len(old_t)),
               "old_targets_checked": n_old, "old_targets_gaining_a_new_row": gained,
               "rank1_share": float(np.mean(sr[:, 0] == new_rows))}
        log(f"phase 11 (5) {label}: ingest_chunks of {n_chunks} chunks {t_ing:.1f} s, then one "
            f"dense search {t_first:.2f} s (the next {t_next * 1e3:.1f} ms: the query path's "
            f"insertion ~{out['insert_s']:.2f} s); built_rows {graph.built_rows} == count "
            f"{eng.count}; {GRAPH_SAMPLE_NEW} sampled new rows' out-edges equal the exact "
            f"top-{GRAPH_DEGREE} over the live corpus; {GRAPH_BACK_TARGETS} sampled targets' "
            f"edges ({n_old} of {len(old_t)} pre-insert targets, {gained} of them now pointing "
            f"at a new row; the rest new rows) equal the weakest-edge oracle; a search by their "
            f"own vector returns {out['rank1_share']:.4f} of {GRAPH_SAMPLE_NEW} new rows at "
            f"rank 1; stale fraction {graph.stale_fraction:.4f}")
        return out

    numbers["insert"] = insert_and_check(INGEST_CHUNKS, SEED + 43, "insert")
    # a second, smaller ingest: its rows sit among the first ingest's (one
    # encoder embeds both), so its targets are pre-insert rows whose edges
    # the weakest-edge merge rewrites
    numbers["insert_again"] = insert_and_check(GRAPH_SECOND_INGEST, SEED + 45, "insert again")
    check(numbers["insert_again"]["old_targets_checked"] == GRAPH_BACK_TARGETS,
          "phase 11: too few pre-insert targets for the back-edge check")

    numbers["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("phase 11 summary: " + json.dumps({"device": smi, "rows": count, "timings_s": timings,
                                           **numbers}, default=str))
    del app, store, graph, eng, hv, state


# phase 12: the query path's host layers (the language phase, web search,
# the crawled ingests and their routes, reports and the CLI, the metrics
# exporters, profiling, the agent template) over phase 7's app
LANG_QUESTIONS = 8  # phase 8's questions, each rendered in de, fr, es and en: 32 runs
LANG_TEMPLATES = {
    "de": "Was sagen die Dokumente über die Begriffe {q} und warum ist das für die "
          "Forschung wichtig?",
    "fr": "Que disent les documents sur les termes {q} et pourquoi est-ce important pour la "
          "recherche?",
    "es": "¿Qué dicen los documentos sobre los términos {q} y por qué es importante para la "
          "investigación?",
    "en": "What do the documents say about the terms {q} and why does it matter for the "
          "research?",
}
WEB_SECTIONS, WEB_LEAVES = 8, 8  # the loopback site: a root, 8 sections of 8 pages each
WEB_RUNS = 16  # agentic runs whose plan asks for the web
WEB_URLS = 3  # web_search.max_urls
HOST_CLIENTS = 8  # /search clients beside the crawler routes
GH_REPOS = {  # two repositories served from the checkout's own sources
    "port": ("README.md", "radiant_rag_tpu_torch/agents/web_search.py",
             "radiant_rag_tpu_torch/ingestion/web_crawler.py",
             "radiant_rag_tpu_torch/ingestion/github_crawler.py",
             "radiant_rag_tpu_torch/ui/reports.py", "radiant_rag_tpu_torch/agents/registry.py"),
    "docs": ("radiant_rag_tpu_torch/ui/tui_model.py", "radiant_rag_tpu_torch/agents/chunking.py"),
}
MMR_K = 10


def web_phrase(tag) -> str:
    """A page's whole text: words no corpus text holds."""
    return f"zebra{tag} quokka{tag} lantern{tag} marmot{tag}"


class LoopbackSite:
    """An `http.server` on 127.0.0.1:0 serving generated pages (each page's
    text is its phrase; links carry no text) and a GitHub look-alike: the
    repository and tree JSON of the git API and the raw files, for
    `GitHubCrawler.API` / `RAW` pointed at it. Every path it serves is
    logged in `hits`."""

    def __init__(self, repo: Path):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.pages, self.hits = {}, []
        self.phrases = {}  # path -> the page's text
        self._add_site("/", "a", WEB_SECTIONS, WEB_LEAVES)
        self._add_site("/b/", "b", 2, 4)
        self.pages["/never.html"] = self._html("never", [])
        for name, paths in GH_REPOS.items():
            tree = {"tree": [{"path": p, "type": "blob"} for p in paths]}
            self.pages[f"/repos/radiant/{name}"] = (
                json.dumps({"default_branch": "main"}).encode(), "application/json")
            self.pages[f"/repos/radiant/{name}/git/trees/main?recursive=1"] = (
                json.dumps(tree).encode(), "application/json")
            for p in paths:
                self.pages[f"/radiant/{name}/main/{p}"] = ((repo / p).read_bytes(), "text/plain")
        site = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                site.hits.append(self.path)
                if self.path not in site.pages:
                    self.send_error(404)
                    return
                body, ctype = site.pages[self.path]
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.root = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @staticmethod
    def _html(tag, links):
        anchors = "".join(f'<a href="{link}"></a>' for link in links)
        return (f"<html><head><title>{tag}</title></head><body><p>{web_phrase(tag)}</p>"
                f"{anchors}</body></html>").encode(), "text/html; charset=utf-8"

    def _add_site(self, root, prefix, sections, leaves):
        sec = [f"{root}s{k}.html" for k in range(sections)]
        self.pages[root] = self._html(f"{prefix}root", sec)
        self.phrases[root] = web_phrase(f"{prefix}root")
        for k, s in enumerate(sec):
            kids = [f"{root}p{k * leaves + j}.html" for j in range(leaves)]
            self.pages[s] = self._html(f"{prefix}s{k}", kids)
            self.phrases[s] = web_phrase(f"{prefix}s{k}")
            for j, kid in enumerate(kids):
                self.pages[kid] = self._html(f"{prefix}p{k * leaves + j}", [])
                self.phrases[kid] = web_phrase(f"{prefix}p{k * leaves + j}")

    def site_pages(self, root):
        return {p: t for p, t in self.phrases.items() if p.startswith(root) and
                (root != "/" or not p.startswith("/b/"))}

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)


class HostLayersLLM(ScriptedLLM):
    """Phase 8's scripted LLM over no indexed question (no critic retry,
    no multihop), which also translates the rendered questions back to
    English (counting its calls), suggests the web pages of the questions
    that have some, and plans web search for those."""

    def __init__(self, translations, web_urls):
        super().__init__([])
        self.translations, self.web_urls = translations, web_urls
        self.translated = {}

    def __call__(self, messages):
        last = messages[-1]["content"]
        if last.startswith("Translate the following text"):
            text = last.split("\n\n", 1)[1]
            with self.lock:
                self.translated[text] = self.translated.get(text, 0) + 1
            return self.translations[text]
        if "public web page URLs" in last:
            return json.dumps(self.web_urls.get(self._after(last, "Query: "), []))
        if "query-planning agent" in last:
            plan = json.loads(super().__call__(messages))
            plan["use_web_search"] = self._after(last, "Query: ") in self.web_urls
            return json.dumps(plan)
        return super().__call__(messages)


def _widget_text(widget) -> str:
    """The plain text a Textual `Static` shows (`content` in newer Textual,
    `renderable` in older)."""
    for attr in ("content", "renderable"):
        value = getattr(widget, attr, None)
        if value is not None and not callable(value):
            return str(value)
    return str(widget.render())


def drive_textual_tui(rag_app, question: str, save_dir: Path, timeout_s: float = 120.0):
    """The Textual frontend headless (`App.run_test`'s pilot): `question`
    typed into the input and submitted, the run awaited, the timeline and
    every tab read back, and ctrl+s pressed (its report lands in
    `save_dir`). Returns (session, tab texts, timeline text, report paths)."""
    import asyncio

    from radiant_rag_tpu_torch.ui import tui
    from radiant_rag_tpu_torch.ui.tui_model import TAB_NAMES

    async def pilot_run():
        ui = tui.AgenticRAGApp(rag_app)
        async with ui.run_test(size=(120, 48)) as pilot:
            box = ui.query_one("#query", tui.Input)
            box.focus()
            box.value = question
            await pilot.press("enter")
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                await pilot.pause(0.05)
                if not ui.session.running and ui.session.result is not None and \
                        _widget_text(ui.query_one("#content-overview", tui.Static)).strip():
                    break
            tabs = {name: _widget_text(ui.query_one(f"#content-{name}", tui.Static))
                    for name in TAB_NAMES}
            timeline = _widget_text(ui.query_one("#timeline", tui.Static))
            await pilot.press("ctrl+s")
            await pilot.pause(0.2)
        return ui.session, tabs, timeline

    cwd = os.getcwd()
    save_dir.mkdir(parents=True, exist_ok=True)
    os.chdir(save_dir)  # ctrl+s writes report-<time>.md into the working directory
    try:
        session, tabs, timeline = asyncio.run(pilot_run())
    finally:
        os.chdir(cwd)
    return session, tabs, timeline, sorted(save_dir.glob("report-*.md"))


def phase_host_layers(ck, main_path, app, questions, texts, smi, d, card=None):
    """Phase 12: the query path's host layers over phase 7's app (1,016,384
    leaf rows, MiniLM-L12-width bf16 models, kc = 240). (a) the language
    phase: phase 8's questions in German, French, Spanish and English
    through an orchestrator with `language.enabled`, each run's fused and
    reranked docs held exactly against a direct run of the English
    question; (b) web search over a loopback site (a blocked domain, the
    TTL cache); (c) the crawled ingests: `ingest_urls` at depth 2 and
    `ingest_github`, then `/ingest/urls` and `/ingest/github` beside
    /search clients, every answer held against `search_batch` of its batch,
    and each page's phrase at rank 1 of a hybrid `search_batch`; (d) the
    reports and the CLI (`ingest`, `query --report`, `search --save`, `tui`
    in subprocesses), then the Textual frontend headless over this app
    (`drive_textual_tui`); (e) the metrics exporters; (f) a `torch.profiler`
    trace of one agentic run and `device_timer` against CUDA events; (g)
    the template agent's MMR on the card against the CPU. Returns the
    (kernel, D or W, k, B) shapes its main paths launched."""
    import dataclasses
    import http.client
    import importlib.util
    import os
    import threading

    import torch

    from radiant_rag_tpu_torch.agents import agent_template
    from radiant_rag_tpu_torch.agents.base import new_agent_context
    from radiant_rag_tpu_torch.agents.base_agent import BaseAgent
    from radiant_rag_tpu_torch.ingestion import github_crawler
    from radiant_rag_tpu_torch.ingestion.web_crawler import WebCrawler
    from radiant_rag_tpu_torch.llm.backends import MockLLMBackend
    from radiant_rag_tpu_torch.llm.client import LLMClient
    from radiant_rag_tpu_torch.orchestrator import RAGOrchestrator
    from radiant_rag_tpu_torch.server import make_server
    from radiant_rag_tpu_torch.ui.reports import QueryReport, save_search_report
    from radiant_rag_tpu_torch.utils.profiling import annotate, device_timer, profiler_trace

    card = torch.device("cuda", 0) if card is None else torch.device(card)
    repo = Path(__file__).resolve().parent
    orch, hy, store, models = app.orchestrator, app.orchestrator._hybrid, app.store, app.local_models
    cfg = app.config
    launched, numbers = set(), {}

    def drive(fn):
        out, delta, dt = main_path(fn)
        launched.update(ck.launches_by_shape)
        return out, delta, dt

    def run_all(o, qs):
        results, walls = [], []
        for q in qs:
            t = time.perf_counter()
            results.append(o.run(q))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        return results, walls

    def docs_of(hits):
        return [(dd.doc_id, s) for dd, s in hits]

    site = LoopbackSite(repo)
    english, rendered = {}, []
    for q in questions[:LANG_QUESTIONS]:
        english[q] = LANG_TEMPLATES["en"].format(q=q)
        rendered += [(code, LANG_TEMPLATES[code].format(q=q), english[q])
                     for code in ("de", "fr", "es", "en")]
    translations = {r: e for code, r, e in rendered if code != "en"}
    web_q = [LANG_TEMPLATES["en"].format(q=q)
             for q in questions[LANG_QUESTIONS:LANG_QUESTIONS + WEB_RUNS]]
    leaves = [p for p in site.site_pages("/") if "/p" in p]
    web_urls = {}
    for i, q in enumerate(web_q):
        urls = [site.root + leaves[(WEB_URLS * i + j) % len(leaves)] for j in range(WEB_URLS)]
        if i % 4 == 0:  # a blocked domain first: skipped, never fetched
            urls.insert(0, f"http://localhost:{site.root.rsplit(':', 1)[1]}/never.html")
        web_urls[q] = urls
    script = HostLayersLLM(translations, web_urls)
    llm12 = LLMClient(cfg.llm, backend=MockLLMBackend(responder=script))
    base = dataclasses.replace(
        cfg, strategy_memory=dataclasses.replace(cfg.strategy_memory, enabled=False),
        rerank=dataclasses.replace(cfg.rerank, auto_disable_probes=0))

    def orchestrator(c, crawler=None):
        o = RAGOrchestrator(c, store, app.bm25_index, models, llm12, web_crawler=crawler,
                            device_lock=app.device_lock)
        o._hybrid = hy  # phase 7's calibrated searcher
        return o

    try:
        # (a) the language phase
        o_lang = orchestrator(dataclasses.replace(
            base, language=dataclasses.replace(cfg.language, enabled=True)))
        o_direct = orchestrator(base)
        (res_l, walls_l), d_l, _ = drive(lambda: run_all(o_lang, [r for _, r, _ in rendered]))
        (res_d, walls_d), d_d, _ = drive(lambda: run_all(o_direct, list(english.values())))
        direct = dict(zip(english.values(), res_d))
        hits_l = {}
        for (code, text, eng_q), res in zip(rendered, res_l):
            check(res.success and not res.degraded, f"phase 12 (a) {code}: {res.degraded}")
            lang = res.language
            check(lang.get("source_language") == code and lang["translated"] == (code != "en")
                  and res.metrics["steps"][0]["name"] == "language",
                  f"phase 12 (a): {text!r} detected as {lang}")
            hits_l[code] = hits_l.get(code, 0) + 1
            ref = direct[eng_q]
            check(docs_of(res.fused_docs) == docs_of(ref.fused_docs) and res.fused_docs,
                  f"phase 12 (a) {code}: fused docs differ from the direct run: "
                  f"{_diff(docs_of(res.fused_docs), docs_of(ref.fused_docs))}")
            check(docs_of(res.reranked_docs) == docs_of(ref.reranked_docs) and res.reranked_docs,
                  f"phase 12 (a) {code}: reranked docs differ from the direct run")
            check(res.effective_queries == ref.effective_queries and res.answer == ref.answer,
                  f"phase 12 (a) {code}: the run differs from the direct run")
        check(script.translated == {t: 1 for t in translations},
              "phase 12 (a): a translation was not made exactly once per rendered question, "
              "or an English question was translated")
        check(d_l["int8_scan_topk"] > 0, d_l)
        numbers["language"] = {
            "runs": len(res_l), "detected": hits_l, "translation_calls": len(script.translated),
            "ms_per_run_p50": _pct(walls_l, 0.5) * 1e3, "ms_per_run_p99": _pct(walls_l, 0.99) * 1e3,
            "direct_ms_per_run_p50": _pct(walls_d, 0.5) * 1e3,
            "language_step_ms_p50": _pct([r.metrics["steps"][0]["duration_ms"] for r in res_l],
                                         0.5)}
        log(f"phase 12 (a) language phase: {json.dumps(numbers['language'])}; launches {d_l}; "
            f"every run's fused and reranked docs equal the direct English run's; {smi}")

        # (b) web search through an orchestrator built with a crawler
        cfg_web = dataclasses.replace(
            base, pipeline=dataclasses.replace(base.pipeline, use_web_search=True),
            web_search=dataclasses.replace(base.web_search, max_urls=WEB_URLS,
                                           blocked_domains=("localhost",)))
        o_web = orchestrator(cfg_web, WebCrawler(rate_limit_delay_s=0.0))
        (res_w, walls_w), d_w, _ = drive(lambda: run_all(o_web, web_q))
        for q, res in zip(web_q, res_w):
            want = ["web:" + u for u in web_urls[q] if "localhost" not in u]
            got_web = [dd.doc_id for dd, _ in res.web_docs]
            check(res.success and not res.degraded and got_web == want,
                  f"phase 12 (b): web docs {got_web} != {want} ({res.degraded})")
            check(set(got_web) <= {dd.doc_id for dd, _ in res.fused_docs},
                  "phase 12 (b): fetched pages missing from the fusion")
            check([dd.content for dd, _ in res.web_docs] ==
                  [site.phrases[u[len(site.root):]] for u in web_urls[q] if "localhost" not in u],
                  "phase 12 (b): a fetched page's text")
        check("/never.html" not in site.hits, "phase 12 (b): a blocked domain was fetched")
        before = len(site.hits)
        t = time.perf_counter()
        again = o_web.run(web_q[0])
        t_cached = time.perf_counter() - t
        check(len(site.hits) == before and docs_of(again.web_docs) == docs_of(res_w[0].web_docs),
              "phase 12 (b): a repeated query fetched again instead of hitting the TTL cache")
        numbers["web_search"] = {
            "runs": len(res_w), "ms_per_run_p50": _pct(walls_w, 0.5) * 1e3,
            "ms_per_run_p99": _pct(walls_w, 0.99) * 1e3, "pages_fetched": before,
            "cache_hits": 1, "cached_run_ms": t_cached * 1e3,
            "web_docs_in_fusion": sum(len(r.web_docs) for r in res_w)}
        log(f"phase 12 (b) web search: {json.dumps(numbers['web_search'])}; blocked domain "
            f"skipped; launches {d_w}")

        # (d) the reports of one run, and a search report
        res = res_l[0]
        t = time.perf_counter()
        report = QueryReport.from_pipeline_result(res)
        for ext in ("md", "html", "json", "txt"):
            report.save(str(d / f"phase12_report.{ext}"))
        hits = app.search(english[questions[0]], use_cache=False)
        save_search_report(english[questions[0]], hits, str(d / "phase12_search.md"))
        t_reports = time.perf_counter() - t
        import html as html_mod

        saved = {ext: (d / f"phase12_report.{ext}").read_text() for ext in ("md", "html", "json",
                                                                          "txt")}
        check(json.loads(saved["json"])["answer"] == res.answer and res.answer in saved["md"]
              and res.answer in saved["txt"]
              and html_mod.escape(res.answer).replace("\n", "<br>") in saved["html"],
              "phase 12 (d): a report lacks the answer")
        check((d / "phase12_search.md").read_text().startswith("# Search report"))
        numbers["reports_ms"] = t_reports * 1e3

        # (e) the metrics exporters: with its package an exporter records the
        # runs; without it (here: the package hidden) it raises naming it
        have, recorded = {}, {}
        for pkg, mod in (("prometheus_client", "prometheus_client"),
                         ("opentelemetry-sdk", "opentelemetry.sdk")):
            try:
                have[pkg] = importlib.util.find_spec(mod) is not None
            except ModuleNotFoundError:
                have[pkg] = False
        for flag, pkg, mod in (("prometheus_enabled", "prometheus_client", "prometheus_client"),
                               ("otel_enabled", "opentelemetry-sdk", "opentelemetry.sdk")):
            c = dataclasses.replace(base, metrics=dataclasses.replace(
                base.metrics, **{flag: True, "prometheus_port": 0}))
            hidden = {m: sys.modules.pop(m) for m in list(sys.modules)
                      if m == mod or m.startswith(mod + ".")}
            sys.modules[mod] = None  # the package missing
            try:
                orchestrator(c)
            except ImportError as exc:
                check(pkg in str(exc) and flag in str(exc), f"phase 12 (e): {exc}")
            else:
                raise AssertionError(f"phase 12 (e): {flag} without {pkg} did not raise")
            finally:
                del sys.modules[mod]
                sys.modules.update(hidden)
                BaseAgent.metrics_sink = None
            if not have[pkg]:
                continue
            try:
                o = orchestrator(c)
                exp = o.metrics_exporter
                if flag == "prometheus_enabled":
                    from prometheus_client import REGISTRY

                    o.run(web_q[0])
                    recorded[pkg] = REGISTRY.get_sample_value(
                        "radiant_tpu_agent_executions_total", {"agent": "planning"})
                    check(recorded[pkg] == 1.0, f"phase 12 (e): prometheus recorded {recorded}")
                else:
                    from radiant_rag_tpu_torch.agents.base_agent import AgentMetrics

                    with exp.trace_agent("probe", AgentMetrics(agent_name="probe")) as span:
                        recorded[pkg] = bool(span.is_recording())
                    check(recorded[pkg], "phase 12 (e): the OpenTelemetry span did not record")
            finally:
                BaseAgent.metrics_sink = None
        numbers["metrics_packages"] = have
        log(f"phase 12 (e) metrics export: packages here {json.dumps(have)}; with its package "
            f"an exporter records ({json.dumps(recorded)}); with the package hidden, "
            "enabling it raises ImportError naming the package")

        # (f) a torch.profiler trace of one agentic run, its phases annotated
        spans = []

        def annotated(event, step, info):
            if event == "step_start":
                spans.append(annotate(f"phase.{step}"))
                spans[-1].__enter__()
            elif event == "step_end" and spans:
                spans.pop().__exit__(None, None, None)

        trace_dir = d / "phase12_trace"
        with profiler_trace(str(trace_dir)):
            prof_res, d_p, _ = drive(lambda: app.query(questions[-1] + " in the trace",
                                                       use_cache=False, progress=annotated))
        check(prof_res.success, "phase 12 (f): the profiled run failed")
        raw = (trace_dir / "trace.json").read_text()
        events = json.loads(raw)["traceEvents"]
        kernels = {}
        for e in events:
            if e.get("cat") == "kernel":
                name = re.sub(r"\(.*", "", e["name"].replace("(anonymous namespace)::", ""))
                kernels[name] = kernels.get(name, 0) + 1
        names = {e.get("name") for e in events}
        check(card.type != "cuda" or any("scan_topk_partial" in k for k in kernels),
              f"phase 12 (f): no scan kernel in the trace: {sorted(kernels)[:20]}")
        check({"phase.planning", "phase.retrieval", "phase.generation"} <= names,
              "phase 12 (f): the phase annotations are missing from the trace")
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
        q256 = [" ".join(texts[i].split()[:6]) + " timer"
                for i in np.random.default_rng(SEED + 12).integers(0, len(texts), 256)]
        ev = []
        dispatch = app._dispatch_fused

        def timed_dispatch(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = dispatch(*a, **kw)
            e1.record()
            ev.append((e0, e1))
            return out

        app._dispatch_fused = timed_dispatch
        try:
            timer, d_t, _ = drive(lambda: device_timer(
                lambda: app.search_batch(q256, use_cache=False), iters=5, warmup=1))
        finally:
            del app._dispatch_fused
        torch.cuda.synchronize()
        dev_ms = sorted(e0.elapsed_time(e1) for e0, e1 in ev[1:])
        ev_med = dev_ms[len(dev_ms) // 2]
        check(timer["median_ms"] >= ev_med, f"phase 12 (f): device_timer {timer} < CUDA events "
              f"{ev_med} ms")
        numbers["profile"] = {"trace_bytes": len(raw), "events": len(events),
                              "kernel_events": sum(kernels.values()), "kernels_by_name": top,
                              "device_timer_ms": timer, "cuda_events_ms_p50": ev_med,
                              "ratio": timer["median_ms"] / ev_med}
        log(f"phase 12 (f) profile of one app.query: {json.dumps(numbers['profile'])}; "
            f"device_timer of search_batch B=256 {timer['median_ms']:.2f} ms against CUDA events "
            f"{ev_med:.2f} ms around its device dispatch and fetch (ratio "
            f"{timer['median_ms'] / ev_med:.3f}); launches {d_p}")

        # (g) the template agent's MMR on the card over a run's fused docs
        agent = agent_template.TemplateDeviceOpAgent(store, models, lam=0.7,
                                                     device_stages=orch.device_stage)
        ctx = new_agent_context(res.query)
        ctx.fused_docs = list(res.fused_docs)
        t = time.perf_counter()
        picked = agent.run(ctx, top_k=MMR_K)
        torch.cuda.synchronize()
        t_mmr = time.perf_counter() - t
        vecs = np.asarray(models.embed([dd.content for dd, _ in ctx.fused_docs]), np.float32)
        qv = np.asarray(models.embed_single(res.query), np.float32)
        cpu = agent_template._mmr_select(torch.from_numpy(vecs), torch.from_numpy(qv), 0.7,
                                         MMR_K).tolist()
        on_card = agent_template._mmr_select(torch.from_numpy(vecs).to(card),
                                             torch.from_numpy(qv).to(card), 0.7, MMR_K)
        check(on_card.device.type == card.type and on_card.cpu().tolist() == cpu,
              "phase 12 (g): MMR picks on the card differ from the CPU's")
        check(picked.status.value == "success" and [dd.doc_id for dd, _ in picked.data] ==
              [ctx.fused_docs[i][0].doc_id for i in cpu], "phase 12 (g): the agent's picks")
        numbers["mmr_ms"] = t_mmr * 1e3
        log(f"phase 12 (g) TemplateDeviceOpAgent: {MMR_K} MMR picks of {len(ctx.fused_docs)} "
            f"fused docs in {t_mmr * 1e3:.2f} ms (embed included), equal to the CPU's")

        # (c) the crawled ingests, the app's calls then the routes
        app_cfg = app.config
        app.config = dataclasses.replace(app_cfg, web_crawler=dataclasses.replace(
            app_cfg.web_crawler, max_pages=128, rate_limit_delay_s=0.0))
        api0, raw0 = github_crawler.GitHubCrawler.API, github_crawler.GitHubCrawler.RAW
        github_crawler.GitHubCrawler.API = github_crawler.GitHubCrawler.RAW = site.root
        ids0 = set(store.list_doc_ids())
        try:
            t = time.perf_counter()
            st_urls = app.ingest_urls([site.root + "/"])
            st_gh = app.ingest_github("https://github.com/radiant/port")
            torch.cuda.synchronize()
            t_ing = time.perf_counter() - t
            n_site = len(site.site_pages("/"))
            check(st_urls["pages_crawled"] == n_site and st_urls["chunks_ingested"] == n_site,
                  f"phase 12 (c): ingest_urls {st_urls}")
            check(st_gh["files_fetched"] == len(GH_REPOS["port"]) and st_gh["chunks_ingested"],
                  f"phase 12 (c): ingest_github {st_gh}")

            # the routes beside /search clients (dense: a hybrid search
            # after each ingest would rebuild the BM25 tables, H3); each
            # served batch is held against search_batch under the lock
            server = make_server(app, "127.0.0.1", 0)
            port = server.server_address[1]
            serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
            serve_thread.start()
            coal = server.api._coalescer
            served_batches = []
            dispatch0 = coal.run_batch_async

            def held(key, items):
                with app.device_lock:
                    served = dispatch0(key, items)()
                    ref = app.search_batch(list(items), mode=key[0], top_k=key[1],
                                           use_cache=False)
                served_batches.append((list(items), served, ref, time.perf_counter()))
                return lambda: served

            coal.run_batch_async = held
            pool = list(dict.fromkeys(" ".join(texts[i].split()[:6]) + " host" for i in
                                      np.random.default_rng(SEED + 13).integers(0, len(texts),
                                                                                4096)))
            answers, errors, stop = {}, [], threading.Event()

            def client(c):
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                try:
                    i = c
                    while not stop.is_set() and i < len(pool):
                        conn.request("POST", "/search", json.dumps(
                            {"query": pool[i], "mode": "dense", "top_k": TOP_K}),
                            {"Content-Type": "application/json"})
                        resp = conn.getresponse()
                        answers[pool[i]] = (resp.status, json.loads(resp.read()),
                                            time.perf_counter())
                        i += HOST_CLIENTS
                except Exception as exc:  # reported below
                    errors.append(exc)
                finally:
                    conn.close()

            def post(path, body):
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                try:
                    conn.request("POST", path, json.dumps(body),
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    return resp.status, json.loads(resp.read())
                finally:
                    conn.close()

            clients = [threading.Thread(target=client, args=(c,), daemon=True)
                       for c in range(HOST_CLIENTS)]
            for th in clients:
                th.start()
            time.sleep(0.5)
            t = time.perf_counter()
            routes = {}
            posters = [threading.Thread(target=lambda: routes.setdefault(
                           "urls", post("/ingest/urls", {"urls": [site.root + "/b/"]}))),
                       threading.Thread(target=lambda: routes.setdefault(
                           "github", post("/ingest/github",
                                          {"url": "https://github.com/radiant/docs"})))]
            for th in posters:
                th.start()
            for th in posters:
                th.join(timeout=600)
            t_routes = time.perf_counter() - t
            time.sleep(0.5)
            stop.set()
            for th in clients:
                th.join(timeout=600)
            server.shutdown()
            server.server_close()
            server.api.close()
            serve_thread.join(timeout=30)
            check(not errors, f"phase 12 (c): /search clients failed: {errors[:3]}")
            n_b = len(site.site_pages("/b/"))
            check(routes["urls"][0] == 200 and routes["urls"][1]["pages_crawled"] == n_b,
                  f"phase 12 (c): /ingest/urls {routes['urls']}")
            check(routes["github"][0] == 200 and
                  routes["github"][1]["files_fetched"] == len(GH_REPOS["docs"]),
                  f"phase 12 (c): /ingest/github {routes['github']}")
            bad = 0
            by_query = {}
            for items, served, ref, _ in served_batches:
                for q_, a, b in zip(items, served, ref):
                    bad += docs_of(a) != docs_of(b)
                    by_query[q_] = docs_of(a)
            for q_, (status, body, _) in answers.items():
                got = [(h["doc_id"], h["score"]) for h in body["hits"]]
                bad += status != 200 or got != by_query.get(q_) or not got
            check(bad == 0 and answers, f"phase 12 (c): {bad} /search answers differ from "
                  "search_batch of their batch")
            during = sum(t <= a[2] <= t + t_routes for a in answers.values())

            # each page's phrase at rank 1 of one hybrid search_batch (the
            # first search after the ingests rebuilds the BM25 tables)
            pages = {**site.site_pages("/"), **site.site_pages("/b/")}
            phrases = list(pages.values())
            t = time.perf_counter()
            found, d_s, t_first = drive(lambda: app.search_batch(phrases, use_cache=False))
            check(d_s["int8_scan_topk"] > 0, d_s)
            miss = [p for p, hits_ in zip(phrases, found) if not hits_ or hits_[0][0].content != p]
            check(not miss, f"phase 12 (c): {len(miss)} of {len(phrases)} pages not at rank 1: "
                  f"{miss[:3]}")
            _, _, t_again = drive(lambda: app.search_batch(phrases, use_cache=False))
            new_ids = [i for i in store.list_doc_ids() if i not in ids0]
            sources = {store.get_doc(i).meta.get("source") for i in new_ids}
            want = {site.root + p for p in pages} | {
                f"{site.root}/radiant/{name}/main/{p}" for name, paths in GH_REPOS.items()
                for p in paths}
            check(sources == want, f"phase 12 (c): the ingested sources differ: "
                  f"{sorted(sources ^ want)[:4]}")
        finally:
            app.config = app_cfg
            github_crawler.GitHubCrawler.API, github_crawler.GitHubCrawler.RAW = api0, raw0
        n_new = len(new_ids)
        chunks = st_urls["chunks_ingested"] + st_gh["chunks_ingested"]
        numbers["ingest"] = {
            "pages_crawled": st_urls["pages_crawled"] + n_b, "files_fetched":
            st_gh["files_fetched"] + len(GH_REPOS["docs"]), "docs_added": n_new,
            "app_calls_s": t_ing, "chunks_per_s": chunks / t_ing,
            "routes_s": t_routes, "search_answers": len(answers),
            "search_answers_during_routes": during, "served_batches": len(served_batches),
            "bm25_rebuild_and_first_search_s": t_first, "hybrid_search_s_after": t_again,
            "pages_at_rank_1": len(phrases) - len(miss)}
        log(f"phase 12 (c) crawled ingest: {json.dumps(numbers['ingest'])}; {smi}")

        # (d) the CLI in subprocesses over a small data dir, configured by
        # RADIANT_* environment overrides, as the README configures a server
        cli = d / "phase12_cli"
        (cli / "docs").mkdir(parents=True, exist_ok=True)
        for i in range(3):
            (cli / "docs" / f"n{i}.txt").write_text(" ".join(texts[i].split()) + ". " +
                                                   web_phrase(f"cli{i}"))
        env = dict(os.environ, RADIANT_INDEX_DATA_DIR=str(cli / "index"),
                   RADIANT_BM25_INDEX_PATH=str(cli / "bm25.json.gz"),
                   RADIANT_LLM_BACKEND="mock", RADIANT_LOGGING_COLOR="false",
                   RADIANT_CONVERSATION_DATA_DIR=str(cli / "conv"),
                   RADIANT_STRATEGY_MEMORY_PATH=str(cli / "sm.json.gz"),
                   RADIANT_EMBEDDING_CHECKPOINT_DIR=str(cli / "ckpt"))
        base_cmd = [sys.executable, "-m", "radiant_rag_tpu_torch"]
        t = time.perf_counter()
        out = subprocess.run(base_cmd + ["ingest", str(cli / "docs")], cwd=repo, env=env,
                             capture_output=True, text=True, timeout=300)
        check(out.returncode == 0 and json.loads(out.stdout)["chunks_ingested"] > 0,
              f"phase 12 (d): ingest exited {out.returncode}: {out.stderr[-2000:]}")
        cmds = {"query": (base_cmd + ["query", web_phrase("cli1"), "--report",
                                      str(cli / "q.json")], None),
                "search": (base_cmd + ["search", web_phrase("cli2"), "--save",
                                       str(cli / "s.md")], None),
                "tui": (base_cmd + ["tui"], f"{web_phrase('cli0')}\n\n")}
        procs = {k: subprocess.Popen(c, cwd=repo, env=env, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for k, (c, _) in cmds.items()}
        outs = {}
        try:
            for k, p in procs.items():
                outs[k] = p.communicate(input=cmds[k][1], timeout=300)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
        t_cli = time.perf_counter() - t
        for k, p in procs.items():
            check(p.returncode == 0, f"phase 12 (d): {k} exited {p.returncode}: "
                  f"{outs[k][1][-2000:]}")
        check(json.loads((cli / "q.json").read_text())["query"] == web_phrase("cli1")
              and web_phrase("cli2") in (cli / "s.md").read_text()
              and "query>" in outs["tui"][0], "phase 12 (d): the CLI's outputs")
        numbers["cli_s"] = t_cli
        numbers["ui_packages"] = {m: importlib.util.find_spec(m) is not None
                                  for m in ("rich", "textual")}
        log(f"phase 12 (d) reports: .md .html .json .txt and a search report in "
            f"{t_reports * 1e3:.2f} ms; CLI ingest, then query --report, search --save and tui "
            f"(two lines on stdin) in parallel: all exit 0 in {t_cli:.1f} s; UI packages here "
            f"{json.dumps(numbers['ui_packages'])}")

        # (d) the Textual frontend, headless, over this app: one query
        # submitted through its input, every tab read back, ctrl+s's report
        if numbers["ui_packages"]["textual"]:
            import textual

            q_tui = questions[0] + " in the TUI"
            (session, tabs, timeline, saved_tui), d_t, t_tui = drive(
                lambda: drive_textual_tui(app, q_tui, d / "phase12_tui"))
            check(session.error is None and session.result is not None
                  and session.result.success, f"phase 12 (d): the Textual run failed: "
                  f"{session.error}")
            check(f"Q: {q_tui}" in tabs["overview"] and all(
                tabs[n].strip() and tabs[n] != "(no result yet)" for n in tabs),
                  f"phase 12 (d): the Textual tabs: {json.dumps(tabs)[:2000]}")
            check(timeline.strip() and len(saved_tui) == 1
                  and saved_tui[0].read_text() == session.report_markdown(),
                  f"phase 12 (d): the Textual timeline or ctrl+s report: {timeline!r} "
                  f"{saved_tui}")
            numbers["textual_tui"] = {"version": getattr(textual, "__version__", "?"),
                                      "query_s": t_tui, "tabs": len(tabs)}
            log(f"phase 12 (d) Textual TUI (textual {numbers['textual_tui']['version']}, "
                f"headless pilot): one query in {t_tui:.2f} s, {len(tabs)} tabs filled, "
                f"ctrl+s wrote {saved_tui[0].name}; launches {d_t}")
        else:
            log("phase 12 (d) Textual TUI: textual is not installed here; not driven")
    finally:
        site.close()
    numbers["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30 \
        if card.type == "cuda" else 0.0
    log("phase 12 summary: " + json.dumps({"device": smi, **numbers}, default=str))
    return launched


# phase 13: the transformers backends (llm.backend: local, the embedding
# backend, the VLM captioner) on the card
GEN_WORDS = ["<unk>", "<eos>", "User", "Assistant", "System", ":", "hello", "world", "what",
             "is", "a", "tpu", "the", "answer", "good"]
GEN_PROMPTS = [[{"role": "user", "content": "what is a tpu"}],
               [{"role": "system", "content": "be good"},
                {"role": "user", "content": "hello world"}],
               [{"role": "user", "content": "the answer is"}]]
GEN_TOKENS = 128  # tokens of the tokens/s timing
GEN_POSITIONS = 16384  # the tiny GPT-2's positions: an agentic prompt fits
EMB_TEXTS = ["hello world", "laser light", "the a hello", "world laser the light a"]
EMB_RTOL, EMB_ATOL = 1e-5, 1e-6


def tiny_transformers_models(d: Path, pil: bool):
    """The tests' tiny random-weight models, built here from seeds and saved
    under `d` (nothing comes from outside the repository): a 2-layer GPT-2
    with a word-level tokenizer (tests/test_local_llm.py; and one with
    GEN_POSITIONS positions, which an agentic prompt fits), a 1-layer
    BertModel (tests/test_local_llm.py), and with PIL a ViT -> GPT-2
    VisionEncoderDecoder (tests/test_image_captioner.py). Returns their
    directories."""
    import torch
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import (BertConfig as HFBertConfig, BertModel, GPT2Config, GPT2LMHeadModel,
                              PreTrainedTokenizerFast)

    def word_tokenizer(words, **special):
        tok = Tokenizer(WordLevel({w: i for i, w in enumerate(words)}, unk_token=words[0]))
        tok.pre_tokenizer = Whitespace()
        return PreTrainedTokenizerFast(tokenizer_object=tok, unk_token=words[0], **special)

    dirs = {"gpt2": d / "gpt2", "gpt2_long": d / "gpt2_long", "bert": d / "bert",
            "vlm": d / "vlm"}
    for name, positions in (("gpt2", 64), ("gpt2_long", GEN_POSITIONS)):
        torch.manual_seed(0)
        GPT2LMHeadModel(GPT2Config(vocab_size=len(GEN_WORDS), n_positions=positions, n_embd=32,
                                   n_layer=2, n_head=2, bos_token_id=1, eos_token_id=1)
                        ).eval().save_pretrained(str(dirs[name]))
        word_tokenizer(GEN_WORDS, eos_token="<eos>", pad_token="<eos>").save_pretrained(
            str(dirs[name]))
    torch.manual_seed(0)
    BertModel(HFBertConfig(vocab_size=60, hidden_size=32, num_hidden_layers=1,
                           num_attention_heads=2, intermediate_size=64,
                           max_position_embeddings=64)).eval().save_pretrained(str(dirs["bert"]))
    word_tokenizer(["[UNK]", "[PAD]", "hello", "world", "laser", "light", "a", "the"],
                   pad_token="[PAD]").save_pretrained(str(dirs["bert"]))
    if not pil:
        return dirs
    from transformers import (ViTConfig, ViTImageProcessor, VisionEncoderDecoderConfig,
                              VisionEncoderDecoderModel)

    vit = ViTConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                    intermediate_size=64, image_size=32, patch_size=16)
    gpt = GPT2Config(vocab_size=50, n_embd=32, n_layer=1, n_head=2, n_positions=32,
                     add_cross_attention=True, is_decoder=True, bos_token_id=0, eos_token_id=1,
                     pad_token_id=1)
    cfg = VisionEncoderDecoderConfig.from_encoder_decoder_configs(vit, gpt)
    cfg.decoder_start_token_id = 0
    cfg.pad_token_id = 1
    torch.manual_seed(0)
    VisionEncoderDecoderModel(cfg).eval().save_pretrained(str(dirs["vlm"]))
    ViTImageProcessor(size={"height": 32, "width": 32}).save_pretrained(str(dirs["vlm"]))
    word_tokenizer([f"tok{i}" for i in range(50)], bos_token="tok0", eos_token="tok1",
                   pad_token="tok1").save_pretrained(str(dirs["vlm"]))
    return dirs


def transformers_raises(d: Path, what: str):
    """Each transformers backend's error naming the missing package: the
    local generator's permanent LLMError, the embedding backend's and the
    VLM captioner's ImportError. Returns the three messages."""
    from radiant_rag_tpu_torch.config import config_from_dict
    from radiant_rag_tpu_torch.ingestion.image_captioner import HuggingFaceVLMCaptioner
    from radiant_rag_tpu_torch.llm.backends import LLMError, create_llm_backend
    from radiant_rag_tpu_torch.llm.model_backends import TransformersEmbeddingBackend

    lines = []
    local = create_llm_backend(config_from_dict(
        {"llm": {"backend": "local", "model_path": str(d)}}).llm)
    for name, fn, err in (
            ("llm.backend local", lambda: local.chat([{"role": "user", "content": "hi"}]),
             LLMError),
            ("TransformersEmbeddingBackend", lambda: TransformersEmbeddingBackend(
                str(d)).embed(["hi"]), ImportError),
            ("HuggingFaceVLMCaptioner", lambda: HuggingFaceVLMCaptioner(str(d)), ImportError)):
        try:
            fn()
        except err as exc:
            check("transformers" in str(exc), f"{name} raised without naming the package: {exc}")
            if isinstance(exc, LLMError):
                check(exc.status == 400 and not exc.retryable, f"{name}: {exc.status}")
            lines.append(f"{name}: {type(exc).__name__}: {exc}")
        else:
            check(False, f"{name} ran without transformers")
    for line in lines:
        log(f"phase 13 ({what}) {line}")
    return lines


def phase_transformers(ck, main_path, app, questions, smi, d, card=None):
    """Phase 13: the transformers backends on the card. It reports which of
    `transformers`, `tokenizers`, PIL and torchvision are installed (the
    captioner loads the PIL image processor and needs no torchvision).
    Where they are, over tiny random-weight models built here (`tiny_transformers_models`): (a)
    `llm.backend: local` (`LocalTransformersLLMBackend`): greedy chat and
    chat_stream on the card in float32, token ids equal to the CPU run's,
    the stream equal to the chat, tokens/s in float32 and in float16 (the
    card's default load); (b) one `app.query` over phase 7's app with the
    local backend from `llm.backend: local` (it completes; the random
    generator's output degrades the agents); (c)
    `TransformersEmbeddingBackend` on the card against the CPU (float32,
    rtol 1e-5); (d) with PIL, the VLM captioner on the card against the
    CPU. Then, with transformers hidden, each backend's error naming it.
    Where transformers is missing, only those errors (not a pass of the
    backends). Returns the (kernel, D or W, k, B) shapes (b) launched."""
    import importlib
    import importlib.util

    import torch

    from radiant_rag_tpu_torch.config import LLMConfig, config_from_dict
    from radiant_rag_tpu_torch.llm.backends import create_llm_backend

    card = torch.device("cuda", 0) if card is None else torch.device(card)
    d = Path(d) / "phase13"
    d.mkdir(parents=True, exist_ok=True)
    found = {name: importlib.util.find_spec(name) is not None
             for name in ("transformers", "tokenizers", "PIL", "torchvision")}
    versions = {name: getattr(importlib.import_module(name), "__version__", "?")
                for name, ok in found.items() if ok}
    log(f"phase 13: installed {json.dumps(found)}, versions {json.dumps(versions)}")
    launched, numbers = set(), {"found": found, "versions": versions}
    if not (found["transformers"] and found["tokenizers"]):
        numbers["raises"] = transformers_raises(d, "transformers is not installed")
        log("phase 13: the transformers backends did not run (no transformers / tokenizers "
            "here); their errors name the package; not a pass of the backends")
        log("phase 13 summary: " + json.dumps({"device": smi, **numbers}))
        return launched
    from radiant_rag_tpu_torch.ingestion.image_captioner import create_captioner
    from radiant_rag_tpu_torch.llm.local_backend import (
        LocalTransformersLLMBackend, from_pretrained_dtype,
    )
    from radiant_rag_tpu_torch.llm.model_backends import TransformersEmbeddingBackend
    from transformers import AutoModelForCausalLM, AutoTokenizer

    t0 = time.perf_counter()
    dirs = tiny_transformers_models(d, found["PIL"])
    numbers["build_s"] = time.perf_counter() - t0

    # (a) the local generator: float32 on the card against the CPU, then fp16
    gdir = str(dirs["gpt2"])
    tok = AutoTokenizer.from_pretrained(gdir)
    cpu_b = LocalTransformersLLMBackend(LLMConfig(backend="local", model_path=gdir,
                                                  device="cpu"))
    card_b = LocalTransformersLLMBackend(
        LLMConfig(backend="local", model_path=gdir, device=str(card)),
        model=AutoModelForCausalLM.from_pretrained(gdir, **from_pretrained_dtype(torch.float32)).to(card)
        .eval(), tokenizer=tok)
    gen = []
    for msgs in GEN_PROMPTS:
        text = card_b.chat(msgs, temperature=0.0, max_tokens=24)
        ref = cpu_b.chat(msgs, temperature=0.0, max_tokens=24)
        stream = list(card_b.chat_stream(msgs, temperature=0.0, max_tokens=24))
        prompt = tok(card_b._build_prompt(msgs), return_tensors="pt")
        ids = [b._model.generate(**{k: v.to(b._model.device) for k, v in prompt.items()},
                                 max_new_tokens=24, do_sample=False,
                                 pad_token_id=tok.pad_token_id)[0].cpu().tolist()
               for b in (card_b, cpu_b)]
        check(ids[0] == ids[1], f"(a) greedy ids differ on the card: {ids}")
        check(text == ref and text.strip(), f"(a) chat {text!r} vs the CPU's {ref!r}")
        check("".join(stream).split() == text.split(), f"(a) stream {stream} vs chat {text!r}")
        gen.append({"text": text, "new_ids": len(ids[0]) - prompt["input_ids"].shape[1],
                    "chunks": len(stream)})
    log(f"phase 13 (a) local generator, float32 on {card} against the CPU: greedy ids, chat "
        f"and stream equal: {json.dumps(gen)}")

    def tokens_per_s(backend, what):
        prompt = tok(backend._build_prompt(GEN_PROMPTS[0]), return_tensors="pt")
        inputs = {k: v.to(backend._model.device) for k, v in prompt.items()}
        kw = dict(max_new_tokens=GEN_TOKENS, min_new_tokens=GEN_TOKENS, do_sample=False,
                  pad_token_id=tok.pad_token_id)
        backend._model.generate(**inputs, **kw)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = backend._model.generate(**inputs, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        n = out.shape[1] - inputs["input_ids"].shape[1]
        check(n == GEN_TOKENS, f"{what}: {n} tokens")
        return n / dt

    # timed on the long model (GEN_TOKENS pass the short one's positions)
    long_dir = str(dirs["gpt2_long"])
    card_long = LocalTransformersLLMBackend(
        LLMConfig(backend="local", model_path=long_dir, device=str(card)),
        model=AutoModelForCausalLM.from_pretrained(long_dir, **from_pretrained_dtype(torch.float32)).to(card)
        .eval(), tokenizer=tok)
    fp16 = create_llm_backend(config_from_dict({"llm": {"backend": "local",
                                                        "model_path": long_dir}}).llm)
    t = time.perf_counter()
    fp16_text = fp16.chat(GEN_PROMPTS[0], temperature=0.0, max_tokens=24)
    load_s = time.perf_counter() - t
    check(fp16._model.dtype == torch.float16 and fp16._model.device.type == card.type,
          f"(a) the default load: {fp16._model.dtype} on {fp16._model.device}")
    numbers["a"] = {"greedy": gen, "fp16_text": fp16_text, "fp16_load_and_chat_s": load_s,
                    "tokens_per_s_float32": tokens_per_s(card_long, "float32"),
                    "tokens_per_s_float16": tokens_per_s(fp16, "float16")}
    log(f"phase 13 (a) tokens/s at {GEN_TOKENS} new tokens, one prompt: float32 "
        f"{numbers['a']['tokens_per_s_float32']:.1f}, float16 (llm.device default) "
        f"{numbers['a']['tokens_per_s_float16']:.1f}; the fp16 load + first chat {load_s:.2f} s")

    # (b) one app.query with llm.backend: local, over phase 7's app
    local_cfg = config_from_dict({"llm": {"backend": "local",
                                          "model_path": str(dirs["gpt2_long"]),
                                          "max_tokens": 16, "temperature": 0.0,
                                          "max_retries": 0}}).llm
    client = app.llm
    saved, calls0 = (client.config, client.backend), client.call_count
    client.config, client.backend = local_cfg, create_llm_backend(local_cfg)
    try:
        check(type(client.backend).__name__ == "LocalTransformersLLMBackend", client.backend)
        q = questions[0] + " (local generator)"
        res, d_q, t_q = main_path(lambda: app.query(q, use_cache=False))
        launched.update(ck.launches_by_shape)
    finally:
        client.config, client.backend = saved
    check(isinstance(res.answer, str) and res.fused_docs, f"(b) app.query: {res.to_dict()}")
    numbers["b"] = {"s": t_q, "success": res.success, "answer_chars": len(res.answer),
                    "fused_docs": len(res.fused_docs), "degraded": res.degraded,
                    "warnings": res.warnings[:8], "llm_calls": client.call_count - calls0,
                    "launches": d_q}
    log(f"phase 13 (b) app.query with llm.backend local: {t_q:.2f} s, "
        f"{json.dumps(numbers['b'], default=str)}")

    # (c) the embedding backend: the card (its default) against the CPU
    emb_card = TransformersEmbeddingBackend(str(dirs["bert"]), batch_size=2)
    emb_cpu = TransformersEmbeddingBackend(str(dirs["bert"]), batch_size=2, device="cpu")
    check(emb_card.device.type == card.type, emb_card.device)
    got, ref = emb_card.embed(EMB_TEXTS), emb_cpu.embed(EMB_TEXTS)
    gap = float(np.max(np.abs(got - ref)))
    log(f"phase 13 (c) TransformersEmbeddingBackend on {emb_card.device} against the CPU: "
        f"shape {got.shape}, max |diff| {gap:.3e} (tol rtol {EMB_RTOL}, atol {EMB_ATOL})")
    check(np.allclose(got, ref, rtol=EMB_RTOL, atol=EMB_ATOL), f"(c) embeddings differ: {gap}")
    numbers["c"] = {"max_abs_diff": gap, "shape": list(got.shape)}

    # (d) the VLM captioner (PIL): the card against the CPU
    if found["PIL"]:
        from PIL import Image

        from radiant_rag_tpu_torch.ingestion.image_captioner import HuggingFaceVLMCaptioner

        try:
            cap_card = HuggingFaceVLMCaptioner(str(dirs["vlm"]))
        except ImportError as exc:  # a package the checkpoint's processor needs
            numbers["d"] = {"raise": f"{type(exc).__name__}: {exc}"}
            log(f"phase 13 (d) VLM captioner: it raises here, naming what is missing: "
                f"{type(exc).__name__}: {' '.join(str(exc).split())}; not a pass of the "
                "captioner")
        else:
            cap_cpu = HuggingFaceVLMCaptioner(str(dirs["vlm"]), device="cpu")
            check(next(cap_card.model.parameters()).device.type == card.type, cap_card.device)
            check(type(create_captioner(str(dirs["vlm"]))).__name__ == "HuggingFaceVLMCaptioner",
                  "create_captioner did not take the checkpoint")
            caps = []
            for seed, size in ((0, (32, 32)), (1, (48, 20)), (2, (64, 64))):
                arr = (np.random.default_rng(seed).random((size[1], size[0], 3)) * 255).astype(
                    "uint8")
                path = d / f"img_{seed}.png"
                Image.fromarray(arr).save(path)
                got_c, ref_c = cap_card.caption(str(path)), cap_cpu.caption(str(path))
                check(got_c == ref_c, f"(d) caption {got_c!r} vs the CPU's {ref_c!r}")
                caps.append(got_c)
            numbers["d"] = {"captions": caps}
            log(f"phase 13 (d) VLM captioner on the card: captions equal the CPU's: {caps}")
    else:
        log("phase 13 (d) VLM captioner: PIL is not installed here; not run")

    # with transformers hidden, each backend names it
    hidden = {k: sys.modules.pop(k) for k in list(sys.modules)
              if k == "transformers" or k.startswith("transformers.")}
    sys.modules["transformers"] = None
    try:
        numbers["raises"] = transformers_raises(d, "transformers hidden")
    finally:
        del sys.modules["transformers"]
        sys.modules.update(hidden)
    numbers["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("phase 13 summary: " + json.dumps({"device": smi, **numbers}, default=str))
    return launched


def modes(argv) -> int:
    """No arguments: the whole run (`main`). `--step-launches ROOT`: the
    (1, 1) training step's launches of the package under ROOT;
    `--cards`: phase 9 (d) alone; `--nccl-merge ADDR WORLD RANK`: one rank
    of (d)'s NCCL merge. Each needs a card."""
    if not argv:
        return main()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if argv[0] == "--step-launches" and len(argv) == 2:
        return step_launch_probe(argv[1])
    if argv == ["--cards"]:
        return cards_only()
    if argv[0] == "--nccl-merge" and len(argv) == 4:
        return nccl_merge_worker(argv[1], int(argv[2]), int(argv[3]))
    print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    try:
        sys.exit(modes(sys.argv[1:]))
    except Exception as exc:  # any failed phase: no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
