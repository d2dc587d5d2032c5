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

Prints the card's name and power limit, the phases' numbers, one
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA card, outside a checkout
of the repository, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
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
    texts = [" ".join(f"w{t}" for t in row) for row in zipf]
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
    library yardstick's operand (<s_q, s_c> = 32 W - 2 hamming)."""
    import torch

    n, w = codes.shape
    b = qwords.shape[0]
    qsign = ck.sign_matrix(qwords)

    def library_mm():
        sc = torch._int_mm(qsign, csign.T)
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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0]
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
        f"{busy / 1e3:.1f} ms, idle share {max(0.0, 1 - busy / wall_us):.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / 1e3:9.3f} ms  {name[:110]}")
    return max(0.0, 1 - busy / wall_us)


def exact_top10(vecs, q: np.ndarray, valid=None):
    """Recall oracle: exact fp32 cosine top-10, a plain matmul on the card
    in row chunks (off the path under test). `vecs`: host vectors, or an
    engine's device rows with their `valid` mask."""
    import torch

    qd = torch.from_numpy(q).cuda()
    best_s = torch.full((q.shape[0], TOP_K), -2.0, device="cuda")
    best_i = torch.full((q.shape[0], TOP_K), -1, dtype=torch.int64, device="cuda")
    step = 1 << 17
    for s in range(0, vecs.shape[0], step):
        v = vecs[s:s + step]
        sc = qd @ (torch.from_numpy(v).cuda() if isinstance(v, np.ndarray) else v).T
        if valid is not None:
            sc.masked_fill_(~valid[s:s + step][None, :], -3.0e38)
        cs, ci = torch.topk(sc, min(TOP_K, sc.shape[1]), dim=1)
        alls = torch.cat([best_s, cs], 1)
        alli = torch.cat([best_i, ci + s], 1)
        top = torch.topk(alls, TOP_K, dim=1).indices
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

    def main_path(fn):
        """Drive a main path once: every count set to 0 just before, read
        just after. Returns (its output, its launches by kernel, seconds)."""
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


def ce_flops(cfg, pairs: int, seq: int) -> float:
    """Operations of one cross-encoder forward over `pairs` packed pairs of
    `seq` tokens (padded pairs count as work done): 2 x the Dense weights
    per token and layer, 4 x seq x hidden per token and layer for the
    attention's two products, and the pooler and classifier on [CLS]."""
    h, ff = cfg.hidden_size, cfg.intermediate_size
    per_token_layer = 2 * (4 * h * h + 2 * h * ff) + 4 * seq * h
    return cfg.num_layers * pairs * seq * per_token_layer + 2 * pairs * (h * h + h)


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
    server.shutdown()
    server.server_close()
    server.api.close()
    serve_thread.join(timeout=30)
    check(not serve_thread.is_alive(), "the server thread did not stop")

    rows = serving_rows(ck, eng, bm, qdev2k, qt2k)
    known = set(known_keys) | {row["_key"] for row in rows}
    rows += agentic_rows(ck, eng, bm, qdev2k, qt2k, sorted(agentic_keys - known))
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


def agentic_rows(ck, eng, bm, qdev, qtexts_, keys):
    """Kernel rows at the (kernel, D or W, k, B) shapes phase 8 launched
    that no earlier row measured: the dense scans of the dense agent and of
    the multihop hops (host queries, kc = 4 x top_k), the sketch scan, and
    the rerank calibration's binary stage 1 at B = 64. Inputs as
    serving_rows takes them."""
    import torch

    from radiant_rag_tpu_torch.ops import quantize as qz
    from radiant_rag_tpu_torch.ops.similarity import quantize_queries

    qi, _ = quantize_queries(qdev, qz.int8_scale_offset(eng.i8_lo, eng.i8_hi)[0])
    qind = torch.from_numpy(bm.make_query_indicator(qtexts_, bm.query_tids(qtexts_))).cuda()
    qwords = qz.pack_binary(qdev)
    mask = eng.valid.clone()
    rows = []
    for name, width, k, b in keys:
        label = f"k={k} B={b} (agentic path)"
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
            raise AssertionError(f"phase 8 launched {name} at {(width, k, b)}, which no row "
                                 "covers")
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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
