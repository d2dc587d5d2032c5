#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `radiant_rag_tpu_torch/csrc` (nvcc, into
`build/kernels`), holds every kernel against its plain PyTorch version, then
drives the port's main path -- `HybridSearcher.search_rows` over a 1M-row
`DeviceVectorIndex` + `BM25Index` at B = 2048, k = 10, fused_k = 15, int8
dense mode -- through the BM25 sketch route (fused depth 0 and 40), the
block-max select, an auto-routed rare-term pages batch and fetch=False
pipelining, and checks the results. The corpus is synthetic, made from a
seed the way the JAX package's bench.py makes it (clustered 384-d vectors,
zipfian 48-token texts).

Prints the card's name and power limit, the phases' numbers, one
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA card, outside a checkout
of the repository, or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_DOCS = 1_000_000  # the bench's corpus; the engine rounds it to 2^20 rows
DIM = 384
BATCH = 2048
TOP_K = 10
FUSED_K = 15
FUSED_DEPTH = 40
N_BATCHES = 6
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: device memory rate
INT8_OPS_PER_S = 1.979e15  # H100 SXM: dense int8 tensor-core peak


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


def cuda_ms(fn, reps: int = 3) -> float:
    import torch

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


def bound_ms(n: int, d: int, b: int, out_elems: int) -> float:
    """Least time for the scan: each input read once, each output written
    once, against the int8 operations at the tensor-core peak."""
    moved = n * d + b * d + n + out_elems * 8
    ops = 2.0 * b * n * d
    return max(moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3


def check_kernel_pair(name, kernel, plain, args):
    """Kernel vs plain version on the same inputs: scores and rows equal."""
    import torch

    s, r = kernel(*args)
    torch.cuda.synchronize()
    ps, pr = plain(*args)
    if not torch.equal(r, pr):
        bad = int((r != pr).any(dim=1).sum())
        raise AssertionError(f"{name}: rows differ from the plain version in {bad} queries")
    err = float((s - ps).abs().max()) if s.numel() else 0.0
    if err != 0.0:
        raise AssertionError(f"{name}: scores differ from the plain version by {err}")
    return err


def phase_kernels(ck, shapes):
    """Main-path shapes: exact agreement and times. Launches made here are
    comparisons, not main-path launches (the counts are reset before the
    main path)."""
    import torch

    rows = []
    for label, codes, qi, mask, k in shapes:
        n, d = codes.shape
        b = qi.shape[0]
        if k:
            name, kern, plain = "int8_scan_topk", ck.int8_scan_topk, ck.int8_scan_topk_reference
            args = (codes, qi, mask, k)
            out_elems = b * k

            def library(codes=codes, qi=qi, k=k, mask=mask):
                sc = torch._int_mm(qi, codes.T)
                sc.masked_fill_(~mask[None, :], torch.iinfo(torch.int32).min)
                return torch.topk(sc, k, dim=1)
        else:
            name, kern, plain = "blockmax2", ck.blockmax2, ck.blockmax2_reference
            args = (codes, qi, mask)
            out_elems = b * 2 * (n // 512)

            def library(codes=codes, qi=qi, mask=mask):
                sc = torch._int_mm(qi, codes.T)
                sc.masked_fill_(~mask[None, :], torch.iinfo(torch.int32).min)
                return torch.topk(sc.view(sc.shape[0], -1, 512), 2, dim=2)
        err = check_kernel_pair(f"{name} [{label}]", kern, plain, args)
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=1)
        lib_ms = cuda_ms(library, reps=1)
        rows.append({
            "name": name, "shape": label, "route": "cuda",
            "source": f"radiant_rag_tpu_torch/csrc/{name}.cu",
            "replaces": ("radiant_rag_tpu/ops/pallas_kernels.py:315" if k else
                         "radiant_rag_tpu/ops/pallas_kernels.py:269"),
            "launches": 0, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms(n, d, b, out_elems),
            "bound_by": "operations", "library_ms": lib_ms,
        })
        log(f"kernel {name} [{label}]: {ms:.3f} ms (plain {plain_ms:.3f}, "
            f"library {lib_ms:.3f}, bound {rows[-1]['bound_ms']:.3f}), exact")
    return rows


def phase_edges(ck):
    """Edge shapes: ragged N, masked rows and a fully dead 512-row tile,
    forced ties (duplicated rows, narrow value range), B = 1."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(5000, 384, 33, 40, -127, 128), (5000, 1024, 1, 160, -2, 3),
             (70_000, 384, 70, 160, -1, 2), (3000, 64, 5, 256, -127, 128)]
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
    log(f"edge shapes: {len(cases)} cases x 2 kernels exact")


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
    out = {}
    for dev in ("cpu", "cuda"):
        eng = DeviceVectorIndex(DIM, initial_capacity=n, device=dev)
        eng.append(vecs, np.zeros(n, np.int8), np.zeros(n, np.int32), np.full(n, 48, np.float32))
        bm = BM25Index(device=dev)
        bm.bulk_build(list(range(n)), texts)
        hs = HybridSearcher(eng, bm)
        out[dev] = [hs.search_rows(q, qt, mode="int8", bm25_mode=route, fused_depth=fd,
                                   select=sel)
                    for route, fd, sel in (("sketch", 0, ""), ("sketch", FUSED_DEPTH, ""),
                                           ("pages", 0, ""), ("sketch", 0, "blockmax"))]
    for i, (a, c) in enumerate(zip(out["cpu"], out["cuda"])):
        for leg in ("dense", "bm25", "fused"):
            (ref_s, ref_r), (got_s, got_r) = a[leg], c[leg]
            np.testing.assert_allclose(got_s, ref_s, rtol=1e-5, atol=1e-6)
            # rows equal, except a swap of two rows whose CPU scores are tied
            # within that tolerance (the sums run in another order on the card)
            for q, slot in zip(*np.nonzero(ref_r != got_r)):
                other = np.nonzero(ref_r[q] == got_r[q, slot])[0]
                check(len(other) == 1 and got_r[q, other[0]] == ref_r[q, slot]
                      and abs(ref_s[q, slot] - ref_s[q, other[0]])
                      <= 1e-6 + 1e-5 * abs(ref_s[q, slot]),
                      f"small path run {i} {leg}: card rows differ from CPU, query {q}")
    log("small path: card == CPU plain path on 4 route/select variants")


def profile_batch(fn) -> None:
    """Device time by kernel and the device's idle share over one batch
    (torch.profiler, CUPTI). Measurement only: without device events it
    says "not measured" and the run goes on."""
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
        log("profile: no device events (device time not measured)")
        return
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
    log(f"profile (one sketch-route batch): wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms, idle share {max(0.0, 1 - busy / wall_us):.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {us / 1e3:9.3f} ms  {name[:110]}")


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
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")

    phase_edges(ck)
    torch.cuda.synchronize()
    small_path_check()
    torch.cuda.synchronize()

    from radiant_rag_tpu_torch.index.bm25 import BM25Index
    from radiant_rag_tpu_torch.index.engine import DeviceVectorIndex
    from radiant_rag_tpu_torch.index.hybrid import HybridSearcher
    from radiant_rag_tpu_torch.ops import quantize as qz
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
    chunk = 65536
    for s in range(0, N_DOCS, chunk):
        eng.append(vecs[s:s + chunk], np.zeros(min(chunk, N_DOCS - s), np.int8),
                   np.zeros(min(chunk, N_DOCS - s), np.int32),
                   np.full(min(chunk, N_DOCS - s), 48, np.float32))
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

    # phase 3 at the main path's own inputs: the dense leg's quantized
    # queries over the engine codes, the sketch leg's indicators over the sketch
    qb, tb = queries[:BATCH], qtexts[:BATCH]
    scale, _ = qz.int8_scale_offset(eng.i8_lo, eng.i8_hi)
    qi_dense, _ = quantize_queries(torch.from_numpy(qb.astype(np.float16).astype(np.float32)
                                                    ).cuda(), scale)
    qind = torch.from_numpy(bm.make_query_indicator(tb, bm.query_tids(tb))).cuda()
    mask = eng.valid.clone()
    shapes = [("dense D=384 k=40", eng.i8, qi_dense, mask, 4 * TOP_K),
              ("dense D=384 k=160", eng.i8, qi_dense, mask, 4 * FUSED_DEPTH),
              ("sketch S=1024 k=40", bm._sketch, qind, mask, 4 * TOP_K),
              ("sketch S=1024 k=160", bm._sketch, qind, mask, 4 * FUSED_DEPTH),
              ("dense D=384 blockmax", eng.i8, qi_dense, mask, 0),
              ("sketch S=1024 blockmax", bm._sketch, qind, mask, 0)]
    krows = phase_kernels(ck, shapes)
    del qi_dense, qind, mask
    torch.cuda.synchronize()

    # phase 4: the main path. Counts are set to 0 just before each run and
    # read just after; comparison launches above do not count.
    launches = {"int8_scan_topk": 0, "blockmax2": 0}

    def run(label, fn, n_batches):
        ck.int8_scan_topk.launches = 0
        ck.blockmax2.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        d_scan, d_bm = ck.int8_scan_topk.launches, ck.blockmax2.launches
        launches["int8_scan_topk"] += d_scan
        launches["blockmax2"] += d_bm
        log(f"{label}: {dt / n_batches * 1e3:.1f} ms/batch, {n_batches * BATCH / dt:.1f} QPS; "
            f"launches int8_scan_topk {d_scan}, blockmax2 {d_bm}")
        return out, d_scan, d_bm

    def batches(fd, select="", n=N_BATCHES):
        res = []
        for i in range(n):
            res.append(searcher.search_rows(
                queries[i * BATCH:(i + 1) * BATCH], qtexts[i * BATCH:(i + 1) * BATCH],
                dense_k=TOP_K, bm25_k=TOP_K, fused_k=FUSED_K, mode="int8",
                fused_depth=fd, select=select))
        return res

    torch.cuda.reset_peak_memory_stats()
    batches(0, n=1)  # warm-up (allocator, host caches)
    res0, d_scan, _ = run("sketch route, fused_depth 0", lambda: batches(0), N_BATCHES)
    check(d_scan == 2 * N_BATCHES, f"expected 2 scan launches per sketch batch, got {d_scan}")
    res40, d_scan, _ = run(f"sketch route, fused_depth {FUSED_DEPTH}",
                           lambda: batches(FUSED_DEPTH), N_BATCHES)
    check(d_scan == 2 * N_BATCHES)
    resbm, d_scan, d_bm = run("sketch route, select=blockmax",
                              lambda: batches(0, "blockmax", 2), 2)
    check(d_bm == 4 and d_scan == 0, (d_bm, d_scan))

    # a small rare-term batch the router sends to the exact pages route
    lengths = np.diff(bm._term_start)
    rare = [t for t in np.argsort(lengths, kind="stable") if lengths[t] > 0][:64]
    picks = rng.choice(np.asarray(rare), size=(16, 2), replace=False)
    rare_texts = [f"{bm.terms[a]} {bm.terms[c]}" for a, c in picks]
    check(bm.routes_pages(rare_texts, bm.query_tids(rare_texts), num_docs=eng.capacity))
    rq = queries[:16]
    resp, d_scan, d_bm = run("rare-term batch (B=16), auto route", lambda: searcher.search_rows(
        rq, rare_texts, dense_k=TOP_K, bm25_k=TOP_K, fused_k=FUSED_K, mode="int8"), 1)
    check(d_scan == 1 and d_bm == 0, "the rare-term batch did not take the pages route")
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

    respipe, d_scan, _ = run("fetch=False pipelined, fused_depth 0", pipelined, N_BATCHES)
    check(d_scan == 2 * N_BATCHES)
    peak = torch.cuda.max_memory_allocated()
    try:
        profile_batch(lambda: batches(0, n=1))
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
    ex_s, ex_rows = eng.search(queries[:BATCH], TOP_K, mode="exact")
    dense_rows = res0[0]["dense"][1]
    recall = float(np.mean([len(set(dense_rows[i]) & set(ex_rows[i])) / TOP_K
                            for i in range(BATCH)]))
    recall_bm = float(np.mean([len(set(resbm[0]["dense"][1][i]) & set(ex_rows[i])) / TOP_K
                               for i in range(BATCH)]))
    log(f"dense recall@10 vs exact: {recall:.4f} (fused scan), {recall_bm:.4f} (blockmax)")
    check(recall >= 0.9, recall)
    for i in range(64):  # the bm25 leg returns docs holding a query term
        words = set(qtexts[i].split())
        for r in res0[0]["bm25"][1][i]:
            if r >= 0:
                check(words & set(texts[r].split()), (i, r))
    torch.cuda.synchronize()

    for row in krows:
        row["launches"] = launches[row["name"]]
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")
    log(json.dumps({"kernels": krows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
