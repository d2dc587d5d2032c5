"""One run of one cell: set-up, the measured window, the reference's check.

  set-up   inputs and weights from the seed on the device, the system built
           as the app builds it (pbcore/system.py), then each of the
           traffic's stages (`build`), the cell's own request shape warmed
           (`warmup_requests` requests); setup_s runs from the process's
           start to the first timed request
  window   a closed loop of `in_flight` requests for `seconds`, then drained;
           every request's latency runs from its dispatch to its results on
           the host; qps = queries completed / (last completion - start);
           peak_gib = torch.cuda.max_memory_allocated() after a reset at the
           start; with trace, torch.profiler records the window; torch's
           host work runs on one intra-op thread (`WINDOW_THREADS`)
  check    a sample of the finished requests (drawn from the seed) kept,
           the port's state freed, the reference built and each number of
           pbcore/judge.py (the stages' too) compared with the cell's limit
           (a number without a limit stops the run; a limit without a
           number is not correct); with `control`,
           the control (the reference one precision lower in the port's
           place) compared with the same limits (`control_correct`)
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pbcore import data, judge, spec, trace
from pbcore.system import System, capacity_of
from work import counts

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "radiant_rag_tpu")

# torch's intra-op threads while the window runs; set-up and the check keep
# the default (a thread a core). A parallel host operation of the serving
# loop waits for its slowest thread, and where the host's cores are shared
# that thread is often descheduled: on an H100 host with six busy processes
# beside the run, int8-text-b2048's p95 read 126-159 ms with the default
# pool and 119 ms with one thread.
WINDOW_THREADS = 1


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a per-layer metric reads (metrics/<name>.py `read(run)`)."""
    config: Dict
    traffic: Dict
    requests: int
    queries: int
    window_s: float
    trace: Optional[trace.TraceSummary]
    work: Dict  # stage -> work items of one request (work/counts.py)


@dataclasses.dataclass
class Outcome:
    line: Dict
    compare: Dict[str, Dict[str, float]]


def _merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: torch.device,
             t_start: float, overrides: Optional[Dict] = None, fault=None,
             control: bool = False) -> Outcome:
    cell = spec.Cell(name)
    config, traffic, limits = cell.config, cell.traffic, cell.limits
    if overrides:
        config = _merge(config, overrides.get("config", {}))
        traffic = _merge(traffic, overrides.get("traffic", {}))
    plan = counts.plan(config, traffic)
    stages = cell.stages()
    tracer = trace.Tracer(traced, trace.SPANS + tuple(s for st in stages for s in st.SPANS))

    # -- set-up -----------------------------------------------------------------
    params = data.model_params(config, seed, device)
    corpus = data.make_corpus(config, seed, device, params["embedder"])
    n_batches = data.batches_for(traffic, seconds) + int(traffic["warmup_requests"])
    queries = data.make_queries(traffic, corpus, seed, device, n_batches)
    system = System(config, traffic, corpus, params, device)
    for st in stages:
        st.build(system, config, traffic, seed, device)
    probe_embeddings = system.probe_embeddings
    corpus.vecs = params = None  # the system holds its own copies; the reference draws them again
    driver = cell.driver().Driver(system, queries, tracer)
    if fault is not None:
        fault(driver)
    warm = int(traffic["warmup_requests"])
    for w in range(warm):  # the last batches of the pool: the window never draws them
        driver.complete(driver.issue(n_batches - 1 - w))
    _sync(device)
    _settle(device)
    setup_s = time.perf_counter() - t_start

    # -- the window -------------------------------------------------------------
    rng = np.random.default_rng([seed & ((1 << 63) - 1), 11])
    pool = n_batches - warm
    keep = set(rng.choice(pool, size=min(pool, int(traffic["kept_requests"])),
                          replace=False).tolist())
    kept: Dict[int, Dict] = {}
    latencies: List[float] = []
    in_flight = int(traffic["in_flight"])
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    threads = torch.get_num_threads()
    torch.set_num_threads(WINDOW_THREADS)
    tracer.start()
    pending = collections.deque()
    issued = 0
    with tracer.span(trace.WINDOW):
        t0 = time.perf_counter()
        while True:
            if time.perf_counter() - t0 < seconds and issued < pool:
                ts = time.perf_counter()
                pending.append((issued, ts, driver.issue(issued)))
                issued += 1
                if len(pending) < in_flight:
                    continue
            if not pending:
                break
            i, ts, p = pending.popleft()
            out = driver.complete(p)
            latencies.append(time.perf_counter() - ts)
            if i in keep:
                kept[i] = out
        _sync(device)
        t1 = time.perf_counter()
    summary = tracer.stop()
    torch.set_num_threads(threads)
    window_peak = _peak(device)  # read before the reference allocates anything
    window_s = t1 - t0
    b = int(traffic["batch_size"])
    requests = len(latencies)
    run = Run(config=config, traffic=traffic, requests=requests, queries=requests * b,
              window_s=summary.window_s if summary else window_s, trace=summary,
              work=counts.per_request(config, traffic, stages))

    # -- the check --------------------------------------------------------------
    picks = sorted(rng.choice(sorted(kept), size=min(len(kept), int(traffic["judged_requests"])),
                              replace=False).tolist())
    nq = min(b, int(traffic["judged_queries"]))
    batches = []
    for i in picks:
        pick = np.sort(rng.choice(b, size=nq, replace=False))
        out = {k: _rows(v, pick) for k, v in kept[i].items()}
        batches.append(judge.Batch(texts=queries.texts[i], words=queries.words[i],
                                   vectors=queries.vectors[i] if queries.vectors else None,
                                   pick=pick, out=out))
    row_capacity = capacity_of(int(config["num_passages"]))
    del driver, system, kept
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    corpus.vecs = corpus.vecs_host.to(device)
    world = judge.World(config, traffic, plan, corpus, data.model_params(config, seed, device),
                        device, row_capacity, probe_embeddings, seed=seed, stages=stages)
    compare = _against(judge.judge_all(world, batches), limits)
    correct = bool(batches) and set(compare) == set(limits) and \
        all(c["value"] <= c["limit"] for c in compare.values())
    controls = None
    if control:
        controls = _against(judge.judge_all(world, batches, judge.CONTROL), limits)

    metrics: Dict[str, Dict] = {}
    if not traced:
        lat = sorted(latencies)
        values = {"qps": requests * b / window_s,
                  "p95_ms": _p95(lat) * 1e3,
                  "peak_gib": window_peak / 2**30,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m, reader in cell.metric_readers():
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    line = {"correct": correct, "attempted": issued * b, "failed": 0, "metrics": metrics,
            "device": dev}
    if traced and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.top_ops(10),
                             "idle_gaps": [[g.label, g.seconds] for g in summary.gaps[:10]]}
    line["calibration"] = world.calibration
    if controls is not None:
        line["control"] = controls
        line["control_correct"] = all(c["value"] <= c["limit"] for c in controls.values())
    line["compare"] = compare
    return Outcome(line=line, compare=compare)


def _against(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number with no limit is an error."""
    unlimited = sorted(set(numbers) - set(limits))
    if unlimited:
        raise KeyError(f"numbers judged without a limit in the cell's limits file: {unlimited}")
    return {k: {"value": v, "limit": float(limits[k])} for k, v in sorted(numbers.items())}


def _rows(v, pick: np.ndarray):
    """An output stage restricted to the judged queries."""
    if isinstance(v, tuple):
        return tuple(_rows(x, pick) for x in v)
    if isinstance(v, torch.Tensor):
        return v[torch.from_numpy(pick).to(v.device)].float()
    return np.asarray(v)[pick]


def _p95(sorted_values: List[float]) -> float:
    """The 95th percentile by nearest rank."""
    if not sorted_values:
        return float("nan")
    idx = max(0, int(np.ceil(0.95 * len(sorted_values))) - 1)
    return sorted_values[idx]


def _settle(device: torch.device) -> None:
    """The end of set-up: the first full garbage collection over what set-up
    built (the BM25 index's per-doc term lists are tens of millions of
    tracked objects; left alone, that collection falls inside the window
    as a stall of seconds), and the harness's own freed device memory
    returned."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
