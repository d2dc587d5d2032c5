"""Device profiling: `torch.profiler` traces, the program's spans and
per-call device timing.

The port's counterpart of `radiant_rag_tpu/utils/profiling.py`, whose
`jax.profiler` trace becomes a `torch.profiler` one:

  * `profiler_trace(log_dir)` records the host's and (when the device is a
    card) CUDA activity of the enclosed region, with `gc_spans()`, and
    writes a Chrome trace, `<log_dir>/trace.json` (chrome://tracing,
    Perfetto), which holds each kernel launch under its name and every
    span. The profiler object is yielded, so a caller can read
    `key_averages()` too;
  * `annotate(name)` is the program's one span primitive. With no profiler
    running it is a shared null context: one flag check, no allocation.
    Under a profiler (`profiler_trace`, a benchmark's, an operator's own)
    it is a host range on the profiler's clock, on which Kineto also puts
    the device's activity. The range is an operator range
    (`torch._C._profiler._RecordFunctionFast`), not a user annotation
    (`record_function`): Kineto gives a user annotation a device row of
    its own spanning the kernels launched inside it, which a reader that
    counts the trace's device rows as kernels would count too; an
    operator range has no such row, and a kernel launched inside it finds
    it by launch time or by its linked correlation id. It also costs an
    eighth as much: 1.2 against 9.7 us a span under a CUDA profiler, and
    0.4 us with none (torch 2.11 on an H100 machine's host);
  * `gc_spans()` puts a span "gc" around each full (generation-2) garbage
    collection while a profiler runs;
  * `device_timer(fn)` is the median wall time of `fn()` with its first
    output copied to the host before the clock stops, as the JAX version
    fetches it, so queued device work cannot end the timing early.

The spans the program opens (`annotate` names): "embed.prep" (tokenize
and pad, `Embedder.embed_device`); "hybrid.prep", "hybrid.dense",
"hybrid.bm25" holding "hybrid.bm25.prep", "hybrid.fuse"
(`HybridSearcher.search_rows`); "rerank.prep" (`DeviceReranker.
rerank_rows`); "gc". A "*.prep" span is host work before a stage's
device work.

A profiler that fails to start raises (the JAX version logs and runs the
region unprofiled): a trace that was asked for is there or is an error.
"""

from __future__ import annotations

import gc
import logging
import os
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, Iterator

import torch

logger = logging.getLogger(__name__)

_NO_SPAN = nullcontext()
_profiling = torch._C._autograd._profiler_enabled


@contextmanager
def profiler_trace(log_dir: str = "./radiant_trace") -> Iterator[Any]:
    """Profile the enclosed region and write `<log_dir>/trace.json`, with
    the CUDA activity when a card is visible, and a span around each full
    garbage collection."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=False)
    prof.__enter__()
    logger.info("profiler trace -> %s", log_dir)
    try:
        with gc_spans():
            yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A span `name` while a profiler runs; else the shared null context."""
    if not _profiling():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


@contextmanager
def gc_spans() -> Iterator[None]:
    """While active, and only if a profiler runs on entry: a span "gc"
    around each generation-2 collection, from a `gc.callbacks` hook that
    is removed on exit. Generation 0 and 1 collections (hundreds a second,
    microseconds each) get none."""
    if not _profiling():
        yield
        return
    open_spans = []

    def hook(phase: str, info: Dict[str, int]) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            span = annotate("gc")
            span.__enter__()
            open_spans.append(span)
        elif open_spans:
            open_spans.pop().__exit__(None, None, None)

    gc.callbacks.append(hook)
    try:
        yield
    finally:
        gc.callbacks.remove(hook)


def _first_tensor(out: Any):
    """The first tensor of a (nested) output, as `jax.tree.leaves(out)[0]`."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def _materialize(out: Any) -> None:
    """The first output on the host: a tensor is copied there (waiting for
    the work that makes it); a host value is there already."""
    t = _first_tensor(out)
    if t is not None:
        t.cpu()


def device_timer(fn: Callable[[], Any], iters: int = 5, warmup: int = 1) -> Dict[str, float]:
    """Median wall time of a device program, its first output copied to the
    host before the clock stops."""
    for _ in range(warmup):
        _materialize(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        _materialize(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "median_ms": times[len(times) // 2] * 1000.0,
        "min_ms": times[0] * 1000.0,
        "max_ms": times[-1] * 1000.0,
        "iters": float(iters),
    }
