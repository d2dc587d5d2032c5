"""Device profiling: `torch.profiler` traces and per-call device timing.

The port's counterpart of `radiant_rag_tpu/utils/profiling.py`, whose
`jax.profiler` trace becomes a `torch.profiler` one:

  * `profiler_trace(log_dir)` records the host's and (when the device is a
    card) CUDA activity of the enclosed region and writes a Chrome trace,
    `<log_dir>/trace.json` (chrome://tracing, Perfetto), which holds each
    kernel launch under its name and every `annotate` region. The profiler
    object is yielded, so a caller can read `key_averages()` too;
  * `annotate(name)` is a named region in such a trace
    (`torch.profiler.record_function`);
  * `device_timer(fn)` is the median wall time of `fn()` with its first
    output copied to the host before the clock stops, as the JAX version
    fetches it, so queued device work cannot end the timing early.

A profiler that fails to start raises (the JAX version logs and runs the
region unprofiled): a trace that was asked for is there or is an error.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator

logger = logging.getLogger(__name__)


@contextmanager
def profiler_trace(log_dir: str = "./radiant_trace") -> Iterator[Any]:
    """Profile the enclosed region and write `<log_dir>/trace.json`, with
    the CUDA activity when a card is visible."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=False)
    prof.__enter__()
    logger.info("profiler trace -> %s", log_dir)
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a profiler trace."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def _first_tensor(out: Any):
    """The first tensor of a (nested) output, as `jax.tree.leaves(out)[0]`."""
    import torch

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
