"""The traced run: torch.profiler over the measured window, read back.

The harness wraps each call into a layer of the port in a
`record_function` span of its own ("embed", "search", "fetch",
"rerank"; "window" around the whole window). Each device operation
(kernel, copy, set) is matched to the host call that launched it by the
profiler's correlation id, and so to the harness span the host was in. The
summary keeps, per device operation: its name, duration and span; and the
window's busy time (the union of device intervals), its idle gaps and the
span the host was in when each began.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

SPANS = ("embed", "search", "fetch", "rerank")
WINDOW = "window"


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # kernel | memcpy | memset
    start_ns: int
    dur_ns: int
    span: str  # the harness span its launch was in, or "" if none


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: List[DeviceOp]
    gaps: List[Tuple[str, float]]  # (span the host was in, idle seconds), longest first

    def device_seconds(self, span: Optional[str] = None, names=None) -> float:
        """Seconds of device operations launched under `span` (any span when
        None) whose names contain one of `names` (any name when None)."""
        total = 0
        for op in self.ops:
            if span is not None and op.span != span:
                continue
            if names is not None and not any(n in op.name for n in names):
                continue
            total += op.dur_ns
        return total / 1e9

    def kernels(self) -> int:
        return sum(1 for op in self.ops if op.kind == "kernel")

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0) + op.dur_ns
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]


class Tracer:
    """Spans always; a profiler only when `enabled`."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def start(self) -> None:
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()

    def stop(self) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        return summarize(events)


def _kind(name: str) -> str:
    """A device operation's kind by its name (the profiler names copies
    "Memcpy ..." and sets "Memset ...")."""
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _runtime(name: str) -> bool:
    """A host call into the CUDA runtime or driver (cudaLaunchKernel,
    cuLaunchKernel, cudaMemcpyAsync, ...)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def summarize(events) -> Optional[TraceSummary]:
    window = None
    spans: List[Tuple[int, int, str]] = []
    launches: Dict[int, int] = {}  # runtime correlation id -> launch time
    ops_host: Dict[int, int] = {}  # host op correlation id -> start time
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name != WINDOW and name not in SPANS:  # not the annotations' device rows
                device.append(e)
            continue
        if name == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name in SPANS:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif _runtime(name):
            launches[e.correlation_id()] = e.start_ns()
        else:
            ops_host[e.correlation_id()] = e.start_ns()
    if window is None:
        return None
    spans.sort()
    starts = [s for s, _, _ in spans]

    def span_at(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            return spans[i][2]
        return ""

    w0, w1 = window
    ops: List[DeviceOp] = []
    for e in device:
        s0, d = e.start_ns(), e.duration_ns()
        if d <= 0 or s0 + d < w0 or s0 > w1:
            continue
        t = launches.get(e.correlation_id())
        if t is None:
            t = ops_host.get(e.linked_correlation_id())
        ops.append(DeviceOp(e.name(), _kind(e.name()), s0, d,
                            span_at(t) if t is not None else ""))
    if not ops:
        return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=0.0, ops=[], gaps=[])
    ivs = sorted((max(op.start_ns, w0), min(op.start_ns + op.dur_ns, w1)) for op in ops)
    busy, gaps = 0, []
    cur_s, cur_e = ivs[0]
    prev_end = w0
    if cur_s > w0:
        gaps.append((span_at(w0), cur_s - w0))
    for s0, e0 in ivs[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            gaps.append((span_at(cur_e), s0 - cur_e))
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    prev_end = cur_e
    if w1 > prev_end:
        gaps.append((span_at(prev_end), w1 - prev_end))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, ops=ops,
                        gaps=[(name or "none", ns / 1e9) for name, ns in gaps])
