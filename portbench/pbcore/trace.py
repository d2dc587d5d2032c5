"""The traced run: torch.profiler over the measured window, read back.

Two kinds of span are read:

  harness spans  the harness wraps each call into a layer of the port in a
                 `record_function` span of its own: the cell's span set,
                 the built-in `SPANS` ("embed", "search", "fetch",
                 "rerank") and each of the cell's stages' `SPANS`;
                 "window" around the whole window. Kineto gives each a
                 device row of its own, which is no device operation and
                 is left out. A `record_function` name outside the set is
                 no span.
  program spans  the port's own `annotate` ranges (`utils/profiling.py`):
                 host operator ranges with lower-case dotted names
                 ("hybrid.dense", "hybrid.bm25.prep", "gc", and any later
                 name of that form), nested on the thread that opened
                 them; no device row. Torch records a few operators with
                 no namespace too ("detach"): an aten operator's name is
                 no program span.

Each device operation (kernel, copy, set) is matched to the host call that
launched it by the profiler's correlation id, and so to the harness span
the host was in and to the program spans open on the launching thread. The
summary keeps, per device operation: its name, duration, harness span and
program spans; the program spans as host intervals; the window's busy time
(the union of device intervals), and its idle gaps with the spans the host
was in when each began.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

SPANS = ("embed", "search", "fetch", "rerank")
WINDOW = "window"
PROGRAM_SPAN = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)*$")
USER_SCOPE = 7  # at::RecordScope::USER_SCOPE: a `record_function` annotation


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # kernel | memcpy | memset
    start_ns: int
    dur_ns: int
    span: str  # the harness span its launch was in, or "" if none
    program: Tuple[str, ...] = ()  # program spans open at its launch, outermost first


@dataclasses.dataclass
class HostSpan:
    """A program span on the host, clipped to the window."""
    name: str
    thread: int
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Gap:
    """An idle stretch of the device and what the host was in when it began."""
    span: str  # harness span, or "" if none
    program: Tuple[str, ...]  # program spans open then (on any thread)
    seconds: float

    @property
    def label(self) -> str:
        return " > ".join((self.span or "none",) + self.program)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: List[DeviceOp]
    gaps: List[Gap]  # longest first
    host_spans: List[HostSpan] = dataclasses.field(default_factory=list)
    gc_spans: bool = False  # the program spanned its full collections

    def device_seconds(self, span: Optional[str] = None, names=None,
                       program: Optional[str] = None) -> float:
        """Seconds of device operations launched under the harness span
        `span` (any when None) and inside the program span `program` (any
        when None) whose names contain one of `names` (any name when None)."""
        total = 0
        for op in self.ops:
            if span is not None and op.span != span:
                continue
            if program is not None and program not in op.program:
                continue
            if names is not None and not any(n in op.name for n in names):
                continue
            total += op.dur_ns
        return total / 1e9

    def host_seconds(self, keep: Callable[[str], bool], less: Sequence[str] = ()) -> float:
        """Seconds the host spent inside program spans whose names `keep`
        takes (overlaps counted once), less the part inside spans named in
        `less`, summed over threads."""
        total = 0
        for th in {s.thread for s in self.host_spans}:
            on = _union([(s.start_ns, s.end_ns) for s in self.host_spans
                         if s.thread == th and keep(s.name)])
            off = _union([(s.start_ns, s.end_ns) for s in self.host_spans
                          if s.thread == th and s.name in less])
            total += _measure(on) - _overlap(on, off)
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
    """Spans always; a profiler only when `enabled`. `spans` is the cell's
    span set (the built-ins and its stages')."""

    def __init__(self, enabled: bool, spans: Sequence[str] = SPANS) -> None:
        self.enabled = enabled
        self.spans = tuple(spans)
        self.prof = None
        self.gc = None

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
            self.gc = _program_gc_spans()
            if self.gc is not None:
                self.gc.__enter__()

    def stop(self) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        gc_spans = self.gc is not None
        if gc_spans:
            self.gc.__exit__(None, None, None)
            self.gc = None
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        summary = summarize(events, self.spans)
        if summary is not None:
            summary.gc_spans = gc_spans
        return summary


def _program_gc_spans():
    """The port's `gc_spans()` context (a span "gc" around each full
    collection while a profiler runs), where its tree has one."""
    from radiant_rag_tpu_torch.utils import profiling

    make = getattr(profiling, "gc_spans", None)
    return make() if make is not None else None


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


@functools.lru_cache(maxsize=None)
def _program_name(name: str) -> bool:
    """Named as the program names its spans, and not an aten operator."""
    return PROGRAM_SPAN.match(name) is not None and not hasattr(torch.ops.aten, name)


def _program(e, name: str) -> bool:
    """A program span: an operator range (not a `record_function`
    annotation) with a program span's name."""
    return e.scope() != USER_SCOPE and _program_name(name)


def _union(ivs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _measure(ivs: List[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in ivs)


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _open_at(spans: List[HostSpan], times: List[int]) -> List[Tuple[str, ...]]:
    """For each time of `times` (sorted), the names of the spans of `spans`
    (sorted by start) that hold it, outermost first."""
    out: List[Tuple[str, ...]] = []
    active: List[HostSpan] = []
    k = 0
    memo: Dict[Tuple[str, ...], Tuple[str, ...]] = {}
    for t in times:
        while k < len(spans) and spans[k].start_ns <= t:
            active.append(spans[k])
            k += 1
        active = [s for s in active if s.end_ns >= t]
        names = tuple(s.name for s in active)
        out.append(memo.setdefault(names, names))
    return out


def summarize(events, spans: Sequence[str] = SPANS) -> Optional[TraceSummary]:
    spans = set(spans)
    window = None
    harness: List[Tuple[int, int, str]] = []
    program: List[HostSpan] = []
    launches: Dict[int, Tuple[int, int]] = {}  # runtime correlation id -> (time, thread)
    ops_host: Dict[int, Tuple[int, int]] = {}  # host op correlation id -> (time, thread)
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name != WINDOW and name not in spans:  # not the annotations' device rows
                device.append(e)
            continue
        if name == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name in spans:
            harness.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif _runtime(name):
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        else:
            ops_host[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
            if _program(e, name):
                program.append(HostSpan(name, e.start_thread_id(), e.start_ns(),
                                        e.start_ns() + e.duration_ns()))
    if window is None:
        return None
    harness.sort()
    starts = [s for s, _, _ in harness]

    def span_at(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and harness[i][0] <= t <= harness[i][1]:
            return harness[i][2]
        return ""

    w0, w1 = window
    program = [HostSpan(s.name, s.thread, max(s.start_ns, w0), min(s.end_ns, w1))
               for s in program if s.end_ns >= w0 and s.start_ns <= w1]
    program.sort(key=lambda s: (s.start_ns, -s.end_ns))
    ops: List[DeviceOp] = []
    at: Dict[int, List[Tuple[int, int]]] = {}  # launching thread -> [(launch time, op index)]
    for e in device:
        s0, d = e.start_ns(), e.duration_ns()
        if d <= 0 or s0 + d < w0 or s0 > w1:
            continue
        host = launches.get(e.correlation_id())
        if host is None:
            host = ops_host.get(e.linked_correlation_id())
        if host is not None:
            at.setdefault(host[1], []).append((host[0], len(ops)))
        ops.append(DeviceOp(e.name(), _kind(e.name()), s0, d,
                            span_at(host[0]) if host is not None else ""))
    for th, launched in at.items():
        launched.sort()
        names = _open_at([s for s in program if s.thread == th], [t for t, _ in launched])
        for (_, i), open_spans in zip(launched, names):
            ops[i].program = open_spans
    if not ops:
        return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=0.0, ops=[], gaps=[],
                            host_spans=program)
    ivs = sorted((max(op.start_ns, w0), min(op.start_ns + op.dur_ns, w1)) for op in ops)
    busy, idle = 0, []  # idle: (host time it began, length)
    cur_s, cur_e = ivs[0]
    if cur_s > w0:
        idle.append((w0, cur_s - w0))
    for s0, e0 in ivs[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            idle.append((cur_e, s0 - cur_e))
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    if w1 > cur_e:
        idle.append((cur_e, w1 - cur_e))
    open_then = _open_at(program, [t for t, _ in idle])  # idle is in time order
    gaps = [Gap(span_at(t), names, ns / 1e9) for (t, ns), names in zip(idle, open_then)]
    gaps.sort(key=lambda g: -g.seconds)
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, ops=ops, gaps=gaps,
                        host_spans=program)
