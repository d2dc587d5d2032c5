"""`trace.summarize` on synthetic profiler events: the cell's span set, the
program's nested spans, a garbage collection that opens an idle gap, and
spans it must not take."""

import dataclasses

import pytest
import torch

from pbcore import trace
from pbcore.readers import program_host_ms, program_span_ms

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
MAIN, OTHER = 1, 2


@dataclasses.dataclass
class Event:
    """The parts of a Kineto event that `summarize` reads."""
    _name: str
    _start: int
    _dur: int
    _corr: int = 0
    _linked: int = 0
    _device: object = CPU
    _thread: int = MAIN
    _scope: int = 0

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def device_type(self):
        return self._device

    def start_thread_id(self):
        return self._thread

    def scope(self):
        return self._scope


def annotation(name, start, dur, corr):
    """A `record_function` span: its host range and its device row."""
    return [Event(name, start, dur, corr, _scope=trace.USER_SCOPE),
            Event(name, start + 1, dur, corr, _device=CUDA)]


def kernel(name, launch, start, dur, corr, thread=MAIN):
    """A launch on the host and the kernel it put on the device."""
    return [Event("cudaLaunchKernel", launch, 2, corr, _thread=thread),
            Event(name, start, dur, corr, _device=CUDA)]


SET = trace.SPANS + ("generate",)


@pytest.fixture(scope="module")
def summary():
    ev = [Event(trace.WINDOW, 0, 10_000, 1, _scope=trace.USER_SCOPE)]
    # a stage's span from the cell's set, one kernel inside it
    ev += annotation("generate", 100, 900, 2)
    ev += kernel("decode_step", 150, 200, 300, 3)
    # the program's nested spans inside the harness's "search"
    ev += annotation("search", 1000, 1000, 4)
    ev += [Event("hybrid.bm25", 1100, 600, 5), Event("hybrid.bm25.prep", 1110, 100, 6)]
    ev += kernel("sketch_scan", 1150, 1300, 200, 7)  # inside both
    ev += kernel("rescore_topk", 1400, 1500, 100, 8)  # inside hybrid.bm25 alone
    # a garbage collection: the device idles from 1600 while the host collects
    ev += [Event("gc", 1590, 2000, 9)]
    ev += kernel("fuse_kernel", 3700, 3800, 100, 10)
    # a program span on another thread does not hold this thread's launches
    ev += [Event("hybrid.dense", 3600, 400, 11, _thread=OTHER)]
    # a record_function outside the cell's set, and torch's un-namespaced "detach"
    ev += [Event("other", 5000, 500, 12, _scope=trace.USER_SCOPE),
           Event("detach", 5010, 400, 13)]
    ev += kernel("late_kernel", 5100, 5200, 100, 14)
    return trace.summarize(ev, SET)


def op(s, name):
    (o,) = [o for o in s.ops if o.name == name]
    return o


def test_stage_span_from_the_cells_set(summary):
    assert op(summary, "decode_step").span == "generate"
    # the annotations' device rows are neither operations nor busy time
    assert {o.name for o in summary.ops} == {"decode_step", "sketch_scan", "rescore_topk",
                                              "fuse_kernel", "late_kernel"}
    assert summary.busy_s == pytest.approx((300 + 200 + 100 + 100 + 100) / 1e9)
    assert summary.kernels() == 5


def test_nested_program_spans(summary):
    assert op(summary, "sketch_scan").program == ("hybrid.bm25", "hybrid.bm25.prep")
    assert op(summary, "rescore_topk").program == ("hybrid.bm25",)
    assert op(summary, "sketch_scan").span == "search"
    assert summary.device_seconds(program="hybrid.bm25") == pytest.approx(300 / 1e9)
    assert summary.device_seconds(program="hybrid.bm25.prep") == pytest.approx(200 / 1e9)
    assert summary.device_seconds(program="hybrid.dense") == 0
    assert op(summary, "fuse_kernel").program == ()  # launched after the collection


def test_gc_span_opens_an_idle_gap(summary):
    (gap,) = [g for g in summary.gaps if "gc" in g.program]
    assert gap.seconds == pytest.approx((3800 - 1600) / 1e9)
    assert gap.span == "search" and gap.label == "search > hybrid.bm25 > gc"
    run = dataclasses.replace(summary, gc_spans=True)
    reader = _metric("gc_idle_share")
    assert reader.read(_Run(run)) == pytest.approx(2200 / 10_000)
    assert reader.read(_Run(dataclasses.replace(summary, gc_spans=False))) is None


def test_names_outside_the_set_are_no_spans(summary):
    late = op(summary, "late_kernel")
    assert late.span == "" and late.program == ()
    assert {s.name for s in summary.host_spans} == {"hybrid.bm25", "hybrid.bm25.prep", "gc",
                                                    "hybrid.dense"}


def test_host_time_less_gc(summary):
    run = _Run(summary)
    # "*.prep": 1110-1210, no collection inside it
    assert program_host_ms(run, lambda n: n.endswith(".prep"), ("gc",)) == \
        pytest.approx(100 / 1e6)
    # hybrid.bm25 (1100-1700) less the collection from 1590
    assert program_host_ms(run, lambda n: n == "hybrid.bm25", ("gc",)) == \
        pytest.approx(490 / 1e6)
    assert program_span_ms(run, "hybrid.bm25") == pytest.approx(300 / 1e6)
    assert program_span_ms(run, "hybrid.fuse") is None


def test_span_set_by_cell():
    """Out of the cell's set, a stage's span is no span: its device row
    counts as today, and its kernel falls under none."""
    ev = [Event(trace.WINDOW, 0, 1000, 1, _scope=trace.USER_SCOPE)]
    ev += annotation("generate", 100, 500, 2) + kernel("decode_step", 150, 200, 100, 3)
    s = trace.summarize(ev)
    assert op(s, "decode_step").span == ""
    assert "generate" in {o.name for o in s.ops}


@dataclasses.dataclass
class _Run:
    trace: trace.TraceSummary
    requests: int = 1


def _metric(name):
    from pbcore import spec

    return spec.load_module(spec.ROOT / "metrics" / f"{name}.py", f"test_metric_{name}")
