"""Arithmetic the per-layer metric readers share (metrics/<name>.py).

A reader returns None where its trace holds nothing for it to read; the
harness then leaves the metric out of the line. A share of a roofline or
of a peak is never made up: no device time, no share.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional, Sequence

from work import counts

KERNELS = Path(__file__).resolve().parents[1] / "work" / "kernels"


def kernel_names(metric: str) -> List[str]:
    """Name fragments of the kernels a roofline metric times: every line of
    every work/kernels/<metric>/*.txt (a later kernel is a new file)."""
    names: List[str] = []
    for f in sorted((KERNELS / metric).glob("*.txt")):
        names += [ln.strip() for ln in f.read_text().splitlines()
                  if ln.strip() and not ln.startswith("#")]
    return names


def span_ms(run, span: str) -> Optional[float]:
    """Device milliseconds per request of the operations launched under a
    harness span."""
    if run.trace is None or run.requests == 0:
        return None
    s = run.trace.device_seconds(span=span)
    return s / run.requests * 1e3 if s > 0 else None


def program_span_ms(run, name: str) -> Optional[float]:
    """Device milliseconds per request of the operations launched inside
    the program span `name` (at any depth of nesting)."""
    if run.trace is None or run.requests == 0:
        return None
    s = run.trace.device_seconds(program=name)
    return s / run.requests * 1e3 if s > 0 else None


def program_host_ms(run, keep: Callable[[str], bool],
                    less: Sequence[str] = ()) -> Optional[float]:
    """Host milliseconds per request inside the program spans whose names
    `keep` takes, less the part inside spans named in `less`."""
    if run.trace is None or run.requests == 0:
        return None
    s = run.trace.host_seconds(keep, less)
    return s / run.requests * 1e3 if s > 0 else None


def roofline(run, stage: str, metric: str) -> Optional[float]:
    """Percent: the least time of a stage's counted work over the device
    time of the kernels named for the metric, per request."""
    items = run.work.get(stage) or []
    if run.trace is None or run.requests == 0 or not items:
        return None
    t = run.trace.device_seconds(names=kernel_names(metric)) / run.requests
    if t <= 0:
        return None
    return counts.least_seconds(items) / t * 100.0
