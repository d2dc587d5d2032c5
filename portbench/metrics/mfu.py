"""mfu: the least time the chip needs for the window's counted work (every
stage of work/counts.py, at the published peaks), over the traced
window's length, in percent."""

from work import counts


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    least = sum(counts.least_seconds(items) for items in run.work.values())
    return least * run.requests / run.trace.window_s * 100.0
