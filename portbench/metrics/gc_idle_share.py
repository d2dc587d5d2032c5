"""gc_idle_share: the share of the traced window that the device spent idle
in gaps which began while the host was inside a full garbage collection
(the program's "gc" span, which `Tracer` turns on). 0 where the window had
none; no reading where the program does not span its collections."""


def read(run):
    t = run.trace
    if t is None or not t.gc_spans or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return sum(g.seconds for g in t.gaps if "gc" in g.program) / t.window_s
