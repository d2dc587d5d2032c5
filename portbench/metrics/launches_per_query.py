"""launches_per_query: kernel launches in the traced window per query
completed."""


def read(run):
    if run.trace is None or run.queries == 0 or run.trace.kernels() == 0:
        return None
    return run.trace.kernels() / run.queries
