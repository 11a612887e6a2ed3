"""search_ms: device ms per dispatch of the kernels launched inside the
benchmark's range around the searcher's search_device."""


def read(ctx):
    if ctx.trace is None:
        return None
    secs, n = ctx.trace.by_range("pb.search")
    return 1e3 * secs / n if n and secs > 0 else None
