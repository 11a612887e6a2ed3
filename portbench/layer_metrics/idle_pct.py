"""idle_pct: the share of the traced window in which no kernel, copy or
memset ran on the device, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    w = ctx.trace.window_s
    return 100.0 * (w - ctx.trace.busy_s()) / w
