"""qps: requests answered inside the window over the window's length
(host clock; the cells that BENCHMARK.json lists for it)."""


def read(ctx):
    return ctx.log.completed_in_window / ctx.window_s
