"""data_wait_ms: host ms per step that the training loop waited for its
next batch from the data path (the benchmark's span around the
prefetching iterator)."""


def read(ctx):
    waits = ctx.out.get("data_waits")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
