"""batch_fill: requests over padded rows of the window's dispatches, as
RetrievalServer.sizes records them, in %."""


def read(ctx):
    sizes = ctx.out.get("sizes")
    if not sizes:
        return None
    return 100.0 * sum(n for n, _ in sizes) / sum(p for _, p in sizes)
