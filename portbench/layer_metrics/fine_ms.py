"""fine_ms: device ms per dispatch of the kernels launched inside the
program's `search.fine` spans (a pruned search's exact re-score of its
candidates)."""

from portbench import program


def read(ctx):
    return program.per_count(
        ctx, lambda p: 1e3 * p.device_within("search.fine") or None,
        "serve.dispatch")
