"""dispatch_idle_ms: ms per dispatch in which the device ran nothing
while the program's `serve.dispatch` span was open (the window's idle
gaps inside the dispatches that began in it)."""

from portbench import program


def read(ctx):
    return program.per_count(
        ctx, lambda p: 1e3 * p.idle_within("serve.dispatch"),
        "serve.dispatch")
