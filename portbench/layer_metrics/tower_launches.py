"""tower_launches: kernels per dispatch launched inside the program's
`tower.query` span (the query tower, its children included), as the
device trace holds them."""

from portbench import program


def read(ctx):
    return program.per_count(
        ctx, lambda p: p.kernels_within("tower.query") or None,
        "serve.dispatch")
