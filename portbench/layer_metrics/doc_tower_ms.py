"""doc_tower_ms: device ms per training step of the kernels launched
inside the program's `tower.doc` span (the doc tower's forward; its
backward runs inside `train.backward`)."""

from portbench import program


def read(ctx):
    return program.per_count(
        ctx, lambda p: 1e3 * p.device_within("tower.doc") or None,
        "train.step")
