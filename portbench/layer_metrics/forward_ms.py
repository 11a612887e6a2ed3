"""forward_ms: device ms per training step of the kernels launched inside
the program's `train.forward` span (its children included)."""

from portbench import program


def read(ctx):
    return program.per_count(
        ctx, lambda p: 1e3 * p.device_within("train.forward") or None,
        "train.step")
