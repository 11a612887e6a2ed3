"""A digest of a checkpoint tree, for the tests and chip_smoke.py: one
sha256 says that two trees (the JAX package's and the port's, a saved
state and the state a load restores) hold the same leaves bit for bit.
Imports numpy alone, so that the card's machine, which has no jax, reads
it too."""

import hashlib

import numpy as np


def _leaves(tree: dict, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and v:
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def tree_digest(tree: dict) -> str:
    """sha256 over a checkpoint tree's leaves in key order: each path,
    dtype, shape and bytes, and each empty node."""
    h = hashlib.sha256()
    for keys, v in _leaves(tree):
        h.update("/".join(keys).encode() + b"\0")
        if isinstance(v, dict):
            h.update(b"{}")
        else:
            a = np.asarray(v)
            h.update(f"{a.dtype.str}{a.shape}".encode() + a.tobytes())
    return h.hexdigest()
