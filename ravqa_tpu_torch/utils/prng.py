"""The JAX package's PRNG key on the host, in numpy.

The JAX executors carry a threefry key (``jax.random.PRNGKey(seed)``, a
uint32[2]) and split it once per train step (``rng, sub =
jax.random.split(state.rng)``); a checkpoint stores it as
``rng.msgpack``. This module computes the same keys bit for bit, so the
port carries that key through its steps and writes the same file:

- ``threefry2x32``: the Threefry-2x32 block cipher, 20 rounds (Salmon et
  al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011), the
  function jax.random's threefry2x32 primitive computes;
- ``split``: jax.random.split under ``jax_threefry_partitionable`` (JAX's
  default): key i of n is threefry2x32(key, (hi, lo) of the 64-bit
  counter i);
- ``prng_key``: jax.random.PRNGKey(seed) as JAX makes it without x64:
  (0, seed mod 2**32).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words (x0, x1) (uint32 arrays of one
    shape) under key (two uint32 words)."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num) (partitionable threefry): uint32 (num, 2)."""
    counts = np.arange(num, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=1)


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) (jax_enable_x64 off): uint32 (2,)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)
