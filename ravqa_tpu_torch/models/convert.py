"""Carry the JAX package's Flax parameters into the port's modules.

A Flax params tree (nested dicts of numpy arrays, as
``jax.device_get(params)`` gives it) maps onto this package's
``state_dict`` by rule, because the port keeps the Flax module names:

- ``Dense.kernel`` is (in, out); ``nn.Linear.weight`` is its transpose;
- the attention ``DenseGeneral`` kernels: query/key/value are
  (hidden, heads, head_dim) and ``out`` is (heads, head_dim, hidden); they
  flatten to (hidden, hidden) first (the inverse of ravqa_tpu/models/
  bert.py:120-150), and their (heads, head_dim) biases flatten to (hidden,);
- ``Embed.embedding`` and ``LayerNorm.scale`` map to ``weight``;
- ``layer_<i>`` / ``dense_<i>`` become the ModuleList entries
  ``layers.<i>`` / ``dense.<i>``.

Imports no flax. A params ``.npz`` stores the same tree with flattened
"a/b/c" keys (``flatten_params``); ``load_params_npz`` reads it.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LIST_ENTRY = re.compile(r"^(layer|dense)_(\d+)$")
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
         "bias": "bias"}


def flatten_params(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _torch_key(path: list[str]) -> str:
    parts = []
    for p in path[:-1]:
        m = _LIST_ENTRY.match(p)
        parts.append(f"{'layers' if m.group(1) == 'layer' else 'dense'}."
                     f"{m.group(2)}" if m else p)
    if path[-1] not in _LEAF:
        raise KeyError(f"unknown Flax parameter {'/'.join(path)}")
    return ".".join(parts + [_LEAF[path[-1]]])


def _torch_value(path: list[str], a: np.ndarray) -> np.ndarray:
    leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
    if leaf == "kernel":
        if a.ndim == 3 and parent == "out":       # (heads, head_dim, hidden)
            a = a.reshape(-1, a.shape[-1])
        elif a.ndim == 3:                         # (hidden, heads, head_dim)
            a = a.reshape(a.shape[0], -1)
        return a.T
    if leaf == "bias":
        return a.reshape(-1)
    return a


def flax_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """JAX FLMR/BERT params tree (nested dicts or flattened "a/b/c" keys)
    -> the port's state_dict (float32 CPU tensors)."""
    flat = params if all(not isinstance(v, dict) for v in params.values()) \
        else flatten_params(params)
    sd = {}
    for key, value in flat.items():
        path = key.split("/")
        sd[_torch_key(path)] = torch.tensor(
            _torch_value(path, np.asarray(value, np.float32)))
    return sd


def load_params_npz(path: str) -> dict[str, torch.Tensor]:
    """Read a params .npz with flattened "a/b/c" keys into a state_dict."""
    with np.load(path) as z:
        return flax_to_state_dict({k: z[k] for k in z.files})
