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

Imports no flax and no msgpack. The JAX package writes a params tree as
flax msgpack (``save_params``, and ``params.msgpack`` in a
``save_checkpoint`` directory); ``read_flax_msgpack`` decodes the subset
flax writes. A params ``.npz`` stores the same tree with flattened "a/b/c"
keys (``flatten_params``). ``load_params`` reads either into a state_dict.
"""

from __future__ import annotations

import re
import struct
import zipfile

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


# ---------------------------------------------------------------------------
# flax msgpack: the JAX package's checkpoint format
# ---------------------------------------------------------------------------

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """msgpack decoder for the subset flax.serialization writes: maps,
    arrays, str, bin, ints, floats, nil, bool, and ext type 1 (an ndarray
    packed as the msgpack array (shape, dtype name, C-order bytes)).
    Anything else raises ValueError."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", self.bin), 0xC5: ("H", self.bin),
                 0xC6: ("I", self.bin), 0xD9: ("B", self.str),
                 0xDA: ("H", self.str), 0xDB: ("I", self.str),
                 0xDC: ("H", self.array), 0xDD: ("I", self.array),
                 0xDE: ("H", self.map), 0xDF: ("I", self.map)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:                  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):            # ext 8, 16, 32
            return self.ext(self.unpack({0xC7: "B", 0xC8: "H",
                                         0xC9: "I"}[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by "
                         f"flax checkpoints")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError(
                "chunked msgpack array (flax writes arrays over 1 GB in "
                "chunks): not supported by this reader")
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack("b")
        payload = self.bin(n)
        if code != 1:
            raise ValueError(f"msgpack ext type {code} is not a flax "
                             f"ndarray (ext type 1)")
        shape, dtype, buf = _Reader(payload).value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode("ascii")
        if dtype == "bfloat16":                # bf16 bits -> float32
            bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(dtype))
        return arr.reshape(shape).copy()


def read_flax_msgpack(data: bytes):
    """Decode flax.serialization.to_bytes output (a params tree of nested
    str-keyed dicts with ndarray leaves) without flax or msgpack."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_params(path: str) -> dict[str, torch.Tensor]:
    """Read a params file into the port's state_dict: a flattened-key
    ``.npz``, or a flax msgpack params tree (the JAX package's
    ``save_params`` file or a ``save_checkpoint`` directory's
    ``params.msgpack``; a tree under a single "params" key is unwrapped)."""
    if zipfile.is_zipfile(path):
        return load_params_npz(path)
    with open(path, "rb") as f:
        tree = read_flax_msgpack(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a params tree")
    if set(tree) == {"params"} and isinstance(tree["params"], dict):
        tree = tree["params"]
    return flax_to_state_dict(tree)
