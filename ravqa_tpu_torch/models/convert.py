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
  ``layers.<i>`` / ``dense.<i>``;
- the ViT's bare params ``class_embedding`` and ``position_embedding``
  keep their names, and its patch-embedding convolution kernel (kh, kw,
  in, out) becomes the unfold form's (out, kh * kw * in) weight
  (models/vit.py).

``state_dict_to_flax`` is the way back, so a tree the port trained loads
into the JAX package. The same pair carries the DPR dual encoder
(models/dpr.py: its ``query_encoder`` and ``item_encoder`` BertModels, one
head count each).

The offline extractors have their own one-way bridges:
``detector_to_state_dict`` (the AttrRCNN tree: conv kernels HWIO, grouped
(kh, kw, in / groups, out), -> OIHW; FrozenBN's folded scale and bias kept)
and ``captioner_to_state_dict`` (the OscarCaptioner tree by this rule,
plus its free LM bias; the decoder is tied to the word embeddings).

The RAG generators (T5Model, Blip2T5) have their own pair,
``generator_to_state_dict`` / ``generator_to_flax`` (T5's DenseGeneral
q/k/v (d_model, H, d_kv) and o (H, d_kv, d_model) kernels, the BLIP-2
patch kernel HWIO <-> OIHW, ``encoder_<i>`` / ``decoder_<i>`` stacks), and
their LoRA trees ``lora_to_torch`` / ``lora_to_flax``; ``rag_params_to_torch``
splits the JAX RagExecutor's tree.

Imports no flax and no msgpack. The JAX package writes a params tree as
flax msgpack (``save_params``, and ``params.msgpack`` in a
``save_checkpoint`` directory); ``read_flax_msgpack`` decodes the subset
flax writes and ``write_flax_msgpack`` writes it (nested str-keyed maps,
ndarrays as msgpack ext type 1), so the JAX package's ``load_params``
reads the port's ``params.msgpack``. A params ``.npz`` stores the same
tree with flattened "a/b/c" keys (``flatten_params``). ``load_params``
reads either into a state_dict.
"""

from __future__ import annotations

import math
import re
import struct
import zipfile

import numpy as np
import torch

_LIST_ENTRY = re.compile(r"^(layer|dense)_(\d+)$")
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
         "bias": "bias"}
_BARE = ("class_embedding", "position_embedding")      # the ViT's


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
    if path[-1] in _BARE:
        return ".".join(parts + [path[-1]])
    if path[-1] not in _LEAF:
        raise KeyError(f"unknown Flax parameter {'/'.join(path)}")
    return ".".join(parts + [_LEAF[path[-1]]])


def _torch_value(path: list[str], a: np.ndarray) -> np.ndarray:
    leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
    if leaf == "kernel":
        if a.ndim == 4:                           # (kh, kw, in, out) conv
            a = a.reshape(-1, a.shape[-1])
        elif a.ndim == 3 and parent == "out":     # (heads, head_dim, hidden)
            a = a.reshape(-1, a.shape[-1])
        elif a.ndim == 3:                         # (hidden, heads, head_dim)
            a = a.reshape(a.shape[0], -1)
        return a.T
    if leaf == "bias":
        return a.reshape(-1)
    return a


def flax_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """JAX FLMR/DPR/BERT params tree (nested dicts or flattened "a/b/c"
    keys) -> the port's state_dict (float32 CPU tensors)."""
    flat = params if all(not isinstance(v, dict) for v in params.values()) \
        else flatten_params(params)
    sd = {}
    for key, value in flat.items():
        path = key.split("/")
        sd[_torch_key(path)] = torch.tensor(
            _torch_value(path, np.asarray(value, np.float32)))
    return sd


_FLAX_LIST = {"layers": "layer", "dense": "dense"}
_ATTENTION = ("query", "key", "value", "out")
_ATTENTION_BLOCKS = ("attention", "cross_attention")


def _flax_path(key: str, value: torch.Tensor) -> list[str]:
    parts = key.split(".")
    path = []
    i = 0
    while i < len(parts) - 1:
        if parts[i] in _FLAX_LIST and parts[i + 1].isdigit():
            path.append(f"{_FLAX_LIST[parts[i]]}_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    leaf = parts[-1]
    if leaf in _BARE:
        return path + [leaf]
    if leaf == "weight":
        if value.ndim == 1:
            leaf = "scale"                          # LayerNorm
        elif path[-1].endswith("embeddings"):
            leaf = "embedding"                      # Embedding
        else:
            leaf = "kernel"                         # Linear
    elif leaf != "bias":
        raise KeyError(f"unknown parameter {key}")
    return path + [leaf]


def state_dict_to_flax(state_dict: dict, num_heads: dict[str, int]) -> dict:
    """The inverse of flax_to_state_dict: the port's state_dict -> a nested
    Flax params tree of float32 numpy arrays. num_heads gives the attention
    kernels and biases their (heads, head_dim) axes back, one count per
    top-level module (a key's first name), since the towers differ (a
    ViT-L's 16 heads beside BERT's 12)."""
    tree: dict = {}
    for key, t in state_dict.items():
        a = t.detach().to(device="cpu", dtype=torch.float32).numpy()
        path = _flax_path(key, t)
        parent, leaf = path[-2], path[-1]
        attention = len(path) > 2 and path[-3] in _ATTENTION_BLOCKS \
            and parent in _ATTENTION
        if attention:
            heads = num_heads[path[0]]
        if leaf == "kernel" and parent == "patch_embedding":
            side = math.isqrt(a.shape[1] // 3)      # (out, p * p * 3)
            a = a.T.reshape(side, side, 3, a.shape[0])  # (kh, kw, in, out)
        elif leaf == "kernel":
            a = a.T                                 # (in, out)
            if attention and parent == "out":
                a = a.reshape(heads, -1, a.shape[-1])
            elif attention:
                a = a.reshape(a.shape[0], heads, -1)
        elif leaf == "bias" and attention and parent != "out":
            a = a.reshape(heads, -1)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


# ---------------------------------------------------------------------------
# the RAG generators (T5Model, Blip2T5), their LoRA trees and the RAG tree
# ---------------------------------------------------------------------------

_GEN_LIST = re.compile(r"^(encoder|decoder|layer)_(\d+)$")
_GEN_BARE = ("class_embedding", "position_embedding", "query_tokens")


def _gen_torch_names(path: list[str]) -> list[str]:
    """Flax module names -> the port's: encoder_<i> / decoder_<i> ->
    encoder.<i> / decoder.<i>, layer_<i> -> layers.<i>."""
    names = []
    for p in path:
        m = _GEN_LIST.match(p)
        if m:
            names += ["layers" if m.group(1) == "layer" else m.group(1),
                      m.group(2)]
        else:
            names.append(p)
    return names


def _gen_flax_path(name: str) -> list[str]:
    """The inverse of _gen_torch_names, on a dotted module name."""
    parts = name.split(".") if name else []
    path = []
    i = 0
    while i < len(parts):
        if parts[i] in ("encoder", "decoder", "layers") \
                and i + 1 < len(parts) and parts[i + 1].isdigit():
            stem = "layer" if parts[i] == "layers" else parts[i]
            path.append(f"{stem}_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    return path


def generator_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's T5Model or Blip2T5 params tree (nested dicts of
    numpy arrays) -> the port's state_dict (float32 CPU tensors):
    T5's DenseGeneral q/k/v kernels (d_model, H, d_kv) and o (H, d_kv,
    d_model) flatten to Linear weights; Dense kernels transpose; the
    patch embedding's HWIO kernel becomes the Conv2d's OIHW; Embed
    tables, LayerNorm scales and RMSNorm weights map to `weight`; the
    class and position embeddings and the query tokens keep their names."""
    sd = {}
    for key, value in flatten_params(params).items():
        *path, leaf = key.split("/")
        names = _gen_torch_names(path)
        a = np.asarray(value, np.float32)
        if leaf in _GEN_BARE:
            sd[".".join(names + [leaf])] = torch.tensor(a)
            continue
        if leaf == "kernel":
            if a.ndim == 4:                       # (kh, kw, in, out)
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 3 and path[-1] == "o":  # (H, d_kv, d_model)
                a = a.reshape(-1, a.shape[-1]).T
            elif a.ndim == 3:                     # (d_model, H, d_kv)
                a = a.reshape(a.shape[0], -1).T
            else:
                a = a.T
        elif leaf not in ("scale", "embedding", "weight", "bias"):
            raise KeyError(f"unknown generator parameter {key}")
        sd[".".join(names + ["bias" if leaf == "bias" else "weight"])] = \
            torch.tensor(np.ascontiguousarray(a))
    return sd


def generator_to_flax(model: torch.nn.Module) -> dict:
    """The inverse of generator_to_state_dict: a T5Model's or Blip2T5's
    parameters -> the JAX package's params tree (float32 numpy), the
    attention kernels split by the T5 config's heads."""
    from .t5 import T5Attention
    nn = torch.nn
    modules = dict(model.named_modules())
    tree: dict = {}
    for name, m in modules.items():
        path = _gen_flax_path(name)
        parent = modules.get(name.rpartition(".")[0])
        for pname, p in m.named_parameters(recurse=False):
            a = p.detach().to(device="cpu", dtype=torch.float32).numpy()
            leaf = pname
            if isinstance(m, nn.Linear) and pname == "weight":
                leaf, a = "kernel", a.T
                if isinstance(parent, T5Attention):
                    h, d = parent.cfg.num_heads, parent.cfg.d_kv
                    a = (a.reshape(h, d, -1) if path[-1] == "o"
                         else a.reshape(a.shape[0], h, d))
            elif isinstance(m, nn.Conv2d) and pname == "weight":
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif isinstance(m, nn.LayerNorm) and pname == "weight":
                leaf = "scale"
            elif isinstance(m, nn.Embedding):
                leaf = "embedding"
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(a)
    return tree


def lora_to_torch(params: dict) -> dict:
    """The JAX package's LoRA tree (lora_a (in, r) / lora_b (r, out) leaves
    under the adapted kernel's path) -> the port's LoRA dict, keyed by the
    adapted Linear's weight name (models/lora.py)."""
    out: dict = {}
    for key, value in flatten_params(params).items():
        *path, leaf = key.split("/")
        if leaf not in ("lora_a", "lora_b"):
            raise KeyError(f"unknown LoRA parameter {key}")
        name = ".".join(_gen_torch_names(path) + ["weight"])
        out.setdefault(name, {})[leaf] = torch.tensor(
            np.asarray(value, np.float32))
    return out


def lora_to_flax(lora: dict) -> dict:
    """The inverse of lora_to_torch."""
    tree: dict = {}
    for name, entry in lora.items():
        node = tree
        for part in _gen_flax_path(name.rpartition(".")[0]):
            node = node.setdefault(part, {})
        for leaf, t in entry.items():
            node[leaf] = t.detach().to(device="cpu",
                                       dtype=torch.float32).numpy()
    return tree


def rag_params_to_torch(params: dict):
    """The JAX RagExecutor's params tree {"retriever": ..., "generator":
    gen} (LoRA merged, or none) or {"generator": {"base": gen, "lora":
    lora}} -> (the retriever's state_dict, the generator's, the LoRA dict
    or None)."""
    gen = params["generator"]
    lora = None
    if set(gen) == {"base", "lora"}:
        gen, lora = gen["base"], lora_to_torch(gen["lora"])
    return (flax_to_state_dict(params["retriever"]),
            generator_to_state_dict(gen), lora)


# ---------------------------------------------------------------------------
# the offline extractors: the VinVL detector and the Oscar captioner
# ---------------------------------------------------------------------------

def detector_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's AttrRCNN params tree (models/detection.py) ->
    the port's AttrRCNN state_dict: conv kernels (kh, kw, in / groups,
    out) -> OIHW (out, in / groups, kh, kw); Dense kernels transpose;
    the Embed table maps to `weight`; FrozenBN's folded (scale, bias) keep
    their names. Module paths are the same names joined by dots."""
    sd = {}
    for key, value in flatten_params(params).items():
        *path, leaf = key.split("/")
        a = np.asarray(value, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            leaf = "weight"
        elif leaf == "embedding":
            leaf = "weight"
        elif leaf not in ("scale", "bias"):
            raise KeyError(f"unknown detector parameter {key}")
        sd[".".join(path + [leaf])] = torch.tensor(np.ascontiguousarray(a))
    return sd


def captioner_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's OscarCaptioner params tree
    (models/captioner.py) -> the port's OscarCaptioner state_dict: the
    BERT embeddings, encoder and Dense layers by flax_to_state_dict's
    rule, and the LM head's free bias `mlm_bias` by name. The decoder is
    tied to the word embeddings in both, so it has no weight of its own."""
    params = dict(params)
    bias = params.pop("mlm_bias")
    sd = flax_to_state_dict(params)
    sd["mlm_bias"] = torch.tensor(np.asarray(bias, np.float32))
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


class _Writer:
    """msgpack encoder for what flax.serialization.to_bytes writes of a
    params tree: str-keyed maps, str, ints (an array's shape) and ndarrays
    as ext type 1 holding the msgpack array (shape, dtype name, C-order
    bytes). Anything else raises TypeError."""

    def __init__(self):
        self.out = bytearray()

    def head(self, n: int, fix: int, fix_max: int, codes) -> None:
        if n <= fix_max:
            self.out += struct.pack(">B", fix | n)
            return
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.out += struct.pack(">B" + fmt, code, n)
                return
        raise ValueError(f"msgpack length {n} is too large")

    def value(self, v) -> None:
        if isinstance(v, dict):
            self.head(len(v), 0x80, 15, ((0xDE, "H"), (0xDF, "I")))
            for k in sorted(v, key=str):           # flax sorts keys too
                self.value(str(k))
                self.value(v[k])
        elif isinstance(v, str):
            b = v.encode("utf-8")
            self.head(len(b), 0xA0, 31,
                      ((0xD9, "B"), (0xDA, "H"), (0xDB, "I")))
            self.out += b
        elif isinstance(v, bytes):
            self.head(len(v), 0, -1, ((0xC4, "B"), (0xC5, "H"), (0xC6, "I")))
            self.out += v
        elif isinstance(v, (list, tuple)):
            self.head(len(v), 0x90, 15, ((0xDC, "H"), (0xDD, "I")))
            for x in v:
                self.value(x)
        elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            self.int(int(v))
        elif isinstance(v, np.ndarray):
            inner = _Writer()
            inner.value([list(v.shape), v.dtype.name,
                         np.ascontiguousarray(v).tobytes()])
            self.ext(1, bytes(inner.out))
        else:
            raise TypeError(f"cannot write {type(v).__name__} as a flax "
                            f"params leaf")

    def int(self, v: int) -> None:
        if 0 <= v <= 0x7F:
            self.out += struct.pack(">B", v)
        elif -32 <= v < 0:
            self.out += struct.pack(">b", v)
        elif v >= 0:
            for code, fmt in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"),
                              (0xCF, "Q")):
                if v < 1 << (8 * struct.calcsize(fmt)):
                    self.out += struct.pack(">B" + fmt, code, v)
                    return
            raise ValueError(f"int {v} does not fit msgpack")
        else:
            for code, fmt in ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"),
                              (0xD3, "q")):
                if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    self.out += struct.pack(">B" + fmt, code, v)
                    return
            raise ValueError(f"int {v} does not fit msgpack")

    def ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out += struct.pack(">Bb", fixed[n], code)
        else:
            self.head(n, 0, -1, ((0xC7, "B"), (0xC8, "H"), (0xC9, "I")))
            self.out += struct.pack(">b", code)
        self.out += payload


def write_flax_msgpack(tree: dict) -> bytes:
    """Encode a params tree (nested str-keyed dicts with ndarray leaves) as
    flax.serialization.to_bytes does, without flax or msgpack. Arrays over
    1 GB, which flax writes in chunks, are not supported."""
    w = _Writer()
    w.value(tree)
    return bytes(w.out)


def save_params(state_dict: dict, path: str,
                num_heads: dict[str, int]) -> None:
    """Write the port's state_dict as a flax msgpack params file that the
    JAX package's load_params reads."""
    import os
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = write_flax_msgpack(state_dict_to_flax(state_dict, num_heads))
    with open(path, "wb") as f:
        f.write(data)


def read_params_tree(path: str) -> dict:
    """A params file as a nested tree of numpy arrays: a flattened-key
    ``.npz``, or a flax msgpack params tree (the JAX package's
    ``save_params`` file or a ``save_checkpoint`` directory's
    ``params.msgpack``; a tree under a single "params" key is unwrapped)."""
    if zipfile.is_zipfile(path):
        tree: dict = {}
        with np.load(path) as z:
            for key in z.files:
                *path_, leaf = key.split("/")
                node = tree
                for p in path_:
                    node = node.setdefault(p, {})
                node[leaf] = z[key]
        return tree
    with open(path, "rb") as f:
        tree = read_flax_msgpack(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a params tree")
    if set(tree) == {"params"} and isinstance(tree["params"], dict):
        tree = tree["params"]
    return tree


def load_params(path: str) -> dict[str, torch.Tensor]:
    """Read a params file (read_params_tree) into the port's state_dict."""
    return flax_to_state_dict(read_params_tree(path))
