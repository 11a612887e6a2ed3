"""The JAX package's orbax checkpoints, without jax, orbax, tensorstore,
zstandard or msgpack.

The JAX executors' save_checkpoint(backend="orbax") hands
``orbax.checkpoint.StandardCheckpointer`` the tree {"params", "opt_state",
"rng", "step"}. What it writes, in a directory:

- ``_METADATA``: JSON; "tree_metadata" maps each leaf's key path to its
  "key_metadata" (key_type 1 for a sequence's index, 2 for a dict key or
  a named field) and "value_metadata" ("value_type"; empty nodes, optax's
  EmptyState and MaskedNode among them, are "skip_deserialize");
  "use_ocdbt" and "use_zarr3" say how the arrays are stored;
- one zarr v2 array per leaf, named by its key path joined with ".":
  ``<name>/.zarray`` (JSON: shape, chunks, dtype, compressor) and a chunk
  per grid cell, ``<name>/0.0`` ("0" for a scalar);
- by default (use_ocdbt) those keys live in an OCDBT key-value store (the
  directory's manifest.ocdbt and its data files), every chunk zstd level
  1; without it, each key is a file under the directory.

``save`` writes the simplest form the JAX package's load_checkpoint_orbax
restores: plain zarr v2 files, uncompressed ("compressor": null), and the
two metadata files. ``load`` reads either form.

The OCDBT reader follows tensorstore's format (magic numbers 0x0cdb3a2a
for a manifest and 0x0cdb20de for a B+tree node; each file a header of
magic, length, version and compression, then the body, zstd or plain,
then a crc32c of everything before it, which is checked):

- manifest: the config (uuid, manifest kind, inline and node size limits,
  version-tree arity, compression), a data file table, then the versions
  inline (generation, root height, root's file/offset/length, counts,
  commit time); the newest version's root is read;
- data file table: count, shared-prefix lengths, suffix lengths, base
  path lengths, then the suffixes: each path relative to the store's
  directory;
- B+tree node: height, a data file table, the entries' keys (prefix
  compressed), then for a leaf each value's length and kind (inline, or
  indirect: file id and offset) and the inline values; for an interior
  node each child's common key prefix length, file id, offset, length
  and counts. A child's keys continue its parent entry's common prefix.

zstd goes through the system's libzstd.so.1 (ctypes); reading a zstd
chunk without it raises an error that names the library. The port's own
uncompressed checkpoints need no library.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import shutil
import struct
import time
from typing import Iterable, Optional

import numpy as np

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")

# ---------------------------------------------------------------------------
# zstd (libzstd through ctypes) and crc32c
# ---------------------------------------------------------------------------


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


_ZSTD: Optional[ctypes.CDLL] = None


def _zstd() -> ctypes.CDLL:
    global _ZSTD
    if _ZSTD is None:
        lib = None
        for name in ("libzstd.so.1", ctypes.util.find_library("zstd")):
            try:
                lib = ctypes.CDLL(name) if name else None
            except OSError:
                continue
            if lib is not None:
                break
        if lib is None:
            raise RuntimeError("this orbax checkpoint is zstd-compressed, "
                               "and the system library libzstd.so.1 that "
                               "decompresses it was not found")
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
            ctypes.POINTER(_InBuffer)]
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        _ZSTD = lib
    return _ZSTD


def zstd_decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """Decompress one zstd frame; `size`, where known, is its decoded
    length (checked). Raises ValueError on corrupt or truncated data."""
    lib = _zstd()
    src = ctypes.create_string_buffer(bytes(data), len(data))
    inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    out = bytearray(size if size is not None else 1 << 20)
    parts, done = [], 0
    stream = lib.ZSTD_createDStream()
    try:
        while True:
            view = (ctypes.c_char * (len(out) - done)).from_buffer(out, done)
            outb = _OutBuffer(ctypes.cast(view, ctypes.c_void_p),
                              len(out) - done, 0)
            r = lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                          ctypes.byref(inb))
            done += outb.pos
            del view, outb
            if lib.ZSTD_isError(r):
                raise ValueError("zstd: " + lib.ZSTD_getErrorName(r)
                                 .decode())
            if r == 0:
                break
            if done == len(out):
                if size is not None:
                    raise ValueError(f"zstd frame longer than the "
                                     f"{size} bytes expected")
                parts.append(bytes(out))
                done = 0
            elif inb.pos == inb.size:
                raise ValueError("zstd frame truncated")
    finally:
        lib.ZSTD_freeDStream(stream)
    if inb.pos != inb.size:
        raise ValueError("bytes after the zstd frame")
    parts.append(bytes(out[:done]))
    total = sum(len(p) for p in parts)
    if size is not None and total != size:
        raise ValueError(f"zstd frame of {total} bytes, {size} expected")
    return parts[0] if len(parts) == 1 else b"".join(parts)


def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's footers hold it."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF

# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: bad varint")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def unpack(self, fmt: str):
        return struct.unpack("<" + fmt, self.take(struct.calcsize(fmt)))[0]


def _open_envelope(data: bytes, magic: int, what: str) -> _Reader:
    """Check an OCDBT file's header and crc32c footer; the body's reader."""
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"{what}: not an OCDBT file (magic)")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"{what}: length field {length}, {len(data)} "
                         "bytes read (truncated?)")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise ValueError(f"{what}: crc32c mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    if r.varint() != 0:
        raise ValueError(f"{what}: unknown OCDBT format version")
    method = r.varint()
    body = r.data[r.pos:]
    if method == 1:
        body = zstd_decompress(body)
    elif method != 0:
        raise ValueError(f"{what}: unknown compression {method}")
    return _Reader(body, what)


def _file_table(r: _Reader, base: str) -> list[tuple[str, str]]:
    """[(path, its base path)], both under `base`."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for p, s, b in zip(prefix, suffix, base_len):
        prev = prev[:p] + r.take(s)
        out.append((base + prev.decode(), base + prev[:b].decode()))
    return out


def _keys(r: _Reader, n: int, common: bool):
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    lens = r.varints(n) if common else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys, lens


class OcdbtStore:
    """The keys and values of an OCDBT store's newest version (a
    directory with manifest.ocdbt). values[key] is ("inline", bytes) or
    ("file", path, offset, length); read(key) gives the bytes."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            r = _open_envelope(f.read(), _MANIFEST_MAGIC,
                               f"{root}/manifest.ocdbt")
        r.take(16)                                   # uuid
        if r.varint() != 0:
            raise ValueError(f"{root}: a numbered OCDBT manifest (only the "
                             "single-file kind is read)")
        r.varint(), r.varint(), r.u8()               # limits, arity
        if r.varint() == 1:
            r.unpack("i")                            # zstd level
        files = _file_table(r, "")
        n = r.varint()
        if n == 0:
            raise ValueError(f"{root}: OCDBT manifest without a version")
        r.varints(n)                                 # generations
        heights = [r.u8() for _ in range(n)]
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        self.values: dict[str, tuple] = {}
        if offsets[-1] != _NO_ROOT:
            self._node(*files[ids[-1]], offsets[-1], lengths[-1],
                       heights[-1], b"")

    def _node(self, path: str, base: str, offset: int, length: int,
              height: int, prefix: bytes) -> None:
        """Read the node at `path` (its data files relative to `base`,
        the base path of the reference that led here) and its subtree."""
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        what = f"{path}@{offset}"
        r = _open_envelope(data, _NODE_MAGIC, what)
        if r.u8() != height:
            raise ValueError(f"{what}: B+tree node height differs from "
                             "its reference's")
        files = _file_table(r, base)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                self._node(*files[ids[i]], offs[i], lens[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        sizes = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{what}: unknown value kind")
        ids, offs = r.varints(len(indirect)), r.varints(len(indirect))
        where = dict(zip(indirect, zip(ids, offs)))
        for i in range(n):
            key = (prefix + keys[i]).decode()
            if i in where:
                fid, off = where[i]
                self.values[key] = ("file", files[fid][0], off, sizes[i])
            else:
                self.values[key] = ("inline", r.take(sizes[i]))
        if r.pos != len(r.data):
            raise ValueError(f"{what}: bytes after the node's values")

    def read(self, key: str) -> bytes:
        v = self.values.get(key)
        if v is None:
            raise KeyError(f"{self.root}: OCDBT store has no key {key!r}")
        if v[0] == "inline":
            return v[1]
        _, path, offset, size = v
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(size)
        if len(data) != size:
            raise ValueError(f"{path}: truncated ({len(data)} of {size} "
                             f"bytes at {offset})")
        return data

# ---------------------------------------------------------------------------
# zarr v2 arrays and the tree
# ---------------------------------------------------------------------------


def _read_array(get, name: str) -> np.ndarray:
    meta = json.loads(get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2 or meta.get("filters") \
            or meta.get("order", "C") != "C":
        raise ValueError(f"{name}: a zarr array this reader does not "
                         f"read ({meta})")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp} (zstd or none read)")
    sep = meta.get("dimension_separator", ".")
    if 0 in shape:
        return np.empty(shape, np.float32 if bf16 else dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    out = None if chunks == shape else np.empty(shape, dtype)
    for cell in np.ndindex(*grid) if shape else [()]:
        key = sep.join(str(i) for i in cell) if shape else "0"
        raw = get(f"{name}/{key}")
        if comp is not None:
            raw = zstd_decompress(raw, nbytes)
        if len(raw) != nbytes:
            raise ValueError(f"{name}/{key}: {len(raw)} bytes, a chunk of "
                             f"{chunks} {dtype} is {nbytes} (truncated?)")
        block = np.frombuffer(raw, dtype).reshape(chunks)
        if out is None:                  # one chunk: the array itself
            out = block
            break
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(cell, chunks, shape))
        out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    if bf16:
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def _tree_metadata(path: str) -> tuple[dict, dict]:
    with open(os.path.join(path, "_METADATA")) as f:
        md = json.load(f)
    if md.get("use_zarr3"):
        raise ValueError(f"{path}: a zarr v3 orbax checkpoint (v2 read)")
    return md, md["tree_metadata"]


def load(path: str, skip: Iterable[str] = ()) -> dict:
    """The checkpoint at `path` as nested dicts of numpy arrays, in flax's
    state-dict form (a sequence's elements under "0", "1", ...; empty
    nodes {}). Top-level entries named in `skip` are not read: each one
    _METADATA lists stands in the tree as None."""
    md, entries = _tree_metadata(path)
    if md.get("use_ocdbt") or os.path.exists(
            os.path.join(path, "manifest.ocdbt")):
        get = OcdbtStore(path).read
    else:
        def get(key):
            with open(os.path.join(path, key), "rb") as f:
                return f.read()
    tree: dict = {}
    for entry in entries.values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if keys[0] in skip:
            tree[keys[0]] = None
            continue
        vm = entry["value_metadata"]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if vm.get("skip_deserialize", False):
            node[keys[-1]] = {}
        elif vm.get("value_type") in _ARRAY_TYPES:
            node[keys[-1]] = _read_array(get, ".".join(keys))
        else:
            raise ValueError(f"{path}: leaf {'.'.join(keys)} of type "
                             f"{vm.get('value_type')!r}")
    return tree


def _leaves(tree: dict, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and v:
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def save(path: str, tree: dict) -> None:
    """Write `tree` (nested str-keyed dicts of numpy arrays; {} for an
    empty node; digit keys are a sequence's indices, as optax's tuples in
    flax's state-dict form) as an orbax checkpoint at `path` that the JAX
    package's StandardCheckpointer restores: uncompressed zarr v2, no
    OCDBT. Written beside `path`, then renamed over it."""
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    entries = {}
    for keys, value in _leaves(tree):
        skip = isinstance(value, dict)
        entries[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": 1 if k.isdigit() else 2}
                             for k in keys],
            "value_metadata": {"value_type": "Dict" if skip
                               else "np.ndarray", "skip_deserialize": skip}}
        if skip:
            continue
        a = np.asarray(value)
        name = os.path.join(tmp, ".".join(keys))
        os.makedirs(name)
        with open(os.path.join(name, ".zarray"), "w") as f:
            json.dump({"chunks": list(a.shape), "compressor": None,
                       "dimension_separator": ".", "dtype": a.dtype.str,
                       "fill_value": None, "filters": None, "order": "C",
                       "shape": list(a.shape), "zarr_format": 2}, f)
        if a.size:
            with open(os.path.join(name, ".".join(
                    "0" for _ in a.shape) or "0"), "wb") as f:
                f.write(memoryview(np.ascontiguousarray(a).reshape(-1)
                                   .view(np.uint8)))
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": entries, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    now = time.time_ns()
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "standard_checkpoint_handler.StandardCheckpointHandler",
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now,
                   "commit_timestamp_nsecs": now, "custom_metadata": {}}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
