"""Native (C++) host-side components of the port, loaded via ctypes.

A copy of ravqa_tpu/native: the fast WordPiece tokenizer (wordpiece.cpp,
the same source). The library builds on first use with the system C++
compiler into ``ravqa_tpu_torch/_build/native/`` (gitignored), not next to
the source; if no compiler is available the callers fall back to the
pure-Python implementation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False


def _build_lib() -> Optional[str]:
    src = os.path.join(_HERE, "wordpiece.cpp")
    out = os.path.join(BUILD_DIR, "libravqa_native.so")
    if os.path.exists(out) and os.path.getmtime(out) > os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a temporary name, then rename: processes that build at the
    # same time never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    for cc in ("g++", "c++", "clang++"):
        try:
            subprocess.run([cc, "-O2", "-shared", "-fPIC", "-std=c++17",
                            "-pthread", src, "-o", tmp], check=True,
                           capture_output=True)
            os.replace(tmp, out)
            return out
        except (OSError, subprocess.CalledProcessError):
            continue
    os.unlink(tmp)
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_FAILED
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    path = _build_lib()
    if path is None:
        _BUILD_FAILED = True
        return None
    lib = ctypes.CDLL(path)
    lib.wp_load_vocab.restype = ctypes.c_int32
    lib.wp_load_vocab.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.wp_encode_batch.restype = None
    lib.wp_encode_batch.argtypes = [
        ctypes.c_int32, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32)]
    _LIB = lib
    return lib


class FastWordPiece:
    """C++ WordPiece encoder over a vocab.txt. Handles ASCII + CJK
    ideographs + common fullwidth punctuation natively; rows containing
    other non-ASCII codepoints come back with len -1 (the caller
    re-encodes them with the Python reference implementation)."""

    def __init__(self, vocab_path: str, unk_id: int = 100):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("no C++ compiler available")
        self.lib = lib
        self.handle = lib.wp_load_vocab(vocab_path.encode(), unk_id)
        if self.handle < 0:
            raise FileNotFoundError(vocab_path)

    def encode_batch(self, texts: Sequence[str], maxlen: int):
        """-> (ids (n, maxlen) int32 zero-padded, lens (n,) int32;
        lens[i] == -1 marks a row the caller must re-encode in Python)."""
        n = len(texts)
        # NUL would terminate the C string; the Python reference DROPS
        # NUL (cp==0 -> continue, joining the surrounding word), so strip
        # rather than substitute a space (which would split the word)
        bufs = [t.replace("\x00", "").encode("utf-8") for t in texts]
        offsets = np.zeros(n, np.int64)
        pos = 0
        blob = bytearray()
        for i, b in enumerate(bufs):
            offsets[i] = pos
            blob += b + b"\x00"
            pos += len(b) + 1
        ids = np.zeros((n, maxlen), np.int32)
        lens = np.zeros(n, np.int32)
        self.lib.wp_encode_batch(self.handle, bytes(blob), offsets, n,
                                 maxlen, ids, lens)
        return ids, lens
