"""Build the port's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) from the
``.cu`` files under ``ravqa_tpu_torch/csrc/`` into a plain C ABI and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). The output
goes to ``ravqa_tpu_torch/_build/<name>-<hash>/``, keyed on a hash of the
sources, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one does not. Nothing is built at import time: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of ravqa_tpu_torch build only where the CUDA "
                       "toolkit is installed")


def build_library(name: str, sources: tuple[str, ...]) -> tuple[str, str]:
    """Compile `sources` (file names under csrc/) into lib<name>.so.

    Returns (path of the library, compiler log). The log is empty when an
    up-to-date library already existed."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    headers = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + headers:
        with open(p, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}")
    lib = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(out_dir, exist_ok=True)
    # build to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def load_library(name: str, sources: tuple[str, ...]) -> tuple[ctypes.CDLL,
                                                                  float, str]:
    """Build (if needed) and load; returns (library, build seconds, log)."""
    t0 = time.perf_counter()
    path, log = build_library(name, sources)
    return ctypes.CDLL(path), time.perf_counter() - t0, log
