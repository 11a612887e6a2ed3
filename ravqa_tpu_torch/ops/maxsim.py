"""Late-interaction (ColBERT/FLMR) MaxSim scoring ops.

Port of ravqa_tpu/ops/maxsim.py. Per query token, take the max dot product
over a doc's token embeddings (masked doc tokens filled with -9999 before
the max), then sum over query tokens.

- ``maxsim_reduce`` / ``maxsim_search_torch``: plain PyTorch. The CPU path
  and the tests use them; on the card they are the reference the kernel is
  checked against.
- ``maxsim_search``: the serving entry. On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/maxsim.cu`` (port of
  ``maxsim_search_pallas``) or raises; on a CPU tensor it runs
  ``maxsim_search_torch``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

NEG_INF = -9999.0  # the reference's padding fill value (colbert.py:240)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_DIM = 128                 # Qs + 2 Ds shared-memory tiles fit 227 KB


def maxsim_reduce(scores: torch.Tensor, d_mask: torch.Tensor,
                  q_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., Ld, Lq) token scores -> (...,) MaxSim scores.

    d_mask: (..., Ld) nonzero for valid doc tokens; q_mask: optional
    (..., Lq) weights for query tokens."""
    scores = scores.masked_fill(~d_mask.bool()[..., :, None], NEG_INF)
    per_q = scores.amax(dim=-2)
    if q_mask is not None:
        per_q = per_q * q_mask.to(per_q.dtype)
    return per_q.sum(dim=-1)


def maxsim_search_torch(q: torch.Tensor, tokens: torch.Tensor,
                        mask: torch.Tensor,
                        max_chunk_elems: int = 1 << 26) -> torch.Tensor:
    """Plain MaxSim of a query batch against every doc of an index.

    q (B, Lq, dim), tokens (N, Ld, dim), mask (N, Ld) -> (B, N) float32.
    Inputs are upcast to float32. Docs go in chunks so the (n, Ld, B, Lq)
    token-score intermediate holds at most `max_chunk_elems` floats."""
    b, lq, _ = q.shape
    n, ld, _ = tokens.shape
    qf = q.float()
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    step = max(1, max_chunk_elems // max(1, ld * b * lq))
    for s in range(0, n, step):
        scores = torch.einsum("nld,bqd->nlbq", tokens[s:s + step].float(), qf)
        scores = scores.masked_fill(
            ~mask[s:s + step].bool()[:, :, None, None], NEG_INF)
        out[:, s:s + step] = scores.amax(dim=1).sum(dim=-1).T
    return out


@functools.lru_cache(maxsize=None)
def _library():
    """Build and load csrc/maxsim.cu once per process."""
    from .cuda_build import load_library
    lib, seconds, log = load_library("ravqa_maxsim", ("maxsim.cu",))
    fn = lib.ravqa_maxsim_search
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn, seconds, log


def build_kernel() -> dict:
    """Build (or find built) and load the kernel; returns the build time in
    seconds and the compiler's log (registers, shared memory, spills)."""
    _, seconds, log = _library()
    return {"seconds": seconds, "log": log}


def _check_kernel_args(q, tokens, mask):
    if q.dim() != 3 or tokens.dim() != 3 or mask.dim() != 2:
        raise ValueError("expected q (B, Lq, dim), tokens (N, Ld, dim), "
                         f"mask (N, Ld); got {tuple(q.shape)}, "
                         f"{tuple(tokens.shape)}, {tuple(mask.shape)}")
    b, lq, dim = q.shape
    n, ld, dim2 = tokens.shape
    if dim != dim2 or tuple(mask.shape) != (n, ld):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, tokens "
                         f"{tuple(tokens.shape)}, mask {tuple(mask.shape)}")
    if dim % 8 or dim > _MAX_DIM or ld == 0:
        raise ValueError(f"kernel needs dim % 8 == 0, dim <= {_MAX_DIM} and "
                         f"Ld > 0; got dim={dim}, Ld={ld}")
    if q.dtype not in _KERNEL_DTYPES or tokens.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"q/tokens must be float32 or bfloat16; got "
                        f"{q.dtype}, {tokens.dtype}")
    if q.dtype == torch.bfloat16 and tokens.dtype == torch.float32:
        raise TypeError("a bfloat16 query needs a bfloat16 index; cast the "
                        "query to float32 for a float32 index")
    if mask.dtype != torch.int8:
        raise TypeError(f"mask must be int8; got {mask.dtype}")
    for name, t in (("q", q), ("tokens", tokens), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("tokens", tokens)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def maxsim_search(q: torch.Tensor, tokens: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Score a query batch against every doc of an index: (B, N) float32.

    q (B, Lq, dim) and tokens (N, Ld, dim) float32 or bfloat16 (the kernel
    takes f32 x f32, f32 x bf16 and bf16 x bf16), mask (N, Ld) int8. CUDA tensors launch the Hopper kernel on the current
    stream (no synchronisation) and count the launch in
    ``maxsim_search.launches``; CPU tensors take ``maxsim_search_torch``."""
    if q.device.type == "cpu":
        return maxsim_search_torch(q, tokens, mask)
    if q.device.type != "cuda":
        raise ValueError(f"maxsim_search: unsupported device {q.device}")
    _check_kernel_args(q, tokens, mask)
    fn = _library()[0]
    b, lq, dim = q.shape
    n, ld, _ = tokens.shape
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), tokens.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), b, lq, n, ld, dim,
                 int(q.dtype == torch.bfloat16),
                 int(tokens.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"maxsim kernel launch failed: CUDA error {err}")
    maxsim_search.launches += 1
    return out


maxsim_search.launches = 0
