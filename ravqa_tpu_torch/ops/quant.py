"""Symmetric int8 quantizers and exact search over an int8 token index.

Port of ravqa_tpu/ops/quant.py. Each quantizer takes the absolute maximum
per doc (over its S summary slots), per query token or per index token, in
float32, sets scale = max(absmax, 1e-8) / 127 and rounds x / scale half to
even (torch.round, as jnp.round), so the int8 codes are bit-equal to the
JAX package's. The JAX package runs them under jit, where XLA turns the
division by the constant 127 into a multiplication by its float32
reciprocal; the port multiplies likewise, so the scales are bit-equal too.
A per-DOC summary scale is strictly positive, so it commutes with the max
over slots and the sum over query tokens: the sweeps apply it after both.

The int8 token index (quantize_index_int8: per-token scales, 0 on masked
tokens) is searched exactly in two ways, as in the JAX package:

- ``maxsim_search_int8_torch``: the XLA route's math (maxsim_search_int8_xla)
  with float queries, in plain PyTorch;
- ``maxsim_search_int8``: the kernel route. On a CUDA tensor it launches
  ``csrc/maxsim_int8.cu`` (K5, port of maxsim_search_int8_pallas, on the
  tensor cores, tiled by ``ops.maxsim.mma_tile_plan``) on quantized queries
  and counts the launch in ``maxsim_search_int8.launches``;
  on a CPU tensor it runs ``maxsim_search_int8_q8_torch``, K5's semantics
  in plain PyTorch.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
NEG_INF = -9999.0  # the reference's padding fill value (colbert.py:240)
_K5_BLOCK_ROWS = 256   # query rows per block of csrc/maxsim_int8.cu


def _quantize(x: torch.Tensor, reduce_dims) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    x32 = x.float()
    scales = x32.abs().amax(dim=reduce_dims).clamp_min(_EPS) * (1.0 / 127.0)
    shape = list(x32.shape)
    for d in reduce_dims:
        shape[d] = 1
    codes = torch.round(x32 / scales.reshape(shape)).to(torch.int8)
    # a transposed input gives transposed codes; the kernels take them
    # contiguous
    return codes.contiguous(), scales


def quantize_summaries_t_int8(summaries_t: torch.Tensor):
    """Slot-major summaries (S, N, dim) float -> (int8 (S, N, dim), (N,)
    float32 per-doc scales), for the int8 coarse sweep (K3). Padded docs
    (all-zero summaries) get the eps scale and all-zero codes."""
    return _quantize(summaries_t, (0, 2))


def quantize_summaries_int8(summaries: torch.Tensor):
    """Doc-major summaries (N, S, dim) float -> (int8 (N, S, dim), (N,)
    float32 per-doc scales), for hierarchical search's int8 stage 1."""
    return _quantize(summaries, (1, 2))


def quantize_queries_int8(q: torch.Tensor):
    """(B, Lq, dim) float -> (int8 (B, Lq, dim), (B, Lq) float32 scales).
    Zero rows stay zero."""
    return _quantize(q, (2,))


def quantize_index_int8(tokens: torch.Tensor, mask: torch.Tensor,
                        chunk: int = 8192):
    """(N, Ld, dim) float tokens, (N, Ld) mask -> (int8 (N, Ld, dim) codes,
    (N, Ld) float32 scales), per-token symmetric: scale = max|x| / 127 (at
    least 1e-8 / 127), codes and scales zeroed on masked tokens. Docs go in
    chunks of `chunk`, so no whole-index float32 copy is ever made; the
    outputs live on the tokens' device."""
    n, ld, dim = tokens.shape
    codes = torch.empty((n, ld, dim), dtype=torch.int8, device=tokens.device)
    scales = torch.empty((n, ld), dtype=torch.float32, device=tokens.device)
    for lo in range(0, n, chunk):
        c, s = _quantize(tokens[lo:lo + chunk], (2,))
        m = mask[lo:lo + chunk].to(device=tokens.device)
        codes[lo:lo + chunk] = c * m.to(torch.int8)[..., None]
        scales[lo:lo + chunk] = s * m.float()
    return codes, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., dim) with scales (...) -> float32 (..., dim)."""
    return q.float() * scales[..., None]


def _doc_chunks(b: int, lq: int, ld: int, max_chunk_elems: int) -> int:
    return max(1, max_chunk_elems // max(1, ld * b * lq))


def maxsim_search_int8_torch(q: torch.Tensor, tokens_i8: torch.Tensor,
                             scales: torch.Tensor, mask: torch.Tensor,
                             max_chunk_elems: int = 1 << 26) -> torch.Tensor:
    """MaxSim over an int8 index with float queries (port of
    maxsim_search_int8_xla): q (B, Lq, dim) float, tokens_i8 (N, Ld, dim)
    int8 with scales (N, Ld), mask (N, Ld) -> (B, N) float32. Products of
    the int8 values and the float32 query in float32, times the token's
    scale; masked tokens score -9999 before the max over Ld. Docs go in
    chunks, as in maxsim_search_torch."""
    b, lq, _ = q.shape
    n, ld, _ = tokens_i8.shape
    qf = q.float()
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    step = _doc_chunks(b, lq, ld, max_chunk_elems)
    for s in range(0, n, step):
        sc = torch.einsum("nld,bqd->nlbq", tokens_i8[s:s + step].float(), qf)
        sc = sc * scales[s:s + step].float()[:, :, None, None]
        sc = sc.masked_fill(~mask[s:s + step].bool()[:, :, None, None],
                            NEG_INF)
        out[:, s:s + step] = sc.amax(dim=1).sum(dim=-1).T
    return out


def maxsim_search_int8_q8_torch(q8: torch.Tensor, q_scales: torch.Tensor,
                                tokens_i8: torch.Tensor,
                                d_scales: torch.Tensor,
                                max_chunk_elems: int = 1 << 26
                                ) -> torch.Tensor:
    """Plain exact int8 MaxSim (K5's semantics, port of the body
    _maxsim_int8_kernel): q8 (B, Lq, dim) int8 with q_scales (B, Lq),
    tokens_i8 (N, Ld, dim) int8 with d_scales (N, Ld) (0 on invalid
    tokens) -> (B, N) float32:

        out[b, n] = sum_t q_scales[b, t] * max_l s(b, t, n, l)
        s = (q8[b, t] . tok8[n, l]) * d_scales[n, l]  if d_scales > 0
          = -9999                                     otherwise

    The int8 dot products are exact in float32 (|sum| <= dim * 127^2 <
    2^24 for dim <= 1024); on the card TF32 must be off."""
    b, lq, _ = q8.shape
    n, ld, _ = tokens_i8.shape
    qf = q8.float()
    out = torch.empty((b, n), dtype=torch.float32, device=q8.device)
    step = _doc_chunks(b, lq, ld, max_chunk_elems)
    for s in range(0, n, step):
        ds = d_scales[s:s + step].float()[:, :, None, None]
        sc = torch.einsum("nld,bqd->nlbq", tokens_i8[s:s + step].float(), qf)
        sc = torch.where(ds > 0, sc * ds, NEG_INF)
        per_q = sc.amax(dim=1) * q_scales.float()[None]       # (n, B, Lq)
        out[:, s:s + step] = per_q.sum(dim=-1).T
    return out


def maxsim_search_int8(q8: torch.Tensor, q_scales: torch.Tensor,
                       tokens_i8: torch.Tensor,
                       d_scales: torch.Tensor) -> torch.Tensor:
    """Exact int8 MaxSim search (port of maxsim_search_int8_pallas): see
    maxsim_search_int8_q8_torch for the semantics. CUDA tensors launch
    csrc/maxsim_int8.cu (K5) on the current stream and count the launch in
    ``maxsim_search_int8.launches``; CPU tensors take the plain version.
    The TPU kernel's rule N % tile_d == 0 does not apply."""
    if q8.device.type == "cpu":
        return maxsim_search_int8_q8_torch(q8, q_scales, tokens_i8, d_scales)
    if q8.device.type != "cuda":
        raise ValueError(f"maxsim_search_int8: unsupported device "
                         f"{q8.device}")
    from .maxsim import (_MAX_DIM, _check_cuda, _launch, _plan_ints,
                         launch_plan)
    if q8.dim() != 3 or tokens_i8.dim() != 3:
        raise ValueError(f"maxsim_search_int8: expected q8 (B, Lq, dim) and "
                         f"tokens_i8 (N, Ld, dim); got {tuple(q8.shape)}, "
                         f"{tuple(tokens_i8.shape)}")
    b, lq, dim = q8.shape
    n, ld, dim2 = tokens_i8.shape
    if dim != dim2 or tuple(q_scales.shape) != (b, lq) \
            or tuple(d_scales.shape) != (n, ld):
        raise ValueError(f"maxsim_search_int8: shape mismatch q8 "
                         f"{tuple(q8.shape)}, q_scales "
                         f"{tuple(q_scales.shape)}, tokens_i8 "
                         f"{tuple(tokens_i8.shape)}, d_scales "
                         f"{tuple(d_scales.shape)}")
    if q8.dtype != torch.int8 or tokens_i8.dtype != torch.int8 \
            or q_scales.dtype != torch.float32 \
            or d_scales.dtype != torch.float32:
        raise TypeError("maxsim_search_int8: q8 and tokens_i8 must be int8, "
                        "q_scales and d_scales float32")
    if lq == 0 or ld == 0 or dim % 16 or dim > _MAX_DIM:
        raise ValueError(f"maxsim_search_int8: the kernel needs Lq > 0, "
                         f"Ld > 0, dim % 16 == 0 and dim <= {_MAX_DIM}; got "
                         f"Lq={lq}, Ld={ld}, dim={dim}")
    _check_cuda("maxsim_search_int8", q8=q8, q_scales=q_scales,
                tokens_i8=tokens_i8, d_scales=d_scales)
    out = torch.empty((b, n), dtype=torch.float32, device=q8.device)
    plan = launch_plan(q8.device, ld, n, b, lq, _K5_BLOCK_ROWS, dim=dim)
    _launch("ravqa_maxsim_int8", "ravqa_maxsim_search_int8", q8.device,
            q8.data_ptr(), q_scales.data_ptr(), tokens_i8.data_ptr(),
            d_scales.data_ptr(), out.data_ptr(), b, lq, n, ld, dim,
            *_plan_ints(plan))
    maxsim_search_int8.launches += 1
    return out


maxsim_search_int8.launches = 0
