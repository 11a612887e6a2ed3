"""Symmetric int8 quantizers for the pruning stages' summary copies.

Port of the summary and query quantizers of ravqa_tpu/ops/quant.py
(:45-89). Each takes the absolute maximum per doc (over its S summary
slots) or per query token, in float32, sets scale = max(absmax, 1e-8) /
127 and rounds x / scale half to even (torch.round, as jnp.round), so the
int8 codes are bit-equal to the JAX package's. The JAX package runs them
under jit, where XLA turns the division by the constant 127 into a
multiplication by its float32 reciprocal; the port multiplies likewise, so
the scales are bit-equal too. The scale is per DOC and
strictly positive, so it commutes with the max over slots and the sum over
query tokens: the sweeps apply it after both.

The int8 token index (quantize_index_int8) and its exact search come with
the int8 MaxSim kernel (ROADMAP.md, Queue B: K5).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


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
