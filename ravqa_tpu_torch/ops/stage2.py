"""Candidate scorers of the residual fine-stage experiment (stage 2).

Port of the three Pallas kernels of scripts/exp_residual_stage2.py. Each
query b scores C candidates of Ld tokens that were gathered beforehand
into dense (B, C, Ld, ...) tensors:

- ``fused_lut_maxsim`` (X1, ``csrc/residual_lut_maxsim.cu``, port of
  ``v_pallas`` and its body ``_fused_kernel``): the residual term of a
  2-bit residual codec, a lookup of each dim's bucket id in the 4 bucket
  weights dotted with the float32 query, plus the pre-gathered centroid
  scores, times the token's scale, masked, MaxSim. On the tensor cores:
  the weights and the query each split into two bf16 parts, hi.hi + lo.hi
  + hi.lo, on X2's grid (``candidate_plan``); ``launch_fused_lut`` is the
  launch alone. Plain version ``fused_lut_maxsim_torch``.
- ``candidate_maxsim`` (X2, ``csrc/candidate_maxsim.cu``, port of
  ``maxsim_candidates_pallas`` and ``_cand_kernel``): MaxSim of bf16
  queries over bf16 candidate tokens, float32 sums, on the tensor cores
  (tiles of 64 of a candidate's tokens as the MMA's rows, the query's
  tokens as its columns; ``candidate_plan`` is the grid,
  ``launch_candidate`` the launch alone). X3 (``v_record_perq_pallas``,
  body ``_perq_kernel``) is the same function for one query, launched once
  per query: its route calls this wrapper with B = 1. Plain version
  ``candidate_maxsim_torch``.

On CUDA tensors each wrapper launches its hand-written kernel on the
current stream (or raises) and counts the launch in ``<wrapper>.launches``;
on CPU tensors it runs the plain version. Neither kernel has the TPU's
tile rule on C (32 for X1, 128 for X2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .maxsim import (SUMMARY_TILE_ROWS, _SUMMARY_COLS, _SUMMARY_MAX_TILES,
                     _launch, _sm_count, maxsim_reduce)
from .quant import NEG_INF


def fused_lut_maxsim_torch(q: torch.Tensor, cqg: torch.Tensor,
                           bits: torch.Tensor, sg: torch.Tensor,
                           mg: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """Plain fused LUT + MaxSim (X1's semantics): q (B, Lq, dim), cqg
    (B, C, Ld, Lq) pre-gathered centroid scores, bits (B, C, Ld, dim)
    bucket ids, sg (B, C, Ld) scales, mg (B, C, Ld) nonzero for valid
    tokens, weights (2^nbits,) -> (B, C) float32:

        s(b, c, l, t) = (sum_d w[bits_d] q_d + cqg[b, c, l, t]) * sg
                        if mg != 0, else -9999
        out(b, c) = sum_t max_l s(b, c, l, t)

    everything in float32. A bucket id past the last weight takes the last
    one, as the TPU kernel's select chain does."""
    w = weights.float()
    wr = w[bits.long().clamp_max(w.numel() - 1)]         # (B, C, Ld, dim)
    s = torch.einsum("bcld,bqd->bclq", wr, q.float()) + cqg.float()
    s = s * sg.float()[..., None]
    s = s.masked_fill(mg[..., None] == 0, NEG_INF)
    return s.amax(dim=2).sum(dim=-1)


def candidate_maxsim_torch(q: torch.Tensor, tok: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Plain candidate MaxSim (X2/X3's semantics): q (B, Lq, dim), tok
    (B, C, Ld, dim), mask (B, C, Ld) nonzero for valid tokens -> (B, C)
    float32. Values are upcast to float32 (bf16 products are exact there)
    and summed in float32."""
    s = torch.einsum("bcld,bqd->bclq", tok.float(), q.float())
    return maxsim_reduce(s, mask)


def _check_tensors(where: str, aligned: tuple, **tensors) -> None:
    """Every tensor on one CUDA device and contiguous; those named in
    `aligned` 16-byte aligned (the kernels read their rows 8 or 16 bytes
    at a time)."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{where}: {name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
    for name in aligned:
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{where}: {name} must be 16-byte aligned")


def _check_widths(where: str, lq: int, ld: int, dim: int) -> None:
    if not 0 < lq <= 128 or ld <= 0 or dim <= 0 or dim % 8 or dim > 128:
        raise ValueError(f"{where}: the kernel needs 0 < Lq <= 128, Ld > 0, "
                         f"dim % 8 == 0 and dim <= 128; got Lq={lq}, "
                         f"Ld={ld}, dim={dim}")


# X1 and X2 run on summary_tile.cuh's bf16 wgmma: their tiles, the MMA's N
# that they take and the most tiles a block sweeps are the summary sweep's
CANDIDATE_TILE_ROWS = SUMMARY_TILE_ROWS


class CandidatePlan(NamedTuple):
    """How X1's and X2's tensor-core kernels cover a launch; the kernels
    take these ints.

    The query's Lq tokens are the MMA's `cols` columns (zeros past Lq). A
    candidate's Ld tokens go in `tiles_per_cand` tiles of 64 rows (rows of
    its last tile past Ld dropped); block x sweeps query x // ranges,
    candidates (x % ranges) * cands_per_block .. + cands_per_block - 1, with
    ranges = ceil(C / cands_per_block)."""
    cols: int
    tiles_per_cand: int
    cands_per_block: int

    def ranges(self, c: int) -> int:
        return -(-c // self.cands_per_block)

    def blocks(self, b: int, c: int) -> int:
        return b * self.ranges(c)


def candidate_plan(b: int, lq: int, c: int, ld: int,
                   sm_count: int = 132) -> CandidatePlan:
    """X1's and X2's plan for B queries of Lq tokens over C candidates of
    Ld tokens: N the smallest of 16, 32, 64, 128 that covers Lq; tiles per
    block at most 32, fewer when the grid would give the card's `sm_count`
    SMs less than four blocks each, and never less than one candidate's."""
    cols = next(x for x in _SUMMARY_COLS if x >= lq)
    tpc = -(-ld // CANDIDATE_TILE_ROWS)
    tiles = max(1, min(_SUMMARY_MAX_TILES,
                       b * c * tpc // (4 * sm_count)))
    return CandidatePlan(cols, tpc, max(1, tiles // tpc))


def fused_lut_maxsim(q: torch.Tensor, cqg: torch.Tensor, bits: torch.Tensor,
                     sg: torch.Tensor, mg: torch.Tensor,
                     weights: torch.Tensor, nbits: int = 2) -> torch.Tensor:
    """Fused 2-bit LUT + MaxSim over pre-gathered candidates (X1, port of
    v_pallas's kernel): see fused_lut_maxsim_torch for the semantics.

    CUDA tensors launch csrc/residual_lut_maxsim.cu on the tensor cores
    (the weights and the query each as two bf16 parts, three products), on
    the current stream, counted in ``fused_lut_maxsim.launches``: q
    (B, Lq, dim) float32, cqg
    (B, C, Ld, Lq) float32, bits (B, C, Ld, dim) uint8 (ops.residual's
    unpack_bits), sg (B, C, Ld) float32, mg (B, C, Ld) int8, weights (4,)
    float32; nbits must be 2 (the TPU body is a 4-way select). The TPU
    kernel took int32 ids and mask and a lane-padded weight row; those were
    Mosaic layout choices, the function is the same. CPU tensors take the
    plain version."""
    if q.device.type == "cpu":
        return fused_lut_maxsim_torch(q, cqg, bits, sg, mg, weights)
    if q.device.type != "cuda":
        raise ValueError(f"fused_lut_maxsim: unsupported device {q.device}")
    if nbits != 2:
        raise ValueError(f"fused_lut_maxsim: the kernel takes nbits 2 only; "
                         f"got {nbits}")
    if q.dim() != 3 or bits.dim() != 4:
        raise ValueError(f"fused_lut_maxsim: expected q (B, Lq, dim) and bits "
                         f"(B, C, Ld, dim); got {tuple(q.shape)}, "
                         f"{tuple(bits.shape)}")
    b, lq, dim = q.shape
    _, c, ld, _ = bits.shape
    if tuple(bits.shape) != (b, c, ld, dim) \
            or tuple(cqg.shape) != (b, c, ld, lq) \
            or tuple(sg.shape) != (b, c, ld) \
            or tuple(mg.shape) != (b, c, ld) or tuple(weights.shape) != (4,):
        raise ValueError(f"fused_lut_maxsim: shape mismatch q "
                         f"{tuple(q.shape)}, cqg {tuple(cqg.shape)}, bits "
                         f"{tuple(bits.shape)}, sg {tuple(sg.shape)}, mg "
                         f"{tuple(mg.shape)}, weights "
                         f"{tuple(weights.shape)}")
    if q.dtype != torch.float32 or cqg.dtype != torch.float32 \
            or bits.dtype != torch.uint8 or sg.dtype != torch.float32 \
            or mg.dtype != torch.int8 or weights.dtype != torch.float32:
        raise TypeError("fused_lut_maxsim: q, cqg, sg and weights must be "
                        "float32, bits uint8 and mg int8; got "
                        f"{q.dtype}, {cqg.dtype}, {sg.dtype}, "
                        f"{weights.dtype}, {bits.dtype}, {mg.dtype}")
    _check_widths("fused_lut_maxsim", lq, ld, dim)
    _check_tensors("fused_lut_maxsim", ("bits",), q=q, cqg=cqg, bits=bits,
                   sg=sg, mg=mg, weights=weights)
    return launch_fused_lut(q, cqg, bits, sg, mg, weights)


def launch_fused_lut(q, cqg, bits, sg, mg, weights):
    """X1's launch alone (csrc/residual_lut_maxsim.cu), on the inputs
    fused_lut_maxsim checks: (B, C) float32, counted in
    ``fused_lut_maxsim.launches``."""
    b, lq, dim = q.shape
    _, c, ld, _ = bits.shape
    out = torch.empty((b, c), dtype=torch.float32, device=q.device)
    plan = candidate_plan(b, lq, c, ld,
                          sm_count=_sm_count(q.device.index or 0))
    _launch("ravqa_residual_lut_maxsim", "ravqa_residual_lut_maxsim",
            q.device, q.data_ptr(), cqg.data_ptr(), bits.data_ptr(),
            sg.data_ptr(), mg.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, lq, c, ld, dim, *plan)
    fused_lut_maxsim.launches += 1
    return out


fused_lut_maxsim.launches = 0


def candidate_maxsim(q: torch.Tensor, tok: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """MaxSim over pre-gathered candidate tokens (X2, port of
    maxsim_candidates_pallas; X3 is this with B = 1, once per query): see
    candidate_maxsim_torch for the semantics.

    CUDA tensors launch csrc/candidate_maxsim.cu on the tensor cores, on
    the current stream, counted in ``candidate_maxsim.launches``: q
    (B, Lq, dim) bfloat16, tok (B, C, Ld, dim) bfloat16, mask (B, C, Ld)
    int8. The TPU kernel took the mask as a (B, C*Ld, 1) float column, a
    Mosaic layout choice. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return candidate_maxsim_torch(q, tok, mask)
    if q.device.type != "cuda":
        raise ValueError(f"candidate_maxsim: unsupported device {q.device}")
    if q.dim() != 3 or tok.dim() != 4:
        raise ValueError(f"candidate_maxsim: expected q (B, Lq, dim) and tok "
                         f"(B, C, Ld, dim); got {tuple(q.shape)}, "
                         f"{tuple(tok.shape)}")
    b, lq, dim = q.shape
    _, c, ld, _ = tok.shape
    if tuple(tok.shape) != (b, c, ld, dim) or tuple(mask.shape) != (b, c, ld):
        raise ValueError(f"candidate_maxsim: shape mismatch q "
                         f"{tuple(q.shape)}, tok {tuple(tok.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if q.dtype != torch.bfloat16 or tok.dtype != torch.bfloat16 \
            or mask.dtype != torch.int8:
        raise TypeError(f"candidate_maxsim: q and tok must be bfloat16 and "
                        f"mask int8; got {q.dtype}, {tok.dtype}, "
                        f"{mask.dtype}")
    _check_widths("candidate_maxsim", lq, ld, dim)
    _check_tensors("candidate_maxsim", ("q", "tok"), q=q, tok=tok, mask=mask)
    return launch_candidate(q, tok, mask)


def launch_candidate(q, tok, mask):
    """X2's launch alone (csrc/candidate_maxsim.cu), on the inputs
    candidate_maxsim checks: (B, C) float32, counted in
    ``candidate_maxsim.launches``."""
    b, lq, dim = q.shape
    _, c, ld, _ = tok.shape
    out = torch.empty((b, c), dtype=torch.float32, device=q.device)
    plan = candidate_plan(b, lq, c, ld,
                          sm_count=_sm_count(q.device.index or 0))
    _launch("ravqa_candidate_maxsim", "ravqa_candidate_maxsim", q.device,
            q.data_ptr(), tok.data_ptr(), mask.data_ptr(), out.data_ptr(), b,
            lq, c, ld, dim, *plan)
    candidate_maxsim.launches += 1
    return out


candidate_maxsim.launches = 0
