"""Residual codec: centroid code + bucketized, planar-packed residuals.

Port of ravqa_tpu/ops/residual.py. Every token embedding is stored as

    code      nearest centroid id (uint16 in the packed record)
    residual  dim * nbits / 8 bytes: per-dim bucket ids, nbits each

and reconstructed as centroid[code] + bucket_weights[bucket] per dim.
Bucket cutoffs and weights are quantiles of the residual distribution.
Packing is PLANAR: byte j holds dims {j, j + D/p, ..., j + (p-1) D/p} for
p = 8 / nbits, so bit-plane k of the byte vector is dims [k D/p, (k+1) D/p)
(the JAX package's layout, bit for bit). The stored scale
1 / ||reconstruction|| carries the reference's post-decompress L2
normalization into scoring.

A residual index keeps one packed uint8 record row per doc,
[codes uint16 | scales bf16 | residual bytes] (pack_records), bytes
little-endian as ``lax.bitcast_convert_type`` lays them out.

Training (k-means, quantiles) and compression are plain PyTorch on the
device the caller names, as they are XLA in the JAX package. The fine
stage's fused decompress + MaxSim is ``maxsim_residual``: on CUDA tensors
the hand-written tensor-core kernel ``csrc/residual_maxsim.cu`` (K6, port
of maxsim_residual_pallas), counted in ``maxsim_residual.launches``, its
blocks planned by ``residual_plan``; on CPU tensors its plain version
``maxsim_residual_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .quant import NEG_INF

# queries per step of the plain fused stage: bounds its decompressed
# (group, C, Ld, dim) float32 copy
_GROUP = 8


@dataclasses.dataclass
class ResidualCodec:
    centroids: torch.Tensor       # (K, dim) float32 (unit rows for the flat
    #                               codec; the additive coarse[h] + fine[l]
    #                               table for the factored one)
    bucket_cutoffs: torch.Tensor  # (2^nbits - 1,) float32
    bucket_weights: torch.Tensor  # (2^nbits,) float32
    nbits: int = 2
    # factored additive codebook (train_codec_factored): centroid of code
    # h * k_fine + l is coarse[h] + fine[l]; `centroids` holds the flat
    # table, and the fused kernel reads the factors
    coarse: Optional[torch.Tensor] = None   # (k_coarse, dim) float32
    fine: Optional[torch.Tensor] = None     # (k_fine, dim) float32

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def packed_dim(self) -> int:
        return self.dim * self.nbits // 8

    @property
    def factored(self) -> bool:
        return self.coarse is not None


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _sample_split(tokens, mask, sample: int, heldout: int, seed: int,
                  device=None, gather=None):
    """Disjoint (train, heldout) float32 samples of the valid tokens, with
    the JAX package's numpy picks (same seed, same rows). Only the picked
    rows are read, so a large device-resident index is never copied.
    gather: rows of the flat (N * Ld, dim) token array -> their float32
    tokens, in place of reading `tokens` (a sharded index assembles the
    global picks across its ranks)."""
    valid = np.flatnonzero(_numpy(mask).reshape(-1) > 0)
    rng = np.random.default_rng(seed)
    take = min(sample + heldout, len(valid))
    # small corpora: keep at least half the picks for k-means so neither
    # split is ever empty
    heldout = max(1, min(heldout, take // 2))
    rows = valid[rng.choice(len(valid), take, replace=False)]
    if gather is not None:
        picked = gather(rows).to(device)
        return picked[:take - heldout], picked[take - heldout:]
    dim = tokens.shape[-1]
    if isinstance(tokens, torch.Tensor):
        flat = tokens.reshape(-1, dim)
        picked = flat[torch.from_numpy(rows).to(flat.device)].float()
    else:
        picked = torch.from_numpy(
            np.asarray(tokens, np.float32).reshape(-1, dim)[rows])
    picked = picked.to(device)
    return picked[:take - heldout], picked[take - heldout:]


def _fit_buckets(resid: torch.Tensor, nbits: int):
    """Bucket cutoffs at the residual distribution's quantile edges,
    weights at the bucket medians (numpy quantiles, as the JAX package)."""
    r = _numpy(resid).reshape(-1)
    nb = 2 ** nbits
    cutoffs = np.quantile(r, np.arange(1, nb) / nb).astype(np.float32)
    weights = np.quantile(r, (np.arange(nb) + 0.5) / nb).astype(np.float32)
    dev = resid.device
    return torch.from_numpy(cutoffs).to(dev), torch.from_numpy(weights).to(dev)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x ** 2).sum(-1, keepdim=True) + 1e-9)


def _kmeans(x: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """Spherical k-means, initialized at every (n // k)-th row."""
    stride = max(x.shape[0] // k, 1)
    cent = _normalize(x[::stride][:k])
    for _ in range(iters):
        a = (x @ cent.T).argmax(dim=-1)
        tot = torch.zeros_like(cent).index_add_(0, a, x)
        cnt = torch.zeros(cent.shape[0], device=x.device).index_add_(
            0, a, torch.ones_like(a, dtype=torch.float32))
        cent = _normalize(torch.where(cnt[:, None] > 0, tot, cent))
    return cent


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return (x @ centroids.T).argmax(dim=-1)


def _l2_assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    # argmin ||x - c||^2 == argmax x . c - ||c||^2 / 2
    return (x @ cent.T - 0.5 * (cent * cent).sum(-1)).argmax(dim=-1)


def _mean_update(x: torch.Tensor, a: torch.Tensor,
                 cent: torch.Tensor) -> torch.Tensor:
    tot = torch.zeros_like(cent).index_add_(0, a, x)
    cnt = torch.zeros(cent.shape[0], device=x.device).index_add_(
        0, a, torch.ones_like(a, dtype=torch.float32))
    return torch.where(cnt[:, None] > 0, tot / cnt.clamp_min(1.0)[:, None],
                       cent)


def _kmeans_l2(x: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """Plain (non-spherical) k-means, for residuals that are not unit-norm."""
    stride = max(x.shape[0] // k, 1)
    cent = x[::stride][:k]
    for _ in range(iters):
        cent = _mean_update(x, _l2_assign(x, cent), cent)
    return cent


def assign_factored(flat: torch.Tensor, coarse: torch.Tensor,
                    fine: torch.Tensor) -> torch.Tensor:
    """Greedy (residual-VQ) assignment to the factored additive codebook:
    nearest coarse centroid, then nearest fine centroid of the residual,
    both by the l2 rule (the factors are not unit-norm). Returns the flat
    code hi * k_fine + lo."""
    hi = _l2_assign(flat, coarse)
    lo = _l2_assign(flat - coarse[hi], fine)
    return hi * fine.shape[0] + lo


def _refine_factored(x: torch.Tensor, coarse: torch.Tensor,
                     fine: torch.Tensor, iters: int):
    """Alternating refinement of the additive codebook under the greedy
    assignment compression applies: assign, then mean updates of coarse
    and fine in turn."""
    k2 = fine.shape[0]
    for _ in range(iters):
        a = assign_factored(x, coarse, fine)
        hi, lo = a // k2, a % k2
        coarse = _mean_update(x - fine[lo], hi, coarse)
        fine = _mean_update(x - coarse[hi], lo, fine)
    return coarse, fine


def _device_of(tokens, device):
    if device is not None:
        return torch.device(device)
    return tokens.device if isinstance(tokens, torch.Tensor) \
        else torch.device("cpu")


def train_codec(tokens, mask, n_centroids: int = 256, nbits: int = 2,
                iters: int = 8, sample: int = 2 ** 16,
                heldout: int = 2 ** 14, seed: int = 0,
                device=None, gather=None) -> ResidualCodec:
    """Flat codec: spherical k-means on a token sample (numpy picks from
    `seed`), bucket quantiles on the held-out residuals. Runs on `device`
    (default: the tokens' device). gather: see _sample_split."""
    dev = _device_of(tokens, device)
    train, held = _sample_split(tokens, mask, sample, heldout, seed, dev,
                                gather)
    cent = _kmeans(train, n_centroids, iters)
    cutoffs, weights = _fit_buckets(held - cent[_assign(held, cent)], nbits)
    return ResidualCodec(centroids=cent, bucket_cutoffs=cutoffs,
                         bucket_weights=weights, nbits=nbits)


def train_codec_factored(tokens, mask, k_coarse: int = 64,
                         k_fine: int = 128, nbits: int = 2, iters: int = 8,
                         refine_iters: int = 4, sample: int = 2 ** 16,
                         heldout: int = 2 ** 14, seed: int = 0,
                         device=None, gather=None) -> ResidualCodec:
    """Factored additive codec: K = k_coarse * k_fine effective centroids,
    centroid[h * k_fine + l] = coarse[h] + fine[l]. Spherical k-means
    coarse, l2 k-means fine on the residuals, then `refine_iters` rounds
    under the greedy assignment (assign_factored). k_fine must be a power
    of two and K <= 65536 (records store uint16 codes). gather: see
    _sample_split."""
    if k_fine & (k_fine - 1):
        raise ValueError(f"k_fine must be a power of two; got {k_fine}")
    if k_coarse * k_fine > 65536:
        raise ValueError(f"k_coarse * k_fine = {k_coarse * k_fine} exceeds "
                         "the uint16 code range of the packed records")
    dev = _device_of(tokens, device)
    train, held = _sample_split(tokens, mask, sample, heldout, seed, dev,
                                gather)
    coarse = _kmeans(train, k_coarse, iters)
    fine = _kmeans_l2(train - coarse[_assign(train, coarse)], k_fine, iters)
    coarse, fine = _refine_factored(train, coarse, fine, refine_iters)
    table = (coarse[:, None, :] + fine[None, :, :]).reshape(
        k_coarse * k_fine, coarse.shape[1])
    resid = held - table[assign_factored(held, coarse, fine)]
    cutoffs, weights = _fit_buckets(resid, nbits)
    return ResidualCodec(centroids=table, bucket_cutoffs=cutoffs,
                         bucket_weights=weights, nbits=nbits, coarse=coarse,
                         fine=fine)


def compress_flat(flat: torch.Tensor, centroids: torch.Tensor,
                  cutoffs: torch.Tensor, weights: torch.Tensor, nbits: int,
                  codes: Optional[torch.Tensor] = None):
    """Codec core on flat (T, dim) float32 tokens -> (codes (T,) int64,
    packed (T, dim * nbits / 8) uint8 planar bytes, scales (T,) float32 =
    1 / ||centroid[code] + weights[bucket]||). codes: a precomputed
    assignment (the factored codec's greedy codes); default the flat
    codec's dot-argmax."""
    dim = flat.shape[-1]
    if codes is None:
        codes = _assign(flat, centroids)
    cen = centroids[codes]
    # side='left', as jnp.searchsorted
    bucket = torch.searchsorted(cutoffs, flat - cen)
    rec = cen + weights[bucket]
    scales = torch.rsqrt((rec * rec).sum(-1) + 1e-12)
    per_byte = 8 // nbits
    b = bucket.to(torch.int32).reshape(-1, per_byte, dim // per_byte)
    shifts = torch.arange(per_byte, dtype=torch.int32,
                          device=flat.device) * nbits
    packed = (b << shifts[None, :, None]).sum(dim=1).to(torch.uint8)
    return codes, packed, scales


def _compress_block(tokens: torch.Tensor, mask: torch.Tensor,
                    codec: ResidualCodec):
    """(n, Ld, dim) -> codes (n, Ld) int32, packed (n, Ld, P) uint8, scales
    (n, Ld) float32. Masked tokens compress to code 0, zero bytes and
    scale 0."""
    n, ld, dim = tokens.shape
    m = mask.reshape(-1)
    flat = (tokens.float() * mask.float()[..., None]).reshape(-1, dim)
    pre = (assign_factored(flat, codec.coarse, codec.fine)
           if codec.factored else None)
    codes, packed, scales = compress_flat(flat, codec.centroids,
                                          codec.bucket_cutoffs,
                                          codec.bucket_weights, codec.nbits,
                                          codes=pre)
    codes = codes * m.to(codes.dtype)
    packed = packed * m.to(torch.uint8)[:, None]
    scales = scales * m.to(scales.dtype)
    return (codes.reshape(n, ld).to(torch.int32),
            packed.reshape(n, ld, -1), scales.reshape(n, ld))


def compress_blocks(tokens, mask, codec: ResidualCodec, block: int = 8192):
    """Yield (start, codes, packed, scales) of `block` docs at a time, on
    the codec's device, so the float32 upcast stays bounded."""
    dev = codec.centroids.device
    for s in range(0, tokens.shape[0], block):
        tok = torch.as_tensor(tokens[s:s + block]).to(dev)
        msk = torch.as_tensor(mask[s:s + block]).to(dev)
        yield (s,) + _compress_block(tok, msk, codec)


def compress(tokens, mask, codec: ResidualCodec, block: int = 8192):
    """Compress (N, Ld, dim) tokens in blocks of `block` docs. Returns
    (codes (N, Ld) int32, packed (N, Ld, P) uint8, scales (N, Ld)
    float32) on the codec's device."""
    parts = [p[1:] for p in compress_blocks(tokens, mask, codec, block)]
    return tuple(torch.cat(x) for x in zip(*parts))


def unpack_bits(packed: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., dim * nbits / 8) uint8 -> (..., dim) uint8 bucket ids (planar
    layout: plane p of the byte vector is dims [p P, (p+1) P))."""
    per_byte = 8 // nbits
    shifts = torch.arange(per_byte, dtype=torch.int32,
                          device=packed.device) * nbits
    vals = (packed.to(torch.int32)[..., None, :] >> shifts[:, None]) \
        & (2 ** nbits - 1)
    return vals.to(torch.uint8).reshape(packed.shape[:-1] + (-1,))


def decompress(codes: torch.Tensor, packed: torch.Tensor,
               centroids: torch.Tensor, bucket_weights: torch.Tensor,
               nbits: int, dtype=torch.bfloat16) -> torch.Tensor:
    """codes (...) + packed (..., P) -> (..., dim) centroid[code] +
    weights[bucket], summed in float32 and cast to `dtype`."""
    bits = unpack_bits(packed, nbits).long()
    return (centroids[codes.long()] + bucket_weights[bits]).to(dtype)


def record_bytes(ld: int, dim: int, nbits: int) -> int:
    return ld * 2 + ld * 2 + ld * (dim * nbits // 8)


def pack_records(codes: torch.Tensor, scales: torch.Tensor,
                 packed: torch.Tensor) -> torch.Tensor:
    """codes (N, Ld) int (< 65536 centroids) + scales (N, Ld) (stored as
    bf16) + packed (N, Ld, P) uint8 -> (N, Ld * (4 + P)) uint8 records."""
    n, ld = codes.shape
    # the low two bytes of each code, little-endian, as the JAX package's
    # uint16 bitcast (codes >= 32768 keep their value)
    cb = (codes.to(torch.int32) & 0xFFFF).contiguous().view(
        torch.uint8).reshape(n, ld, 4)[..., :2].reshape(n, ld * 2)
    sb = scales.to(torch.bfloat16).contiguous().view(torch.uint8)
    return torch.cat([cb, sb, packed.reshape(n, -1)], dim=1)


def split_records(rg: torch.Tensor, ld: int):
    """Inverse of pack_records on (possibly gathered) records (..., RB)
    uint8 -> (codes (..., Ld) int32, scales (..., Ld) float32, packed
    (..., Ld, P) uint8)."""
    lead = tuple(rg.shape[:-1])
    codes = rg[..., :ld * 2].contiguous().view(torch.int16).to(
        torch.int32) & 0xFFFF
    scales = rg[..., ld * 2:ld * 4].contiguous().view(torch.bfloat16).float()
    packed = rg[..., ld * 4:].reshape(lead + (ld, -1))
    return codes, scales, packed


# ---------------------------------------------------------------------------
# Fused decompress + MaxSim over per-query candidates (K6)
# ---------------------------------------------------------------------------

def centroid_scores(q: torch.Tensor, centroids: torch.Tensor,
                    coarse: Optional[torch.Tensor] = None,
                    fine: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused kernel's per-query centroid-score table, (B, rows, Lq)
    bfloat16: the centroids (flat codec) or the stacked factors coarse then
    fine (factored codec) in bf16, times the bf16 query, float32 sums,
    rounded to bf16, as the TPU kernel's cs table. (bf16 values are exact
    in TF32 too, so this product does not depend on the TF32 setting.)"""
    tab = centroids if coarse is None else torch.cat([coarse, fine])
    return torch.einsum("kd,bqd->bkq", tab.to(torch.bfloat16).float(),
                        q.to(torch.bfloat16).float()).to(torch.bfloat16)


def _check_codec(centroids, coarse, fine):
    if (coarse is None) != (fine is None):
        raise ValueError("coarse and fine go together")
    if coarse is not None:
        k1, k2 = coarse.shape[0], fine.shape[0]
        if k2 & (k2 - 1) or centroids.shape[0] != k1 * k2:
            raise ValueError(f"factored codec: k_fine {k2} must be a power "
                             f"of two and K {centroids.shape[0]} == "
                             f"k_coarse * k_fine")


def maxsim_residual_torch(q: torch.Tensor, records: torch.Tensor,
                          cand: torch.Tensor, mask: torch.Tensor,
                          centroids: torch.Tensor,
                          bucket_weights: torch.Tensor, *, nbits: int,
                          coarse: Optional[torch.Tensor] = None,
                          fine: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain fused residual decompress + MaxSim (K6's semantics, port of
    maxsim_residual_pallas and its body _residual_maxsim_kernel): q
    (B, Lq, dim), records (N, RB) uint8, cand (B, C) rows, mask (N, Ld),
    centroids (K, dim) or the factors coarse (k1, dim) + fine (k2, dim),
    bucket_weights (2^nbits,) -> (B, C) float32:

        score(b, c) = sum_t max_l s(b, t, l),  candidate row n = cand[b, c]
        s = (cs[code] + sum_d w[bucket_d] q_d) * scale   if scale > 0
          = -9999                                         otherwise

    at the TPU kernel's precision: q rounded to bf16; cs the
    centroid_scores table (bf16), cs1[hi] + cs2[lo] summed in float32 for
    a factored codec; bucket weights rounded to bf16; sums in float32;
    scale = the record's bf16 scale x mask."""
    _check_codec(centroids, coarse, fine)
    b = q.shape[0]
    ld = mask.shape[1]
    qb = q.to(torch.bfloat16).float()
    cs = centroid_scores(q, centroids, coarse, fine).float()  # (B, rows, Lq)
    w = bucket_weights.to(torch.bfloat16).float()
    out = torch.empty(cand.shape, dtype=torch.float32, device=q.device)
    for lo in range(0, b, _GROUP):
        ci = cand[lo:lo + _GROUP].long()
        codes, scl, packed = split_records(records[ci], ld)
        codes = codes.long()
        eff = (scl * mask[ci].float())[..., None]           # (g, C, Ld, 1)
        resid = torch.einsum("gcld,gqd->gclq",
                             w[unpack_bits(packed, nbits).long()],
                             qb[lo:lo + _GROUP])
        csg = cs[lo:lo + _GROUP]
        row = torch.arange(csg.shape[0], device=q.device)[:, None, None]
        if coarse is None:
            cterm = csg[row, codes]
        else:
            k1, k2 = coarse.shape[0], fine.shape[0]
            cterm = csg[row, codes // k2] + csg[row, k1 + codes % k2]
        s = torch.where(eff > 0, (cterm + resid) * eff, NEG_INF)
        out[lo:lo + _GROUP] = s.amax(dim=2).sum(dim=-1)
    return out


_MAX_CANDS = 64                # candidates per K6 block, most


def residual_plan(b: int, c: int, sm_count: int = 132) -> int:
    """Candidates per run of K6 (csrc/residual_maxsim.cu), a run being one
    warpgroup's share: run i scores query i // splits, candidates
    (i % splits) * cands .. + cands - 1 (fewer in the last), splits =
    ceil(C / cands); a block holds two consecutive runs of one query where
    shared memory allows. Each query's candidates go to about
    4 * sm_count / B runs, so every SM gets about four (a run's chunks go
    one after another), but no more than ceil(C / 8) (each run stages the
    query once), and a run holds at most 64."""
    want = max(1, -(-4 * sm_count // max(b, 1)))
    splits = max(1, min(want, -(-c // 8)))
    return max(1, min(_MAX_CANDS, -(-c // splits)))


def maxsim_residual(q: torch.Tensor, records: torch.Tensor,
                    cand: torch.Tensor, mask: torch.Tensor,
                    centroids: torch.Tensor, bucket_weights: torch.Tensor,
                    *, nbits: int, coarse: Optional[torch.Tensor] = None,
                    fine: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused residual decompress + MaxSim over per-query candidates (port
    of maxsim_residual_pallas): see maxsim_residual_torch for the
    semantics. CUDA tensors launch csrc/residual_maxsim.cu (K6) on the
    current stream, counted in ``maxsim_residual.launches``: the kernel
    reads each candidate's record and mask row by id (no gathered copy),
    multiplies the decoded residuals on the tensor cores and looks
    centroid scores up by code in shared memory. The table (rows x Lq
    bf16; rows = K flat, k1 + k2 factored) must fit there beside the
    buffers, about 160 KB at Lq <= 64 (a flat codec of 1,024 centroids at
    Lq = 64 fits); a larger one is refused. Any C works (no TPU tile
    rule). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return maxsim_residual_torch(q, records, cand, mask, centroids,
                                     bucket_weights, nbits=nbits,
                                     coarse=coarse, fine=fine)
    if q.device.type != "cuda":
        raise ValueError(f"maxsim_residual: unsupported device {q.device}")
    from .maxsim import _check_cuda
    _check_codec(centroids, coarse, fine)
    if nbits not in (2, 4, 8):
        raise ValueError(f"maxsim_residual: nbits must be 2, 4 or 8; got "
                         f"{nbits}")
    if q.dim() != 3 or records.dim() != 2 or cand.dim() != 2 \
            or mask.dim() != 2 or cand.shape[0] != q.shape[0]:
        raise ValueError(f"maxsim_residual: expected q (B, Lq, dim), records "
                         f"(N, RB), cand (B, C), mask (N, Ld); got "
                         f"{tuple(q.shape)}, {tuple(records.shape)}, "
                         f"{tuple(cand.shape)}, {tuple(mask.shape)}")
    b, lq, dim = q.shape
    n, ld = mask.shape
    c = cand.shape[1]
    if records.shape[0] != n \
            or records.shape[1] != record_bytes(ld, dim, nbits) \
            or centroids.shape[1] != dim:
        raise ValueError(f"maxsim_residual: records {tuple(records.shape)} "
                         f"do not hold {n} docs of {ld} tokens at dim {dim}, "
                         f"nbits {nbits}")
    if not 0 < lq <= 128 or dim % 8 or dim > 128 or ld == 0:
        raise ValueError(f"maxsim_residual: the kernel needs 0 < Lq <= 128, "
                         f"Ld > 0, dim % 8 == 0 and dim <= 128; got Lq={lq}, "
                         f"Ld={ld}, dim={dim}")
    if records.dtype != torch.uint8 or mask.dtype != torch.int8:
        raise TypeError("maxsim_residual: records must be uint8 and mask "
                        "int8")
    qb = q.to(torch.bfloat16).contiguous()
    cs = centroid_scores(q, centroids, coarse, fine).contiguous()
    w = bucket_weights.to(torch.bfloat16).float().contiguous()
    cand32 = cand.to(torch.int32).contiguous()
    _check_cuda("maxsim_residual", q=qb, cs=cs, records=records,
                cand=cand32, mask=mask, weights=w)
    k1 = coarse.shape[0] if coarse is not None else 0
    k2 = fine.shape[0] if fine is not None else 0
    return launch_residual_kernel(qb, cs, records, cand32, mask, w,
                                  nbits=nbits, k1=k1, k2=k2)


def launch_residual_kernel(qb, cs, records, cand32, mask, w, *, nbits: int,
                           k1: int, k2: int) -> torch.Tensor:
    """K6's launch alone, on the inputs maxsim_residual prepares and checks
    (q in bf16, the centroid-score table, cand int32, the bf16 bucket
    weights as float32; k1 = k2 = 0 for a flat codec): (B, C) float32,
    counted in ``maxsim_residual.launches``. Timing this call times the
    kernel without the wrapper's table and casts."""
    from .maxsim import _launch, _sm_count
    b, lq, dim = qb.shape
    n, ld = mask.shape
    c = cand32.shape[1]
    out = torch.empty((b, c), dtype=torch.float32, device=qb.device)
    cands = residual_plan(b, c, _sm_count(qb.device.index or 0))
    _launch("ravqa_residual_maxsim", "ravqa_residual_maxsim", qb.device,
            qb.data_ptr(), cs.data_ptr(), records.data_ptr(),
            cand32.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, lq, c, n, ld, dim, nbits, cs.shape[1], k1, k2, cands)
    maxsim_residual.launches += 1
    return out


maxsim_residual.launches = 0
