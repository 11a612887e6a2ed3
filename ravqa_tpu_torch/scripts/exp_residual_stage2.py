"""Residual fine-stage (stage 2) experiment on the card.

Port of scripts/exp_residual_stage2.py: it takes apart the cost of the
residual codec's fine stage (decompress + score of each query's gathered
candidates) and races candidate implementations at the shape of the 1M
residual search: C = 256 and 1,024 candidates x Ld = 64 tokens x dim 128,
K = 8,192 centroids, nbits 2, B = 32 queries x Lq = 32 tokens, top-10.
The index is synthetic (values do not matter for the times), made on the
device from ``--seed``:

  round 1  gathers (the candidate gathers alone), decompress (gathers +
           decompress), baseline (the frozen round-2 fine stage: gathers +
           per-query decompress + einsum), cqsplit (centroid scores
           cq = centroids @ q^T once per batch, gathered by code, plus the
           residual term), pallas (X1: cqsplit's inputs into the fused LUT
           + MaxSim kernel, ops.stage2.fused_lut_maxsim)
  round 2  batched_pallas (X2: batched decompress into the candidate MaxSim
           kernel, ops.stage2.candidate_maxsim)
  round 3  one packed-record gather instead of four: record_gather,
           record_baseline, record_perq_pallas (X3: the candidate kernel
           once per query)
  round 4  query-grouped fine stage, g = 4, 8, 32 with float32 scores and
           g = 4 with bf16 scores
  round 5  fully batched einsum over separate gathers; grouped32 over
           records at the first C
  round 6  grouped32 over records at the last C, float32 and bf16 scores
  round 7  at N = 1,000,448 docs of packed records (about 2.3 GB on the
           card): the record gather, records batched, records per query
  round 8  as round 7 with candidates computed in the program (top-C of a
           dummy coarse score) instead of given

The names keep the script's: "pallas" names the variant whose TPU version
was a Pallas kernel, here a hand-written CUDA kernel. Each variant is timed
over ``--iters`` (24) runs after a warm-up, with CUDA events on the card,
and prints ``name: X ms/batch (Y QPS)``; each round ends with the script's
``... max rel err:`` lines, to which the port adds each kernel route's
``...-vs-plain max abs err:`` against the same variant run by the kernel's
plain version on the same inputs. A kernel that fails ends the run (the
script printed FAILED and went on).

    python -m ravqa_tpu_torch.scripts.exp_residual_stage2 \\
        [--rounds 1,2,...,8] [--n-big 1000448] [--iters 24] [--seed 0] \\
        [--device cuda]

``--rounds`` replaces the script's EXP_ROUND1 .. EXP_ROUND8 switches (it
ran round n when EXP_ROUNDn=1; the default here is every round).
``--n-big`` replaces EXP_N, the table size of round 7, and here sets round
8's too (the script fixed it at 1,000,448, the default). The script's
module constants are the arguments of ``run``. TF32 is turned off, so the
float32 variants (cqsplit, X1) multiply in full float32. The device is the
GPU unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch

from ..ops import residual
from ..ops.quant import NEG_INF
from ..ops.residual import decompress, pack_records, unpack_bits
from ..ops.stage2 import (candidate_maxsim, candidate_maxsim_torch,
                          fused_lut_maxsim, fused_lut_maxsim_torch)

K = 10
ROUNDS = (1, 2, 3, 4, 5, 6, 7, 8)
WEIGHTS_2BIT = (-0.05, -0.01, 0.01, 0.05)


def _nbits(packed: torch.Tensor, dim: int) -> int:
    return 8 * packed.shape[-1] // dim


def _gather(cand, codes, resid, scales, mask):
    """The four separate candidate gathers: codes int32, residual bytes,
    mask and scales (stored type) as (B, C, ...)."""
    return codes[cand].int(), resid[cand], mask[cand], scales[cand]


def _fine(tok, q, sg, mg):
    """MaxSim of decompressed candidates: tok (..., C, Ld, dim) bf16, q
    (..., Lq, dim) cast to tok's type, products summed in float32, times
    the scales sg (..., C, Ld), masked by mg -> (..., C) float32."""
    s = torch.einsum("...cld,...qd->...clq", tok.float(),
                     q.to(tok.dtype).float())
    s = s * sg.float()[..., None]
    s = s.masked_fill(~mg.bool()[..., None], NEG_INF)
    return s.amax(dim=-2).sum(dim=-1)


def _top(scores, k):
    return torch.topk(scores, k, dim=-1).values


def _cq_gathered(q, cg, cent):
    """Centroid scores cq = centroids @ q^T (B, K, Lq) in float32, once per
    batch, rows gathered by code -> (B, C, Ld, Lq)."""
    cq = torch.einsum("kd,bqd->bkq", cent.float(), q.float())
    rows = torch.arange(q.shape[0], device=q.device)[:, None, None]
    return cq[rows, cg.long()]


# ---- variants (each returns (B, k) top scores; fn(q, cand, ...)) ----------

def v_gathers(q, cand, codes, resid, scales, mask):
    cg, pg, mg, sg = _gather(cand, codes, resid, scales, mask)
    ints = cg.sum() + pg.int().sum() + mg.sum()
    return (ints.float() + sg.float().sum()).reshape(1, 1)


def v_baseline(q, cand, codes, resid, scales, mask, cent, weights, k=K):
    """The frozen round-2 production fine stage: separate gathers, then
    per query decompress + einsum + masked MaxSim + top-k."""
    nbits = _nbits(resid, cent.shape[1])
    cg, pg, mg, sg = _gather(cand, codes, resid, scales, mask)
    return torch.stack([
        _top(_fine(decompress(cg[i], pg[i], cent, weights, nbits), q[i],
                   sg[i], mg[i]), k) for i in range(q.shape[0])])


def v_cqsplit(q, cand, codes, resid, scales, mask, cent, weights, k=K):
    """score = cq[code] + (w[bits] . q): the centroid term from one matmul
    and one row gather, the residual term from bf16 weights."""
    nbits = _nbits(resid, cent.shape[1])
    cg, pg, mg, sg = _gather(cand, codes, resid, scales, mask)
    cqg = _cq_gathered(q, cg, cent)                    # (B, C, Ld, Lq)
    wr = weights[unpack_bits(pg, nbits).long()].to(torch.bfloat16)
    sr = torch.einsum("bcld,bqd->bclq", wr.float(),
                      q.to(torch.bfloat16).float())
    s = (cqg + sr) * sg.float()[..., None]
    s = s.masked_fill(~mg.bool()[..., None], NEG_INF)
    return _top(s.amax(dim=2).sum(dim=-1), k)


def v_pallas(q, cand, codes, resid, scales, mask, cent, weights, k=K,
             score=fused_lut_maxsim):
    """cqsplit's inputs, pre-gathered, into the fused LUT + MaxSim scorer
    (X1, float32 throughout); `score` is the kernel's wrapper or its plain
    version."""
    nbits = _nbits(resid, cent.shape[1])
    if nbits != 2:
        raise ValueError(f"v_pallas: the fused scorer is 2-bit; got nbits "
                         f"{nbits}")
    cg, pg, mg, sg = _gather(cand, codes, resid, scales, mask)
    cqg = _cq_gathered(q, cg, cent)
    bits = unpack_bits(pg, nbits)                      # (B, C, Ld, dim)
    sc = score(q.float(), cqg, bits, sg.float(), mg, weights.float())
    return _top(sc, k)


def v_decomp_only(q, cand, codes, resid, scales, mask, cent, weights):
    """Just the decompress (centroid gather + LUT), no scoring."""
    cg, pg, _, _ = _gather(cand, codes, resid, scales, mask)
    tok = decompress(cg, pg, cent, weights, _nbits(resid, cent.shape[1]))
    return tok.float().sum().reshape(1, 1)


def v_batched(q, cand, codes, resid, scales, mask, cent, weights, k=K,
              score=candidate_maxsim):
    """Batched decompress with the scales folded in (bf16), then the
    candidate MaxSim scorer (X2); `score` is the kernel's wrapper or its
    plain version."""
    cg, pg, mg, sg = _gather(cand, codes, resid, scales, mask)
    tok = decompress(cg, pg, cent, weights, _nbits(resid, cent.shape[1]))
    tok = tok * sg[..., None].to(tok.dtype)            # (B, C, Ld, dim) bf16
    return _top(score(q.to(torch.bfloat16), tok, mg), k)


def make_records(codes, scales, resid):
    """(N, Ld) int16 codes, (N, Ld) bf16 scales, (N, Ld, P) residual bytes
    -> (N, Ld * (4 + P)) uint8 records [codes | scales | residual bytes],
    the script's layout (ops.residual.pack_records, byte for byte)."""
    return pack_records(codes, scales, resid)


def split_records(rg, ld):
    """The script's own split: (..., RB) uint8 -> codes int32 (the int16
    bytes, sign-extended as its bitcast), scales float32, residual bytes
    (..., Ld, P). ops.residual.split_records reads the codes unsigned."""
    lead = tuple(rg.shape[:-1])
    cg = rg[..., :ld * 2].contiguous().view(torch.int16).to(torch.int32)
    sg = rg[..., ld * 2:ld * 4].contiguous().view(torch.bfloat16).float()
    return cg, sg, rg[..., ld * 4:].reshape(lead + (ld, -1))


def v_record_gather(q, cand, records, ld):
    cg, sg, pg = split_records(records[cand], ld)
    return (cg.sum().float() + sg.sum() + pg.int().sum().float()).reshape(
        1, 1)


def v_record_baseline(q, cand, records, mask, cent, weights, k=K):
    """One record gather + the baseline's per-query decompress/score."""
    ld = mask.shape[1]
    cg, sg, pg = split_records(records[cand], ld)
    mg = mask[cand]
    nbits = _nbits(pg, cent.shape[1])
    return torch.stack([
        _top(_fine(decompress(cg[i], pg[i], cent, weights, nbits), q[i],
                   sg[i], mg[i]), k) for i in range(q.shape[0])])


def v_record_perq(q, cand, records, mask, cent, weights, k=K,
                  score=candidate_maxsim):
    """One record gather, then per query: decompress with the scales folded
    in (bf16) and the candidate MaxSim scorer on that query alone (X3: the
    kernel launched once per query, B = 1)."""
    ld = mask.shape[1]
    cg, sg, pg = split_records(records[cand], ld)
    mg = mask[cand]
    nbits = _nbits(pg, cent.shape[1])
    out = []
    for i in range(q.shape[0]):
        tok = decompress(cg[i], pg[i], cent, weights, nbits)
        tok = tok * sg[i][..., None].to(tok.dtype)     # (C, Ld, dim) bf16
        sc = score(q[i:i + 1].to(torch.bfloat16), tok[None], mg[i:i + 1])
        out.append(_top(sc[0], k))
    return torch.stack(out)


def v_grouped(q, cand, records, mask, cent, weights, g=4, sdtype=None, k=K):
    """Query-grouped fine stage: g queries per step; sdtype bf16 rounds the
    (g, C, Ld, Lq) scores to bf16 before the scale, mask and max (the
    script's preferred_element_type), float32 otherwise."""
    ld = mask.shape[1]
    cg, sg, pg = split_records(records[cand], ld)
    mg = mask[cand]
    nbits = _nbits(pg, cent.shape[1])
    out = []
    for lo in range(0, q.shape[0], g):
        tok = decompress(cg[lo:lo + g], pg[lo:lo + g], cent, weights, nbits)
        s = torch.einsum("gcld,gqd->gclq", tok.float(),
                         q[lo:lo + g].to(tok.dtype).float())
        if sdtype is not None:
            s = s.to(sdtype)
        s = s * sg[lo:lo + g][..., None].to(s.dtype)
        s = s.masked_fill(~mg[lo:lo + g].bool()[..., None], NEG_INF)
        out.append(_top(s.amax(dim=2).float().sum(dim=-1), k))
    return torch.cat(out)


def v_batched_einsum(q, cand, codes, resid, scales, mask, cent, weights,
                     k=K):
    """Fully batched decompress + einsum over the separate gathers."""
    cg, pg, mg, sg = _gather(cand, codes, resid, scales, mask)
    tok = decompress(cg, pg, cent, weights, _nbits(resid, cent.shape[1]))
    return _top(_fine(tok, q, sg, mg), k)


def v_records_batched(q, cand, records, mask, cent, weights, k=K):
    """Fully batched over one record gather (ops.residual.split_records)."""
    cg, sg, pg = residual.split_records(records[cand], mask.shape[1])
    tok = decompress(cg, pg, cent, weights, _nbits(pg, cent.shape[1]))
    return _top(_fine(tok, q, sg, mask[cand]), k)


def v_records_perq(q, cand, records, mask, cent, weights, k=K):
    """Per query over one record gather (ops.residual.split_records)."""
    cg, sg, pg = residual.split_records(records[cand], mask.shape[1])
    mg = mask[cand]
    nbits = _nbits(pg, cent.shape[1])
    return torch.stack([
        _top(_fine(decompress(cg[i], pg[i], cent, weights, nbits), q[i],
                   sg[i], mg[i]), k) for i in range(q.shape[0])])


def with_computed_cand(stage2):
    """Round 8: `stage2` over candidates computed in the program, the
    top-C of a dummy coarse score (each doc key . the query's summed
    tokens, bf16 values, float32 sums)."""
    def fn(q, records, mask, cent, weights, dkeys, c, k=K):
        qsum = q.to(torch.bfloat16).sum(dim=1)            # (B, dim) bf16
        approx = torch.einsum("nd,bd->bn", dkeys.float(), qsum.float())
        cand = torch.topk(approx, c, dim=1).indices
        return stage2(q, cand, records, mask, cent, weights, k=k)
    return fn


def records_gather_sum(q, cand, records):
    """Round 7's gather alone: one record gather, summed."""
    return records[cand].int().sum().reshape(1, 1)


# ---- the rounds -----------------------------------------------------------

def _normalize(x):
    return x / x.norm(dim=-1, keepdim=True)


def _rel_err(a, b):
    return float(((a - b).abs() / (a.abs() + 1e-6)).max())


class _Experiment:
    """Times variants and keeps what the run measured: ms per batch by
    name, the rel-err and plain-twin lines, and per variant the calls made
    and the stage-2 kernel launches they made."""

    def __init__(self, q, iters, device):
        self.q, self.iters, self.device = q, iters, torch.device(device)
        self.times, self.rel_err, self.twin_err = {}, {}, {}
        self.calls = collections.Counter()
        self.launches = collections.Counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, fn, *args, **kw):
        before = fused_lut_maxsim.launches + candidate_maxsim.launches
        out = fn(self.q, *args, **kw)
        self.calls[fn.__name__] += 1
        self.launches[fn.__name__] += (fused_lut_maxsim.launches
                                       + candidate_maxsim.launches - before)
        return out

    def timeit(self, name, fn, *args, **kw):
        self.call(fn, *args, **kw)                       # warm-up
        self._sync()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.iters):
                self.call(fn, *args, **kw)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / self.iters
        else:
            t0 = time.perf_counter()
            for _ in range(self.iters):
                self.call(fn, *args, **kw)
            ms = (time.perf_counter() - t0) * 1e3 / self.iters
        self.times[name] = ms
        print(f"{name}: {ms:.3f} ms/batch ({self.q.shape[0] * 1e3 / ms:.0f} "
              f"QPS)", flush=True)
        return ms

    def rel(self, name, want, got):
        self.rel_err[name] = _rel_err(want, got)
        print(f"{name} max rel err: {self.rel_err[name]}", flush=True)

    def twin(self, kernel, name, got, want):
        err = float((got - want).abs().max())
        self.twin_err[kernel] = max(self.twin_err.get(kernel, 0.0), err)
        print(f"{name}-vs-plain max abs err: {err}", flush=True)


def build_index(g, n, ld, dim, n_cent, nbits, b, lq, device):
    """The script's synthetic compressed index: random codes (int16),
    residual bytes and bf16 scales near 1, unit centroids, unit queries,
    the 2-bit codec's weights (evenly spaced over the same range at other
    nbits). Returns (codes, resid, scales, cent, q, weights)."""
    codes = torch.randint(n_cent, (n, ld), generator=g, device=device).to(
        torch.int16)
    resid = torch.randint(256, (n, ld, dim * nbits // 8), generator=g,
                          device=device, dtype=torch.uint8)
    scales = (1.0 + 0.01 * torch.randn(n, ld, generator=g, device=device)
              ).to(torch.bfloat16)
    cent = _normalize(torch.randn(n_cent, dim, generator=g, device=device))
    q = _normalize(torch.randn(b, lq, dim, generator=g, device=device))
    weights = (torch.tensor(WEIGHTS_2BIT, device=device) if nbits == 2 else
               torch.linspace(-0.05, 0.05, 2 ** nbits, device=device))
    return codes, resid, scales, cent, q, weights


def build_records(g, n, ld, dim, n_cent, nbits, device):
    """Rounds 7-8's table: n docs of packed records, made on the device."""
    codes = torch.randint(n_cent, (n, ld), generator=g, device=device)
    resid = torch.randint(256, (n, ld, dim * nbits // 8), generator=g,
                          device=device, dtype=torch.uint8)
    scales = 1.0 + 0.01 * torch.randn(n, ld, generator=g, device=device)
    return pack_records(codes, scales, resid)


def run(rounds=ROUNDS, n=200_064, ld=64, dim=128, b=32, lq=32, k=K,
        n_cent=8192, nbits=2, cands=(256, 1024), n_big=1_000_448, iters=24,
        seed=0, device="cuda") -> dict:
    """Run the experiment's `rounds` at the given widths (the defaults are
    the script's). Returns {"times": {name: ms per batch}, "rel_err":
    {line: max rel err}, "twin_err": {"X1"|"X2"|"X3": max abs error of the
    kernel route against its plain version}, "launches": {kernel: stage-2
    kernel launches made by its route}, "expected_launches": {kernel:
    launches its route's calls should make}}."""
    rounds = set(rounds)
    g = torch.Generator(device=device).manual_seed(seed)
    codes, resid, scales, cent, q, weights = build_index(
        g, n, ld, dim, n_cent, nbits, b, lq, device)
    mask = torch.ones((n, ld), dtype=torch.int8, device=device)
    ex = _Experiment(q, iters, device)

    def make_cand(c, n_docs=n):
        return torch.randint(n_docs, (b, c), generator=g, device=device)

    full = (codes, resid, scales, mask, cent, weights)
    idx = (codes, resid, scales, mask)
    c0, c1 = cands[0], cands[-1]
    if 1 in rounds:
        for c in cands:
            cand = make_cand(c)
            print(f"--- C={c} ---", flush=True)
            ex.timeit(f"gathers_C{c}", v_gathers, cand, *idx)
            ex.timeit(f"decompress_C{c}", v_decomp_only, cand, *full)
            ex.timeit(f"baseline_C{c}", v_baseline, cand, *full, k=k)
            ex.timeit(f"cqsplit_C{c}", v_cqsplit, cand, *full, k=k)
            ex.timeit(f"pallas_C{c}", v_pallas, cand, *full, k=k)
        cand = make_cand(c0)
        sb = ex.call(v_baseline, cand, *full, k=k)
        ex.rel("baseline-vs-cqsplit", sb, ex.call(v_cqsplit, cand, *full,
                                                  k=k))
        sp = ex.call(v_pallas, cand, *full, k=k)
        ex.rel("baseline-vs-pallas", sb, sp)
        ex.twin("X1", "pallas", sp, v_pallas(q, cand, *full, k=k,
                                             score=fused_lut_maxsim_torch))
    if 2 in rounds:
        for c in cands:
            ex.timeit(f"batched_pallas_C{c}", v_batched, make_cand(c), *full,
                      k=k)
        cand = make_cand(c0)
        sb = ex.call(v_baseline, cand, *full, k=k)
        sv = ex.call(v_batched, cand, *full, k=k)
        ex.rel("baseline-vs-batched", sb, sv)
        ex.twin("X2", "batched", sv, v_batched(q, cand, *full, k=k,
                                               score=candidate_maxsim_torch))
    records = None
    if rounds & {3, 4, 5, 6}:
        records = make_records(codes, scales, resid)
        print(f"records: {tuple(records.shape)} "
              f"({records.numel() / 2 ** 30:.2f} GiB)", flush=True)
    rec = (mask, cent, weights)
    if 3 in rounds:
        for c in cands:
            cand = make_cand(c)
            ex.timeit(f"record_gather_C{c}", v_record_gather, cand, records,
                      ld)
            ex.timeit(f"record_baseline_C{c}", v_record_baseline, cand,
                      records, *rec, k=k)
            ex.timeit(f"record_perq_pallas_C{c}", v_record_perq, cand,
                      records, *rec, k=k)
        cand = make_cand(c0)
        sb = ex.call(v_baseline, cand, *full, k=k)
        ex.rel("baseline-vs-record", sb, ex.call(v_record_baseline, cand,
                                                 records, *rec, k=k))
        s2 = ex.call(v_record_perq, cand, records, *rec, k=k)
        ex.rel("baseline-vs-perq-pallas", sb, s2)
        ex.twin("X3", "perq-pallas", s2, v_record_perq(
            q, cand, records, *rec, k=k, score=candidate_maxsim_torch))
    if 4 in rounds:
        for c in cands:
            cand = make_cand(c)
            for grp in (4, 8, 32):
                ex.timeit(f"grouped{grp}_f32_C{c}", v_grouped, cand, records,
                          *rec, g=grp, k=k)
            ex.timeit(f"grouped4_bf16_C{c}", v_grouped, cand, records, *rec,
                      g=4, sdtype=torch.bfloat16, k=k)
        cand = make_cand(c0)
        sb = ex.call(v_baseline, cand, *full, k=k)
        ex.rel("baseline-vs-grouped4", sb, ex.call(v_grouped, cand, records,
                                                   *rec, g=4, k=k))
        ex.rel("baseline-vs-grouped4-bf16", sb, ex.call(
            v_grouped, cand, records, *rec, g=4, sdtype=torch.bfloat16, k=k))
    if 5 in rounds:
        for c in cands:
            ex.timeit(f"batched_einsum_sepgather_C{c}", v_batched_einsum,
                      make_cand(c), *full, k=k)
        cand = make_cand(c0)
        ex.timeit(f"grouped32_records_C{c0}", v_grouped, cand, records, *rec,
                  g=32, k=k)
        sb = ex.call(v_baseline, cand, *full, k=k)
        ex.rel("baseline-vs-batched-einsum", sb, ex.call(
            v_batched_einsum, cand, *full, k=k))
    if 6 in rounds:
        cand = make_cand(c1)
        ex.timeit(f"grouped32_records_C{c1}", v_grouped, cand, records, *rec,
                  g=32, k=k)
        ex.timeit(f"grouped32_records_bf16_C{c1}", v_grouped, cand, records,
                  *rec, g=32, sdtype=torch.bfloat16, k=k)
        cand = make_cand(c0)
        sb = ex.call(v_baseline, cand, *full, k=k)
        ex.rel("baseline-vs-g32-bf16", sb, ex.call(
            v_grouped, cand, records, *rec, g=32, sdtype=torch.bfloat16,
            k=k))
    del codes, resid, scales, mask, full, idx, rec, records
    if rounds & {7, 8}:
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        print(f"rebuilding at N={n_big}", flush=True)
        records = build_records(g, n_big, ld, dim, n_cent, nbits, device)
        mask = torch.ones((n_big, ld), dtype=torch.int8, device=device)
        print(f"records {records.numel() / 2 ** 30:.2f} GiB", flush=True)
        rec = (mask, cent, weights)
        if 7 in rounds:
            for c in cands:
                cand = make_cand(c, n_big)
                ex.timeit(f"1M_records_gather_C{c}", records_gather_sum,
                          cand, records)
                ex.timeit(f"1M_records_batched_C{c}", v_records_batched,
                          cand, records, *rec, k=k)
                ex.timeit(f"1M_records_perq_C{c}", v_records_perq, cand,
                          records, *rec, k=k)
        if 8 in rounds:
            dkeys = torch.randn(n_big, dim, generator=g, device=device).to(
                torch.bfloat16)
            for c in cands:
                for name, s2 in (("batched", v_records_batched),
                                 ("perq", v_records_perq)):
                    fn = with_computed_cand(s2)
                    fn.__name__ = f"computedcand_{name}"
                    ex.timeit(f"computedcand_{name}_C{c}", fn, records, *rec,
                              dkeys, c, k=k)
    kernels = {"X1": "v_pallas", "X2": "v_batched", "X3": "v_record_perq"}
    per_call = {"X1": 1, "X2": 1, "X3": b}
    return {"times": ex.times, "rel_err": ex.rel_err,
            "twin_err": ex.twin_err,
            "launches": {x: ex.launches[v] for x, v in kernels.items()},
            "expected_launches": {x: ex.calls[v] * per_call[x]
                                  for x, v in kernels.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("exp_residual_stage2")
    p.add_argument("--rounds", default=",".join(map(str, ROUNDS)),
                   help="comma-separated rounds to run (replaces "
                        "EXP_ROUND1..EXP_ROUND8); default every round")
    p.add_argument("--n-big", type=int, default=1_000_448,
                   help="docs of rounds 7-8's record table (replaces EXP_N)")
    p.add_argument("--iters", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA GPU visible; pass --device cpu to run "
                             "the plain versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    report = run(rounds=[int(r) for r in args.rounds.split(",") if r],
                 n_big=args.n_big, iters=args.iters, seed=args.seed,
                 device=args.device)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
